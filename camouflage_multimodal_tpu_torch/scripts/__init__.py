"""The port's measurement scripts, counterparts of the JAX system's
``scripts/bench_sweep.py``, ``scripts/profile_stages.py`` and
``scripts/host_ceiling.py``; each runs as
``python -m camouflage_multimodal_tpu_torch.scripts.<name>``."""
