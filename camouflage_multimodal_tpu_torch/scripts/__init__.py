"""The port's counterparts of the JAX system's runnable scripts:
``scripts/bench_sweep.py``, ``scripts/profile_stages.py``,
``scripts/host_ceiling.py``, ``scripts/serve_latency_ab.py``,
``scripts/profile_connectivity.py`` and ``scripts/migrate_checkpoints.py``;
each runs as ``python -m camouflage_multimodal_tpu_torch.scripts.<name>``."""
