"""The port's counterparts of the JAX system's runnable scripts:
``scripts/bench_sweep.py``, ``scripts/profile_stages.py``,
``scripts/host_ceiling.py``, ``scripts/serve_latency_ab.py``,
``scripts/profile_connectivity.py`` and ``scripts/migrate_checkpoints.py``,
and the quality and fidelity scripts ``scripts/fidelity_gate.py``,
``scripts/quality_anchor.py``, ``scripts/fusion_quality_anchor.py``,
``scripts/slic_node_crossval.py`` and ``scripts/train_rg_real.py``, which
write under one output root (``--out``, default ``artifacts/torch_port/``),
and the full-chain demo ``scripts/full_pipeline_demo.sh``
(``full_pipeline_demo``, under ``artifacts/torch_port/demo``); each runs as
``python -m camouflage_multimodal_tpu_torch.scripts.<name>``."""
