from camouflage_multimodal_tpu_torch.core.config import load_config, default_config  # noqa: F401
