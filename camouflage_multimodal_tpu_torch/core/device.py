"""Device selection for the port's entry points.

Every entry point resolves its device here: ``"cuda"`` (the default
everywhere) raises when no card is visible — nothing falls back to the CPU —
and ``"cpu"`` runs the plain PyTorch versions, which is what the test suite
asks for. When a process group is up (:mod:`parallel.distributed`),
``"cuda"`` is the rank's own card, the one ``initialize`` pinned.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device='cuda' was requested but torch.cuda.is_available() is "
                "False; pass device='cpu' to run the plain PyTorch path")
        # Full float32 for matmuls and cuDNN: every JAX reference number is
        # float32 at precision=HIGHEST, and TF32 keeps ~3 decimal digits.
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        if dev.index is None and dist.is_initialized():
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}: use 'cuda' or 'cpu'")
    return dev
