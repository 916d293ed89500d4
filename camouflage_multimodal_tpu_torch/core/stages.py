"""The four-stage software pipeline of the directory walks (extraction and
evaluation): decode ∥ upload ∥ compute ∥ download.

The JAX package runs the same stages in ``extract.py`` and
``api.evaluate_directory``. Decode (PIL) and the host → device copy each
take a worker thread of their own, the compute is enqueued on the caller's
thread, and the device → host copy of batch i runs on a third worker while
batch i + 1 is enqueued. The aim is a directory at the pace of its slowest
stage rather than the sum of all four; on an H100 80GB HBM3 (700 W) it
measured no faster than the same stages run in turn (``chip_smoke.py``'s
``workflow_overlap``; PERF.md §6).
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, Iterable, Sequence

import numpy as np
import torch


def pad_batch(images: Sequence[np.ndarray], batch_size: int) -> np.ndarray:
    """Stack ``images`` and pad with zero images up to ``batch_size``, so
    every batch of a directory has one shape."""
    batch = np.stack(images)
    if batch.shape[0] < batch_size:
        pad = np.zeros((batch_size - batch.shape[0],) + batch.shape[1:], batch.dtype)
        batch = np.concatenate([batch, pad])
    return batch


def upload(batch: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array on ``device``: on the card through pinned memory with a
    ``non_blocking`` copy on the current stream, which orders it before
    every kernel enqueued after it."""
    host = torch.from_numpy(np.ascontiguousarray(batch))
    if device.type == "cpu":
        return host
    return host.pin_memory().to(device, non_blocking=True)


def download(out: Dict[str, torch.Tensor], keys: Iterable[str]) -> Dict[str, np.ndarray]:
    """One ``.cpu()`` pass over the outputs a record needs."""
    return {k: out[k].cpu().numpy() for k in keys}


def run_overlapped(chunks: Sequence[Any], decode: Callable, upload_fn: Callable,
                   compute: Callable, download_fn: Callable, record: Callable) -> None:
    """For each chunk in order: ``decode(chunk)`` on one worker,
    ``upload_fn(decoded)`` on a second, ``compute(uploaded)`` on the
    caller's thread, ``download_fn(computed)`` on a third and
    ``record(downloaded)`` back on the caller's thread. Decode and upload
    run up to two chunks ahead; batch i's download is waited for only after
    batch i + 1 has been enqueued. ``compute`` may return None (nothing to
    download for that chunk)."""
    n = len(chunks)
    if not n:
        return
    with ThreadPoolExecutor(max_workers=1) as dec_ex, \
            ThreadPoolExecutor(max_workers=1) as up_ex, \
            ThreadPoolExecutor(max_workers=1) as down_ex:
        def staged(i):
            decoded = dec_ex.submit(decode, chunks[i])
            return up_ex.submit(lambda: upload_fn(decoded.result()))

        ahead = [staged(i) for i in range(min(2, n))]
        down = None
        for i in range(n):
            uploaded = ahead.pop(0).result()
            if i + 2 < n:
                ahead.append(staged(i + 2))
            out = compute(uploaded)
            if down is not None:
                record(down.result())
                down = None
            if out is not None:
                down = down_ex.submit(download_fn, out)
        if down is not None:
            record(down.result())
