"""Timing and tracing, port of ``camouflage_multimodal_tpu/core/profiling.py``.

:class:`StageTimer` keeps the summary JSON of the JAX package (the
reference's hand-rolled wall-clock timing of
``extract_rg_embeddings.py:328-336``). :func:`trace` records a
``torch.profiler`` trace — host activity always, the card's kernels too
when CUDA is in use — and writes it as a Chrome trace into ``logdir``;
:func:`annotate` names a region of that trace.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from collections import defaultdict
from typing import Dict, Iterator, Optional

import torch


class StageTimer:
    """Accumulates wall-clock per named stage; JSON-serializable summary."""

    def __init__(self) -> None:
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {
            name: {
                "total_seconds": self.totals[name],
                "count": self.counts[name],
                "avg_seconds": self.totals[name] / max(self.counts[name], 1),
            }
            for name in self.totals
        }

    def save(self, path: str) -> None:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.summary(), f, indent=2)


@contextlib.contextmanager
def trace(logdir: Optional[str]) -> Iterator[None]:
    """Profile the block into ``logdir/trace.json`` (a Chrome trace; no-op
    when logdir is None). CUDA activity is recorded when a card is in use."""
    if logdir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    os.makedirs(logdir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """Named region in the trace (``torch.profiler.record_function``)."""
    with torch.profiler.record_function(name):
        yield
