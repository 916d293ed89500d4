"""Timing and tracing, port of ``camouflage_multimodal_tpu/core/profiling.py``.

:class:`StageTimer` keeps the summary JSON of the JAX package (the
reference's hand-rolled wall-clock timing of
``extract_rg_embeddings.py:328-336``). :func:`trace` records a
``torch.profiler`` trace — host activity always, the card's kernels too
when CUDA is in use — and writes it as a Chrome trace into ``logdir``;
:func:`annotate` names a region of that trace. :func:`device_profile` is
the one definition of "device busy" that the port's measurement scripts
read: the union of the card's kernel and copy spans under ``torch.profiler``
(with each kernel's device time beside it); :func:`device_busy_ms` gives the
first part alone.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from collections import defaultdict
from typing import Callable, Dict, Iterable, Iterator, Optional, Tuple, Union

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


def is_card_event(ev) -> bool:
    """A kernel or a copy of a ``torch.profiler`` trace: not a host range
    mirrored onto the card's timeline (the ``cmt::`` stages of
    ``pipeline.py``, user annotations, the optimizer's step annotation)."""
    from torch.autograd import DeviceType

    return (ev.device_type == DeviceType.CUDA and not ev.name.startswith("cmt::")
            and not getattr(ev, "is_user_annotation", False)
            and not ev.name.startswith("Optimizer."))


def busy_us(spans: Iterable[Tuple[float, float]], lo: float = float("-inf"),
            hi: float = float("inf")) -> float:
    """Length of the union of sorted (start, end) intervals, clipped to
    [lo, hi]: overlapping device activity counts once."""
    total, cur_start, cur_end = 0.0, None, None
    for start, end in spans:
        start, end = max(start, lo), min(end, hi)
        if end <= start:
            continue
        if cur_end is None or start > cur_end:
            total += 0.0 if cur_end is None else cur_end - cur_start
            cur_start, cur_end = start, end
        else:
            cur_end = max(cur_end, end)
    return total + (0.0 if cur_end is None else cur_end - cur_start)


def device_profile(fn: Callable, calls: int
                   ) -> Optional[Tuple[float, Dict[str, float]]]:
    """(device-busy ms a call of ``fn()`` on the card — the union of its
    kernels' and copies' spans —, {kernel or copy name: device ms a call})
    over ``calls`` calls under ``torch.profiler``; None when three windows
    come back without a device record."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        events = [ev for ev in prof.events() if is_card_event(ev)]
        if events:
            by_name: Dict[str, float] = defaultdict(float)
            for ev in events:
                by_name[ev.name] += ev.time_range.elapsed_us() / 1e3 / calls
            spans = sorted((ev.time_range.start, ev.time_range.end) for ev in events)
            return busy_us(spans) / 1e3 / calls, dict(by_name)
    return None


def device_busy_ms(fn: Callable, calls: int) -> Union[float, str]:
    """Device-busy ms a call of ``fn()`` on the card (:func:`device_profile`;
    "not measured" when no window had a device record)."""
    prof = device_profile(fn, calls)
    return "not measured" if prof is None else prof[0]
