"""Spans and device time, port of ``camouflage_multimodal_tpu/core/profiling.py``.

:func:`annotate` is the program's one span helper: a ``torch.profiler``
range whose name starts with ``cmt::``. The spans:

- the stages of the graph build and the models (``pipeline.py``):
  ``cmt::slic``, ``cmt::connectivity``, ``cmt::canny``,
  ``cmt::region_features``, ``cmt::rag``, ``cmt::labels``, ``cmt::gnn``,
  ``cmt::fusion``;
- each host synchronisation of the graph build, around the blocking call
  alone: the fixed points' tests, ``cmt::sync.canny`` (the plain version of
  Canny's hysteresis, ``ops/canny.py``, which CPU tensors take: on the card
  one kernel runs that fixed point with no host synchronisation, so the
  span never opens there), ``cmt::sync.components`` and ``cmt::sync.merge``
  (connectivity's components and merge rounds, ``ops/connectivity.py``),
  whose counts are the fixed points' round counts;
- the stage graphs of the graph build on the card (``core/graphs.py``):
  ``cmt::graph.capture`` around each capture and ``cmt::graph.replay``
  around each replay, inside the stage's range;
- the directory walk's stages and waits (``core/stages.py``):
  ``cmt::walk.decode``, ``cmt::walk.wait_input``, ``cmt::walk.wait_output``.

With no profiler running a span costs one flag test and opens nothing.
The ``record_function`` call it spares costs 9–11 µs on the host of an
H100 80GB HBM3 machine (PyTorch 2.11, Python 3.12); at about 60 spans a
batch of 16 images at 352², the spans measured about 1 % of the batch's
time there. Under ``torch.profiler`` a span lies on the clock of the
card's trace, and ``is_card_event`` keeps its mirror on the card's
timeline out of device time. The JAX package's ``StageTimer`` and ``trace``
have no counterpart: ``torch.profiler`` is the port's one recorder.

:func:`device_profile` is the one definition of "device busy" that the
port's measurement scripts read: the union of the card's kernel and copy
spans under ``torch.profiler`` (with each kernel's device time beside it);
:func:`device_busy_ms` gives the first part alone.
"""

from __future__ import annotations

import contextlib
from collections import defaultdict
from typing import Callable, ContextManager, Dict, Iterable, Optional, Tuple, Union

import torch

_NO_SPAN = contextlib.nullcontext()


def annotate(name: str) -> ContextManager:
    """The program's one span helper: a ``torch.profiler.record_function``
    range named ``name``, which starts with ``cmt::``, on the clock of the
    card's trace, so the card's kernels can be attributed to the range
    whose launch calls it holds. With no profiler running it opens nothing:
    torch's process-wide flag of a running profiler, which every thread
    reads (the walk's workers under ``profile_all_threads`` too), spares
    the ``record_function`` call (module docstring)."""
    if not torch.autograd.profiler._is_profiler_enabled:
        return _NO_SPAN
    return torch.profiler.record_function(name)


def is_card_event(ev) -> bool:
    """A kernel or a copy of a ``torch.profiler`` trace: not a host range
    mirrored onto the card's timeline (the ``cmt::`` spans of
    :func:`annotate`, user annotations, the optimizer's step annotation)."""
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
