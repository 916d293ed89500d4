"""The traced window of a ``--trace 1`` run, read from ``torch.profiler``.

:class:`Trace` turns the profiler's raw events into what the per-layer
readers under ``metrics/`` need: the card's kernel and copy spans, the host
ranges by name (the program's ``cmt::`` stages, the benchmark's ``bench::``
spans, the optimizer's step), which host range launched each kernel (by the
runtime call that carries the kernel's correlation id), the union of device
activity and the window's breakdown. The union and the rule for what counts
as device activity are copied from the program's ``core/profiling.py``
(``busy_us``, ``is_card_event``): a range mirrored onto the card's timeline
is no device work.
"""

from __future__ import annotations

import contextlib
from collections import defaultdict
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import torch

# Ranges that the profiler mirrors onto the card's timeline but that launch
# nothing: the program's stage names, the benchmark's spans, the optimizer.
_MIRROR_PREFIXES = ("cmt::", "bench::", "Optimizer.", "ProfilerStep")
NAME_CHARS = 160     # a kernel's name in the breakdown, cut (template names run to thousands)
_LAUNCH_PREFIXES = ("cudaLaunch", "cuLaunch", "cudaMemcpy", "cudaMemset", "cuMemcpy",
                    "cuMemset", "cudaGraphLaunch")


def busy(spans: Iterable[Tuple[float, float]], lo: float = float("-inf"),
         hi: float = float("inf")) -> float:
    """Length of the union of (start, end) spans sorted by start, clipped to
    [lo, hi]: overlapping activity counts once."""
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


def _ns(ev, what: str) -> int:
    fn = getattr(ev, f"{what}_ns", None)
    if fn is not None:
        return int(fn())
    return int(getattr(ev, f"{what}_us")() * 1000)


class Trace:
    """The events of one profiled window, times in seconds from its start."""

    def __init__(self, events: Sequence, lo_ns: int, hi_ns: int) -> None:
        from torch.autograd import DeviceType

        self.window_s = (hi_ns - lo_ns) / 1e9
        self.gpu: List[Tuple[float, float, str, int, int]] = []   # start, end, name, corr, linked
        self.ranges: Dict[str, List[Tuple[float, float, int]]] = defaultdict(list)
        self.launch_at: Dict[int, Tuple[float, int]] = {}         # corr → (host time, thread)
        for ev in events:
            name = ev.name()
            start = (_ns(ev, "start") - lo_ns) / 1e9
            dur = _ns(ev, "duration") / 1e9
            if ev.device_type() == DeviceType.CUDA:
                user = getattr(ev, "is_user_annotation", lambda: False)()
                if user or name.startswith(_MIRROR_PREFIXES):
                    continue
                self.gpu.append((start, start + dur, name, int(ev.correlation_id()),
                                 int(ev.linked_correlation_id())))
            elif ev.device_type() == DeviceType.CPU:
                thread = int(ev.start_thread_id())
                if name.startswith(_LAUNCH_PREFIXES):
                    self.launch_at[int(ev.correlation_id())] = (start, thread)
                else:
                    self.ranges[name].append((start, start + dur, thread))
        self.gpu.sort()
        self.busy_s = busy(((s, e) for s, e, *_ in self.gpu), 0.0, self.window_s)

    def host_s(self, *names: str) -> float:
        """Seconds of the named host ranges that fall in the window."""
        return sum(min(e, self.window_s) - max(s, 0.0)
                   for n in names for s, e, _ in self.ranges.get(n, ())
                   if e > 0.0 and s < self.window_s)

    def count(self, name: str) -> int:
        return sum(1 for s, e, _ in self.ranges.get(name, ()) if e > 0.0 and s < self.window_s)

    def launched_in(self, name: str) -> List[Tuple[float, float, str]]:
        """The card's spans whose launch call was made inside a host range
        ``name`` (on the range's thread)."""
        spans = self.ranges.get(name, ())
        if not spans:
            return []
        by_thread: Dict[int, List[Tuple[float, float]]] = defaultdict(list)
        for s, e, t in spans:
            by_thread[t].append((s, e))
        out = []
        for s, e, kname, corr, linked in self.gpu:
            at = self.launch_at.get(corr) or self.launch_at.get(linked)
            if at is None:
                continue
            t_host, thread = at
            if any(a <= t_host <= b for a, b in by_thread.get(thread, ())):
                out.append((s, e, kname))
        return out

    def device_s(self, spans: Iterable[Tuple[float, float, str]]) -> float:
        return busy(sorted((s, e) for s, e, _ in spans), 0.0, self.window_s)

    def breakdown(self, top: int = 10) -> Dict[str, List[List]]:
        """The device operations that took most time, and the longest idle
        gaps labelled by the innermost ``cmt::`` or ``bench::`` range the
        host was in at the gap's middle."""
        by_name: Dict[str, float] = defaultdict(float)
        for s, e, name, *_ in self.gpu:
            by_name[name] += e - s
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        gaps, last = [], 0.0
        for s, e, *_ in self.gpu:
            if s > last:
                gaps.append((last, min(s, self.window_s)))
            last = max(last, e)
        if last < self.window_s:
            gaps.append((last, self.window_s))
        labelled = [(b - a, a, b) for a, b in gaps if b > a]
        labelled.sort(reverse=True)
        named = [n for n in self.ranges if n.startswith(("cmt::", "bench::"))]
        idle = []
        for length, a, b in labelled[:top]:
            mid = (a + b) / 2
            inner = min(((e - s, n) for n in named for s, e, _ in self.ranges[n] if s <= mid <= e),
                        default=(0.0, "outside_ranges"))
            idle.append([inner[1], length])
        return {"device_ops": [[n[:NAME_CHARS], v] for n, v in ops], "idle_gaps": idle}


class Tracer:
    """``with tracer.window():`` profiles the block when tracing is on; the
    parsed :class:`Trace` is ``tracer.trace`` afterwards."""

    def __init__(self, on: bool) -> None:
        self.on = on
        self.trace: Optional[Trace] = None

    @contextlib.contextmanager
    def window(self):
        if not self.on:
            yield
            return
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        try:       # host ranges of every thread: the batcher and the walk's workers
            config = torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
            prof = profile(activities=activities, experimental_config=config)
        except (AttributeError, TypeError):
            prof = profile(activities=activities)
        prof.start()
        try:
            with torch.profiler.record_function("bench::window"):
                yield
                if torch.cuda.is_available():
                    torch.cuda.synchronize()
        finally:
            prof.stop()
        events = prof.profiler.kineto_results.events()
        marks = [ev for ev in events if ev.name() == "bench::window"
                 and ev.device_type() != _cuda_type()]
        lo_ns = _ns(marks[0], "start")
        self.trace = Trace(events, lo_ns, lo_ns + _ns(marks[0], "duration"))


def _cuda_type():
    from torch.autograd import DeviceType

    return DeviceType.CUDA


@contextlib.contextmanager
def span(name: str):
    """A ``bench::`` range in the trace around a call into the program."""
    with torch.profiler.record_function(f"bench::{name}"):
        yield
