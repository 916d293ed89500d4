"""Host-free stages replayed as CUDA graphs.

A stage is host-free when it launches its work with no host
synchronisation and takes no host decision on its data: one capture
(``torch.cuda.graph``) then records its launches, and each replay is one
``cudaGraphLaunch`` with no Python dispatch. :class:`StageGraphs` holds the
graphs of one key (the input shapes and settings that fix every launch),
their static input buffers and the one memory pool they share: they replay
in capture order, so a later stage may reuse what an earlier one freed.
:class:`GraphCache` keeps the keys, least recently used out first.

Spans (``core.profiling``): ``cmt::graph.capture`` around each capture and
``cmt::graph.replay`` around each replay, inside the caller's stage range.
``kernels.LAUNCHES`` stays exact: the wrappers count their launches while
a stage is captured, which launches nothing, so a capture takes its counts
back and each replay adds them.
"""

from __future__ import annotations

import contextlib
import threading
from collections import OrderedDict
from typing import Callable, ContextManager, Iterator, List, Tuple

import torch

from camouflage_multimodal_tpu_torch.core import kernels
from camouflage_multimodal_tpu_torch.core.profiling import annotate


def capture(fn: Callable, pool, stream: torch.cuda.Stream) -> Tuple[torch.cuda.CUDAGraph, object]:
    """``fn()`` captured on ``stream`` into a new CUDA graph that allocates
    from ``pool``: (the graph, ``fn``'s outputs). Thread-local capture
    checks only this thread's CUDA calls, so other threads (the directory
    walk's upload and download workers) may use the card meanwhile; the
    stream is one of PyTorch's non-blocking streams, so their work on the
    legacy default stream cannot join the capture."""
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, pool=pool, stream=stream, capture_error_mode="thread_local"):
        out = fn()
    return graph, out


def _tensors(out) -> List[torch.Tensor]:
    return [out] if isinstance(out, torch.Tensor) else list(out)


class StageGraph:
    """``fn(*inputs)`` captured once; :meth:`replay` reruns its launches on
    the current stream and returns the same output tensors, rewritten."""

    def __init__(self, fn: Callable, inputs: List[torch.Tensor], pool,
                 stream: torch.cuda.Stream) -> None:
        self.inputs = inputs
        before = dict(kernels.LAUNCHES)
        with annotate("cmt::graph.capture"):
            self.graph, self.outputs = capture(lambda: fn(*inputs), pool, stream)
        self.launches = {k: n - before[k] for k, n in kernels.LAUNCHES.items() if n != before[k]}
        for k, n in self.launches.items():
            kernels.LAUNCHES[k] -= n

    def replay(self):
        with annotate("cmt::graph.replay"):
            self.graph.replay()
        for k, n in self.launches.items():
            kernels.LAUNCHES[k] += n
        return self.outputs


class StageGraphs:
    """The graphs of one key's stages, called through :meth:`stage` inside
    :meth:`build`, in the same order in every build: the i-th call of a
    build is the i-th stage.

    A stage's first call runs it eagerly (its warm-up: kernels built, the
    allocator and the libraries' lazy state set up) and then captures it on
    static buffers; later calls copy their inputs into those buffers, once
    a build for each tensor, and replay. An input that is an earlier
    stage's output needs no copy: on a replay it is that graph's own
    output. Replayed outputs are overwritten by the next build, so
    :meth:`fresh` copies what the caller keeps."""

    def __init__(self, device: torch.device) -> None:
        self.device = device
        self.lock = threading.Lock()
        self.pool = torch.cuda.graph_pool_handle()
        self.stream = torch.cuda.Stream(device)
        self.done = torch.cuda.Event()
        self.graphs: List[StageGraph] = []
        self._step = 0
        self._fed: List[Tuple[torch.Tensor, torch.Tensor]] = []   # (tensor, its static twin)

    @contextlib.contextmanager
    def build(self) -> Iterator["StageGraphs"]:
        """One build at a time. On the caller's stream the build first waits
        for the last one (which another stream may have run) to finish with
        the static buffers; no host wait."""
        with self.lock:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(self.done)
            self._step = 0
            try:
                yield self
            finally:
                self._fed.clear()
                self.done.record(stream)

    def _twin(self, x: torch.Tensor):
        return next((buf for t, buf in self._fed if t is x), None)

    def stage(self, span: ContextManager, fn: Callable, *inputs: torch.Tensor):
        """``fn(*inputs)`` inside ``span`` (the stage's ``cmt::`` range):
        eager and captured on the stage's first call, replayed after."""
        step, self._step = self._step, self._step + 1
        if step == len(self.graphs):
            with span:
                out = fn(*inputs)
                static = []
                for x in inputs:
                    buf = self._twin(x)
                    if buf is None:
                        # no inference tensor: a later build outside
                        # inference mode copies into it
                        with torch.inference_mode(False):
                            buf = torch.empty_like(x, memory_format=torch.contiguous_format)
                        self._fed.append((x, buf))
                    static.append(buf)
                graph = StageGraph(fn, static, self.pool, self.stream)
                self.graphs.append(graph)
            self._fed.extend(zip(_tensors(out), _tensors(graph.outputs)))
            return out
        graph = self.graphs[step]
        for x, buf in zip(inputs, graph.inputs):
            if x is not buf and self._twin(x) is not buf:
                buf.copy_(x)
                self._fed.append((x, buf))
        with span:
            return graph.replay()

    def fresh(self, t: torch.Tensor) -> torch.Tensor:
        """``t``, copied when it is a graph's output."""
        ours = any(t is o for g in self.graphs for o in _tensors(g.outputs))
        return t.clone() if ours else t


class GraphCache:
    """:class:`StageGraphs` by key, at most ``max_keys`` of them, the least
    recently used dropped first: once its last build has finished on the
    card, since a graph's memory goes back with it."""

    def __init__(self, max_keys: int) -> None:
        self.max_keys = max_keys
        self.lock = threading.Lock()
        self.entries: "OrderedDict[tuple, StageGraphs]" = OrderedDict()

    def get(self, key: tuple, device: torch.device) -> StageGraphs:
        dropped = []
        with self.lock:
            graphs = self.entries.get(key)
            if graphs is None:
                graphs = self.entries[key] = StageGraphs(device)
                while len(self.entries) > self.max_keys:
                    dropped.append(self.entries.popitem(last=False)[1])
            else:
                self.entries.move_to_end(key)
        for old in dropped:
            with old.lock:
                old.done.synchronize()
        return graphs
