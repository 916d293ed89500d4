"""The RG build's host-free stages as CUDA graphs (``core/graphs.py``,
``pipeline.build_region_graphs``).

On the CPU: CPU tensors and a ``row_group`` never reach a graph. The graph
machinery itself runs here on a stand-in for a CUDA graph (:class:`FakeGraph`:
its capture runs the stage once for its output tensors, and its replay runs
it again into those tensors, as a replay rewrites a graph's buffers); on it
the replays give the eager bits, the build returns tensors of its own,
``kernels.LAUNCHES`` stays exact and the ``cmt::graph.*`` spans open inside
the stage ranges. The build's constants and the adjacency fill keep their
bits. Marked ``cuda``, on the card: replay against eager at 16 × 352² and
4 × 256², a capture during a directory walk, a ``row_group`` build, and no
host synchronisation in the four stages or their replays.

Run the card tests on a machine with an NVIDIA GPU with

    python -m pytest tests/test_torch_port_graphs.py -m cuda --noconftest -q
"""

import contextlib
import importlib
import sys
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from camouflage_multimodal_tpu_torch import pipeline
from camouflage_multimodal_tpu_torch.core import graphs, kernels, stages
from camouflage_multimodal_tpu_torch.ops import image as image_ops

rag = importlib.import_module("camouflage_multimodal_tpu_torch.ops.rag")

STAGE_RANGES = ("cmt::slic", "cmt::canny", "cmt::region_features", "cmt::rag")
GONE_SPANS = ("cmt::sync.lab", "cmt::sync.gray", "cmt::sync.sobel", "cmt::sync.adjacency")
CPU_SETTINGS = (40, pipeline.padded_nodes(40, 64), 10, 3, None)


def _images(n=2, size=64, seed=0, device="cpu"):
    """(n, size, size, 3) uint8: smooth colour fields with noise."""
    g = torch.Generator().manual_seed(seed)
    coarse = torch.rand(n, 3, 6, 6, generator=g)
    img = torch.nn.functional.interpolate(coarse, size=(size, size), mode="bilinear",
                                          align_corners=False)
    img = img + 0.08 * torch.randn(n, 3, size, size, generator=g)
    return (img.clamp(0, 1).permute(0, 2, 3, 1) * 255).to(torch.uint8).to(device)


def _eager(images, settings):
    return pipeline._build_stages(images.float() / 255.0, *settings, pipeline._eager_stage)


def _assert_equal(got, want):
    for field in pipeline.RegionGraphBatch._fields:
        a, b = getattr(got, field), getattr(want, field)
        assert a.dtype == b.dtype and torch.equal(a, b), field


# ---------------------------------------------------------------------------
# A stand-in for a CUDA graph on the CPU
# ---------------------------------------------------------------------------

class FakeGraph:
    """Capture runs ``fn`` once for its output tensors; a replay runs it
    again into them and, like a real replay, runs no wrapper's Python (the
    launch counts are left as they were)."""

    replays = 0

    def __init__(self, fn):
        self.fn = fn
        self.outputs = fn()

    def replay(self):
        FakeGraph.replays += 1
        counts = dict(kernels.LAUNCHES)
        # a replay writes the outputs' memory behind autograd's back, in any mode
        with torch.inference_mode():
            for old, new in zip(graphs._tensors(self.outputs), graphs._tensors(self.fn())):
                old.copy_(new)
        kernels.LAUNCHES.update(counts)


class _FakeEvent:
    def record(self, stream=None):
        pass

    def synchronize(self):
        pass


class _FakeStream:
    def wait_event(self, event):
        pass


def _fake_capture(fn, pool, stream):
    graph = FakeGraph(fn)
    return graph, graph.outputs


@pytest.fixture
def fake_cuda(monkeypatch):
    """The few CUDA calls of ``core.graphs``, answered on the CPU."""
    monkeypatch.setattr(graphs, "capture", _fake_capture)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: None)
    monkeypatch.setattr(torch.cuda, "Stream", lambda device=None: None)
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: _FakeStream())
    monkeypatch.setattr(FakeGraph, "replays", 0)


def _profiled(fn):
    config = torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
    with profile(activities=[ProfilerActivity.CPU], experimental_config=config) as prof:
        out = fn()
    return out, prof.events()


def _ranges(events, name):
    return sorted((e.time_range.start, e.time_range.end, e.thread) for e in events
                  if e.name == name and e.device_type == torch.autograd.DeviceType.CPU)


def _inside(inner, outer):
    return all(any(t == u and s >= a and e <= b for a, b, u in outer) for s, e, t in inner)


# ---------------------------------------------------------------------------
# CPU
# ---------------------------------------------------------------------------

class _NoGraphs:
    def get(self, *args):
        raise AssertionError("the eager path reached the graph cache")


@contextlib.contextmanager
def _world_of_one():
    """A process group of one rank on torch's fake backend (its collectives
    do nothing, which is exact at one rank), torn down after."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    torch.distributed.init_process_group("fake", store=FakeStore(), rank=0, world_size=1)
    try:
        yield torch.distributed.group.WORLD
    finally:
        torch.distributed.destroy_process_group()


def _no_graph_build(monkeypatch, device, grouped):
    """A build on ``device`` (with a one-rank ``row_group`` when ``grouped``)
    with every graph API made to raise: it must not reach one, and it
    equals the eager stages."""
    def refuse(*args, **kw):
        raise AssertionError("the eager path reached a graph API")

    monkeypatch.setattr(pipeline, "_GRAPHS", _NoGraphs())
    monkeypatch.setattr(graphs, "capture", refuse)
    monkeypatch.setattr(graphs, "StageGraphs", refuse)
    monkeypatch.setattr(torch.cuda, "CUDAGraph", refuse)
    images = _images(device=device)
    with (_world_of_one() if grouped else contextlib.nullcontext()) as group:
        got = pipeline.build_region_graphs(images, *CPU_SETTINGS[:2], row_group=group)
    _assert_equal(got, _eager(images, CPU_SETTINGS))


@pytest.mark.parametrize("grouped", [False, True], ids=["no_group", "row_group"])
def test_cpu_builds_never_reach_a_graph(monkeypatch, grouped):
    _no_graph_build(monkeypatch, "cpu", grouped)


def test_replayed_builds_equal_eager_and_are_the_callers_own(fake_cuda):
    """Three builds of different scenes through one key's graphs: the first
    captures the four stages, the next two replay them; each equals the
    eager stages to the bit, and no build's outputs change when a later
    build replays into the graphs' buffers."""
    g = graphs.StageGraphs(torch.device("cpu"))
    kept = []
    for seed in range(3):
        images = _images(seed=seed)
        got = pipeline._replayed(g, images.float() / 255.0, CPU_SETTINGS)
        want = _eager(images, CPU_SETTINGS)
        _assert_equal(got, want)
        kept.append((got, want))
    assert len(g.graphs) == 4 and FakeGraph.replays == 8
    for got, want in kept:
        _assert_equal(got, want)


@pytest.mark.parametrize("first,later", [(True, False), (False, True)],
                         ids=["captured_in_inference_mode", "replayed_in_inference_mode"])
def test_inference_mode_of_capture_and_replay_may_differ(fake_cuda, first, later):
    """A key captured under ``torch.inference_mode`` replays outside it,
    and the other way round: the static input buffers are no inference
    tensors, so a replay may copy into them in either mode."""
    g = graphs.StageGraphs(torch.device("cpu"))
    for seed, mode in ((0, first), (1, later)):
        images = _images(seed=seed)
        with torch.inference_mode(mode):
            got = pipeline._replayed(g, images.float() / 255.0, CPU_SETTINGS)
        _assert_equal(got, _eager(images, CPU_SETTINGS))


def test_graph_spans_open_inside_the_stage_ranges(fake_cuda):
    """A capture and a replay build: one ``cmt::graph.capture`` span in
    each of the four stage ranges of the first, one ``cmt::graph.replay``
    in each of the second, none in connectivity's; the constants' and the
    adjacency's sync spans no longer open."""
    g = graphs.StageGraphs(torch.device("cpu"))
    images = _images().float() / 255.0

    def two_builds():
        pipeline._replayed(g, images, CPU_SETTINGS)
        pipeline._replayed(g, images, CPU_SETTINGS)

    _, events = _profiled(two_builds)
    for name in STAGE_RANGES:
        first, second = _ranges(events, name)
        assert len(_ranges(events, name)) == 2
        assert sum(_inside([c], [first]) for c in _ranges(events, "cmt::graph.capture")) == 1
        assert sum(_inside([r], [second]) for r in _ranges(events, "cmt::graph.replay")) == 1
    spans = _ranges(events, "cmt::graph.capture") + _ranges(events, "cmt::graph.replay")
    assert len(spans) == 8
    assert not any(_inside([s], _ranges(events, "cmt::connectivity")) for s in spans)
    assert not any(_ranges(events, name) for name in GONE_SPANS)


def test_launch_counts_stay_exact_under_replay(fake_cuda):
    """A stage whose wrappers count 10 launches: 10 for its eager first
    call (its capture counts none), 10 for each replay."""
    def stage(x):
        kernels.LAUNCHES["slic_assign"] += 10
        return x * 2

    g = graphs.StageGraphs(torch.device("cpu"))
    x = torch.arange(4.0)
    before = kernels.LAUNCHES["slic_assign"]
    for call in range(1, 4):
        with g.build():
            out = g.stage(contextlib.nullcontext(), stage, x + call)
        assert kernels.LAUNCHES["slic_assign"] == before + 10 * call
        assert torch.equal(out, (x + call) * 2)
    assert g.graphs[0].launches == {"slic_assign": 10}


def test_cache_keeps_the_most_recently_used_keys(fake_cuda):
    """At most ``max_keys`` keys; a key used again moves to the back, and
    the least recently used goes first."""
    cache = graphs.GraphCache(2)
    dev = torch.device("cpu")
    a, b = cache.get("a", dev), cache.get("b", dev)
    assert cache.get("a", dev) is a
    cache.get("c", dev)
    assert list(cache.entries) == ["a", "c"] and cache.get("a", dev) is a
    assert cache.get("b", dev) is not b and list(cache.entries) == ["a", "b"]


def test_builds_from_many_threads_keep_their_own_data(fake_cuda):
    """16 threads build through a cache of 2 keys over 3 key shapes (so keys
    are dropped and captured again) with a short switch interval: every
    build returns its own input's result, which a replay interleaved with
    another thread's, or a graph dropped under a build, would break."""
    def two_stages(g, x):
        with g.build():
            y = g.stage(contextlib.nullcontext(), lambda a: a * 2 + 1, x)
            z = g.stage(contextlib.nullcontext(), lambda a, b: a + b, y, x)
            return g.fresh(z)

    cache, dev, wrong = graphs.GraphCache(2), torch.device("cpu"), []

    def worker(t):
        for i in range(25):
            n = 3 + (t + i) % 3
            x = torch.full((n, 64), float(1000 * t + i))
            if not torch.equal(two_stages(cache.get(n, dev), x), x * 3 + 1):
                wrong.append((t, i))

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(t,)) for t in range(16)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(th.is_alive() for th in threads) and not wrong
    assert len(cache.entries) <= 2


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_constants_are_built_once_with_the_same_bits(dtype):
    """Each constant of the build equals ``torch.tensor`` of its values, is
    one tensor per device and dtype, and is no inference tensor even when
    first asked for under inference mode; the gray conversion and Sobel
    give the bits of constants built on every call."""
    img = torch.rand(2, 9, 11, 3, dtype=dtype, generator=torch.Generator().manual_seed(5))
    image_ops._CONSTANTS.clear()
    for values in (image_ops.GRAY_WEIGHTS, image_ops._XYZ_FROM_RGB, image_ops._D65_WHITE,
                   (-1.0, 0.0, 1.0), (1.0, 2.0, 1.0)):
        with torch.inference_mode():
            const = image_ops._constant(values, img)
        assert not const.is_inference() and const is image_ops._constant(values, img)
        assert torch.equal(const, torch.tensor(values, dtype=dtype))
    w = torch.tensor(image_ops.GRAY_WEIGHTS, dtype=dtype)
    assert torch.equal(image_ops.rgb_to_gray(img), image_ops._dot3(img, w))
    gray = img[..., 0]
    for dim, fn in ((-2, image_ops.sobel_h), (-1, image_ops.sobel_v)):
        other = -1 if dim == -2 else -2
        x = image_ops._correlate_valid(image_ops._pad_axis(gray, 1, dim, "reflect"),
                                       torch.tensor([-1.0, 0.0, 1.0], dtype=dtype), dim)
        want = image_ops._correlate_valid(image_ops._pad_axis(x, 1, other, "reflect"),
                                          torch.tensor([1.0, 2.0, 1.0], dtype=dtype), other)
        assert torch.equal(fn(gray), want)


def _setitem_adjacency(segments, K):
    """``region_adjacency`` as it set its bits before, ``adj[idx] = True``."""
    B = segments.shape[0]
    K1 = K + 1
    s = segments.long()
    s = torch.where((s >= 0) & (s < K), s, K)
    base = (torch.arange(B) * K1 * K1).reshape(B, 1, 1)
    adj = torch.zeros(B * K1 * K1, dtype=torch.bool)
    for n in rag._forward_neighbor_maps(s):
        n = torch.where((n >= 0) & (n < K), n, K)
        adj[(base + s * K1 + n).reshape(-1)] = True
    adj = adj.reshape(B, K1, K1)[:, :K, :K]
    adj = adj | adj.transpose(1, 2)
    return adj & ~torch.eye(K, dtype=torch.bool)


@pytest.mark.parametrize("seed", [0, 1])
def test_adjacency_fill_keeps_its_bits(seed):
    """``index_fill_`` sets the bits ``adj[idx] = True`` set, labels out of
    range included."""
    g = torch.Generator().manual_seed(seed)
    coarse = torch.randint(-1, 14, (3, 5, 6), generator=g)
    segments = coarse.repeat_interleave(4, 1).repeat_interleave(3, 2)
    segments[0, 7] = torch.randint(0, 12, (18,), generator=g)
    assert torch.equal(rag.region_adjacency(segments, 12), _setitem_adjacency(segments, 12))


# ---------------------------------------------------------------------------
# The card
# ---------------------------------------------------------------------------

CARD_SHAPES = [(16, 352, 484), (4, 256, 500)]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture
def fresh_cache(monkeypatch):
    cache = graphs.GraphCache(pipeline._GRAPH_KEYS)
    monkeypatch.setattr(pipeline, "_GRAPHS", cache)
    return cache


def _card_settings(size, segments):
    return (segments, pipeline.padded_nodes(segments, size), 10, 3, None)


@pytest.mark.cuda
def test_row_group_build_on_the_card_never_reaches_a_graph(dev, monkeypatch):
    _no_graph_build(monkeypatch, dev, grouped=True)


@pytest.mark.cuda
@pytest.mark.parametrize("n,size,segments", CARD_SHAPES)
def test_replay_equals_eager_on_the_card(dev, fresh_cache, n, size, segments):
    """Three builds of different scenes: the first captures, the next two
    replay. Each equals the eager stages to the bit in every field, counts
    the launches the eager stages count, and keeps its outputs after the
    next build."""
    settings = _card_settings(size, segments)
    kept = []
    for seed in range(3):
        images = _images(n, size, seed, dev)
        kernels.reset_launches()
        got = pipeline.build_region_graphs(images, *settings[:2])
        torch.cuda.synchronize()
        replayed = dict(kernels.LAUNCHES)
        kernels.reset_launches()
        want = _eager(images, settings)
        torch.cuda.synchronize()
        assert replayed == kernels.LAUNCHES and replayed["slic_assign"] == 10
        _assert_equal(got, want)
        kept.append((got, want))
    (g,) = fresh_cache.entries.values()
    assert len(g.graphs) == 4
    for got, want in kept:
        _assert_equal(got, want)


@pytest.mark.cuda
def test_capture_during_a_directory_walk(dev, fresh_cache):
    """A walk (``core.stages.run_overlapped``) whose chunks alternate two
    batch sizes: each size's first build captures while the walk's workers
    upload the next chunks (and, for the second size, download the first
    chunk's outputs). Every output equals the eager build's."""
    size, segments = 256, 500
    settings = _card_settings(size, segments)
    chunks = [(i, 4 if i % 2 == 0 else 2) for i in range(6)]
    sent, records = {}, []

    def decode(chunk):
        i, n = chunk
        return i, _images(n, size, 10 + i).numpy()

    def upload(decoded):
        i, batch = decoded
        return i, stages.upload(batch, dev)

    def compute(uploaded):
        i, images = uploaded
        sent[i] = images
        return dict(pipeline.build_region_graphs(images, *settings[:2])._asdict(), i=i)

    def download(out):
        i = out.pop("i")
        return i, stages.download(out, pipeline.RegionGraphBatch._fields)

    stages.run_overlapped(chunks, decode, upload, compute, download, records.append)
    assert [i for i, _ in records] == list(range(6)) and len(fresh_cache.entries) == 2
    for i, host in records:
        want = _eager(sent[i], settings)
        for field in pipeline.RegionGraphBatch._fields:
            assert np.array_equal(host[field], getattr(want, field).cpu().numpy()), (i, field)


@contextlib.contextmanager
def _syncs_raise():
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode("default")


@pytest.mark.cuda
def test_no_host_sync_in_the_four_stages(dev, fresh_cache):
    """With every synchronising call made to raise, the four stages run
    eagerly and as replays (connectivity, outside them, still waits for the
    card)."""
    images = _images(16, 352, 3, dev).float() / 255.0
    settings = _card_settings(352, 484)

    def strict(stage):
        def run(span, fn, *inputs):
            with _syncs_raise():
                return stage(span, fn, *inputs)
        return run

    pipeline._build_stages(images, *settings, pipeline._eager_stage)   # builds the kernels
    pipeline._build_stages(images, *settings, strict(pipeline._eager_stage))
    g = graphs.StageGraphs(dev)
    pipeline._replayed(g, images, settings)                              # captures
    with g.build():
        batch = pipeline._build_stages(images, *settings, strict(g.stage))
    _assert_equal(batch, pipeline._build_stages(images, *settings, pipeline._eager_stage))
