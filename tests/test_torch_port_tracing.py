"""The port's spans (``core.profiling.annotate``) on the CPU: one
``cmt::sync.*`` span per host synchronisation of the graph build's fixed
points, nested in its stage's range; the directory walk's
``cmt::walk.*`` spans on the threads that wait; outputs unchanged by the
profiler; one span helper whose names all start with ``cmt::``. The last
test needs a card (``cuda``): every span stays out of device time.

Run on a machine with an NVIDIA GPU with

    python -m pytest tests/test_torch_port_tracing.py -m cuda --noconftest -q
"""

import ast
import importlib
import pathlib
from collections import Counter

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from camouflage_multimodal_tpu_torch import pipeline
from camouflage_multimodal_tpu_torch.core import profiling, stages

# ops.canny is the function; the modules by name
canny_mod = importlib.import_module("camouflage_multimodal_tpu_torch.ops.canny")
cc_mod = importlib.import_module("camouflage_multimodal_tpu_torch.ops.connectivity")

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT = REPO / "camouflage_multimodal_tpu_torch"
SYNC_SPANS = ("cmt::sync.canny", "cmt::sync.components", "cmt::sync.merge")
# The build's other host synchronisations until the constants were built
# once per device and the adjacency's True became a kernel argument (copies
# from pageable host memory), by the stage ranges that held them: they no
# longer open.
UPLOAD_SPANS = {"cmt::sync.lab": ("cmt::slic",), "cmt::sync.sobel": ("cmt::canny",),
                "cmt::sync.gray": ("cmt::canny", "cmt::region_features"),
                "cmt::sync.adjacency": ("cmt::rag",)}
# The stage graphs' spans (core/graphs.py) and the ranges that hold them:
# on the card the four host-free stages replay as CUDA graphs.
GRAPH_SPANS = {name: ("cmt::slic", "cmt::canny", "cmt::region_features", "cmt::rag")
               for name in ("cmt::graph.capture", "cmt::graph.replay")}
WALK_SPANS = ("cmt::walk.decode", "cmt::walk.wait_input", "cmt::walk.wait_output")


@pytest.fixture
def two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        yield
    finally:
        torch.set_num_threads(prev)


def _images(n=2, size=64, seed=0, device="cpu"):
    """Smooth colour fields with noise: edges for Canny, small fragments
    for connectivity's merge rounds."""
    g = torch.Generator().manual_seed(seed)
    coarse = torch.rand(n, 3, 6, 6, generator=g)
    img = torch.nn.functional.interpolate(coarse, size=(size, size), mode="bilinear",
                                          align_corners=False)
    img = img + 0.08 * torch.randn(n, 3, size, size, generator=g)
    return (img.clamp(0, 1).permute(0, 2, 3, 1) * 255).to(torch.uint8).to(device)


def _profiled(fn, activities=(ProfilerActivity.CPU,)):
    """``fn()`` under ``torch.profiler`` with every thread's ranges; returns
    (its result, the profiler's events)."""
    config = torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
    with profile(activities=list(activities), experimental_config=config) as prof:
        out = fn()
    return out, prof.events()


def _ranges(events, name):
    """(start, end, thread) of the host ranges ``name``, by start."""
    return sorted((e.time_range.start, e.time_range.end, e.thread) for e in events
                  if e.name == name and e.device_type == torch.autograd.DeviceType.CPU)


def _inside(inner, outer):
    """Each inner range lies in an outer range on its own thread."""
    return all(any(t == u and s >= a and e <= b for a, b, u in outer) for s, e, t in inner)


def test_build_records_one_sync_span_per_fixed_point_test(two_threads, monkeypatch):
    """``build_region_graphs`` on a CPU batch: as many ``cmt::sync.canny``
    spans as the hysteresis ran convergence tests, ``cmt::sync.components``
    as connected components ran, ``cmt::sync.merge`` as the merge rounds
    tested for pending merges, each nested in its stage's range on the
    caller's thread; the constant uploads' spans no longer open."""
    calls = Counter()

    def counted(name, fn):
        def wrapper(*args, **kw):
            calls[name] += 1
            return fn(*args, **kw)
        return wrapper

    monkeypatch.setattr(canny_mod, "binary_dilation_full",
                        counted("dilation", canny_mod.binary_dilation_full))
    monkeypatch.setattr(cc_mod, "_seg_min_scan", counted("scan", cc_mod._seg_min_scan))
    monkeypatch.setattr(cc_mod, "_ring_best", counted("absorb", cc_mod._ring_best))
    images = _images()
    _, events = _profiled(lambda: pipeline.build_region_graphs(images, n_segments=40))

    # Each test follows _STEPS_PER_CHECK dilations or _SWEEPS_PER_CHECK
    # sweeps of two scans; every merge test but the last is followed by an
    # absorption round, and round 1 precedes the first test.
    canny_tests = calls["dilation"] // canny_mod._STEPS_PER_CHECK
    cc_tests = calls["scan"] // (2 * cc_mod._SWEEPS_PER_CHECK)
    merge_tests = calls["absorb"]
    assert calls["dilation"] == canny_tests * canny_mod._STEPS_PER_CHECK
    assert canny_tests >= 2 and cc_tests >= 2 and 1 <= merge_tests < cc_mod._MAX_MERGE_ROUNDS
    spans = {name: _ranges(events, name) for name in SYNC_SPANS}
    assert [len(spans[n]) for n in SYNC_SPANS] == [canny_tests, cc_tests, merge_tests]
    assert _inside(spans["cmt::sync.canny"], _ranges(events, "cmt::canny"))
    for name in ("cmt::sync.components", "cmt::sync.merge"):
        assert _inside(spans[name], _ranges(events, "cmt::connectivity"))
    assert not any(_ranges(events, name) for name in UPLOAD_SPANS)
    caller = {t for _, _, t in _ranges(events, "cmt::slic")}
    assert len(caller) == 1 and all(t in caller for n in spans for *_, t in spans[n])


def _corner_map() -> torch.Tensor:
    """A map whose merge takes two rounds (test_torch_port_ops_surface.py):
    a corner block with no large contact stays in round 1, while the
    L-shape around it joins the background."""
    lab = torch.full((1, 48, 48), 2)
    lab[0, :2, :4] = 0
    lab[0, :3, 4] = 1
    lab[0, 2, :4] = 1
    return lab


@pytest.mark.parametrize("path", ["enforce_label_connectivity"])
def test_merge_spans_count_the_merge_rounds(path):
    """The connectivity pass: one ``cmt::sync.merge`` span per merge-round
    test, as many as the rounds the pass reports (the last test finds
    nothing pending), and one ``cmt::sync.components`` span per components
    test, each a host read on the caller's thread."""
    fn = getattr(cc_mod, path)
    (_, rounds), events = _profiled(lambda: fn(_corner_map(), 12, return_rounds=True))
    merges = _ranges(events, "cmt::sync.merge")
    assert int(rounds.max()) == 2 and len(merges) == 2
    components = _ranges(events, "cmt::sync.components")
    assert components and {t for *_, t in merges + components} == {merges[0][2]}


def _walk(n_chunks=3):
    """``run_overlapped`` over ``n_chunks`` small chunks inside a
    ``test::caller`` marker; each decode opens a marker naming its chunk.
    Returns the records."""
    records = []

    def decode(chunk):
        with record_function(f"test::chunk-{chunk}"):
            return np.full((2, 8), chunk, np.float32)

    def compute(x):
        return {"y": torch.as_tensor(x) * 2 + 1}

    with record_function("test::caller"):
        stages.run_overlapped(list(range(n_chunks)), decode,
                              lambda b: stages.upload(b, torch.device("cpu")), compute,
                              lambda out: stages.download(out, ["y"]), records.append)
    return records


def test_walk_spans_lie_on_their_threads_in_chunk_order():
    """Three chunks: three ``cmt::walk.decode`` spans on the decode worker
    (not the caller's thread), the i-th around chunk i's decode; three
    waits for input and three for output on the caller's thread. The
    worker's spans show that ``annotate``'s guard sees the profiler on a
    thread the profiler did not start from (``profile_all_threads``)."""
    records, events = _profiled(_walk)
    assert [r["y"][0, 0] for r in records] == [1.0, 3.0, 5.0]
    caller = _ranges(events, "test::caller")
    decodes = _ranges(events, "cmt::walk.decode")
    assert len(decodes) == 3 and all(t != caller[0][2] for *_, t in decodes)
    for i, span in enumerate(decodes):
        assert _inside(_ranges(events, f"test::chunk-{i}"), [span])
    for name in ("cmt::walk.wait_input", "cmt::walk.wait_output"):
        waits = _ranges(events, name)
        assert len(waits) == 3 and _inside(waits, caller)


def test_outputs_bit_equal_with_and_without_the_profiler(two_threads):
    """The spans change nothing the build or the walk computes."""
    images = _images(seed=3)
    plain = pipeline.build_region_graphs(images, n_segments=40)
    traced, _ = _profiled(lambda: pipeline.build_region_graphs(images, n_segments=40))
    for field in pipeline.RegionGraphBatch._fields:
        a, b = getattr(plain, field), getattr(traced, field)
        assert a.dtype == b.dtype and torch.equal(a, b), field
    walked, _ = _profiled(_walk)
    assert all(np.array_equal(a["y"], b["y"]) for a, b in zip(_walk(), walked))


def test_annotate_opens_nothing_without_a_profiler(monkeypatch):
    """With no profiler running, a span makes no ``record_function`` call;
    under one it does, on every thread that opens one."""
    opened = []

    def recording(name):
        opened.append(name)
        return record_function(name)

    monkeypatch.setattr(torch.profiler, "record_function", recording)
    with profiling.annotate("cmt::test.off"):
        pass
    assert opened == []
    _, events = _profiled(_walk)
    assert opened.count("cmt::walk.decode") == 3 and _ranges(events, "cmt::walk.decode")


def _calls(tree, name):
    return [node for node in ast.walk(tree) if isinstance(node, ast.Call)
            and getattr(node.func, "id", getattr(node.func, "attr", None)) == name]


def test_one_span_helper_and_every_span_named_cmt():
    """The port opens spans only through ``core.profiling.annotate``, and
    each name it passes is a literal starting with ``cmt::``; the sync,
    walk and graph spans are among them, the constant uploads' are not."""
    names = set()
    for path in sorted(PORT.rglob("*.py")):
        tree = ast.parse(path.read_text())
        if path != PORT / "core" / "profiling.py":
            assert not _calls(tree, "record_function"), path
        for call in _calls(tree, "annotate"):
            arg = call.args[0]
            assert isinstance(arg, ast.Constant) and arg.value.startswith("cmt::"), path
            names.add(arg.value)
    assert set(SYNC_SPANS + WALK_SPANS).union(GRAPH_SPANS) <= names
    assert not names & set(UPLOAD_SPANS)
    assert not hasattr(profiling, "StageTimer") and not hasattr(profiling, "trace")


@pytest.mark.cuda
def test_spans_are_not_device_work_on_the_card():
    """On the card, under CPU and CUDA tracing: the spans' mirrors on the
    card's timeline are no card events, and the kernels are. The build's
    four host-free stages replay as CUDA graphs there, one
    ``cmt::graph.replay`` span inside each stage's range, and the constant
    uploads' spans no longer open. Canny's hysteresis runs its fixed point
    in one kernel, so it opens no ``cmt::sync.canny`` span, and that
    kernel's launch call, the Canny graph's ``cudaGraphLaunch``, lies inside
    ``cmt::canny`` on the caller's thread."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    images = _images(n=4, size=96, device="cuda")
    pipeline.build_region_graphs(images, n_segments=60)     # builds the kernels, captures
    torch.cuda.synchronize()

    def run():
        out = pipeline.build_region_graphs(images, n_segments=60)
        walked = _walk()
        torch.cuda.synchronize()
        return out, walked

    config = torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 experimental_config=config) as prof:
        run()
    events = prof.events()
    names = {e.name for e in events}
    on_card = set(SYNC_SPANS + WALK_SPANS + ("cmt::graph.replay",)) - {"cmt::sync.canny"}
    assert on_card <= names and not names & {"cmt::sync.canny", "cmt::graph.capture"}
    assert not names & set(UPLOAD_SPANS)
    replays = _ranges(events, "cmt::graph.replay")
    stage_ranges = sum((_ranges(events, s) for s in GRAPH_SPANS["cmt::graph.replay"]), [])
    assert len(replays) == 4 and _inside(replays, stage_ranges)
    card = [e for e in events if profiling.is_card_event(e)]
    assert card and not any(e.name.startswith("cmt::") for e in card)

    raw = prof.profiler.kineto_results.events()
    cpu = torch.autograd.DeviceType.CPU
    hysteresis = {ev.correlation_id() for ev in raw if ev.device_type() != cpu
                  and "canny_hysteresis_kernel" in ev.name()}
    launches = [(ev.start_ns(), ev.start_thread_id()) for ev in raw if ev.device_type() == cpu
                and ev.name().startswith("cudaGraphLaunch")
                and ev.correlation_id() in hysteresis]
    canny = [(ev.start_ns(), ev.start_ns() + ev.duration_ns(), ev.start_thread_id())
             for ev in raw if ev.device_type() == cpu and ev.name() == "cmt::canny"]
    assert len(hysteresis) == 1 and len(launches) == 1 and len(canny) == 1
    assert all(a <= t <= b and u == thread for t, thread in launches for a, b, u in canny)
