"""The readers of the program's RG-build sync spans and walk spans on a
hand-built :class:`tracing.Trace`: each gives its value from the spans
and the window's image and batch counts, and None where its spans are
absent (a program without them reports nothing)."""

import pytest

from harness import HERE, load_module
from tracing import Trace

WINDOW_S = 2.0
IMAGES, BATCHES = 32, [[500] * 16, [480] * 16]


def _reader(name):
    return load_module(HERE / "metrics" / f"{name}.py", f"r_{name.replace('.', '_')}")


def _trace(ranges):
    """A window of ``WINDOW_S`` seconds holding ``ranges``: name → list of
    (start s, end s, thread)."""
    tr = Trace([], 0, int(WINDOW_S * 1e9))
    for name, spans in ranges.items():
        tr.ranges[name] = list(spans)
    return tr


SPANS = {
    "cmt::canny": [(0.0, 0.5, 1), (1.0, 1.5, 1)],
    "cmt::sync.canny": [(0.1 * i, 0.1 * i + 0.002, 1) for i in range(5)]
    + [(1.0 + 0.1 * i, 1.0 + 0.1 * i + 0.002, 1) for i in range(4)],
    "cmt::sync.components": [(0.6, 0.601, 1), (0.62, 0.621, 1), (1.6, 1.601, 1)],
    "cmt::sync.merge": [(0.7, 0.704, 1), (1.7, 1.704, 1)],
    "cmt::sync.slic": [(0.8, 0.81, 1)],
    "cmt::walk.decode": [(0.0, 0.04, 2), (0.5, 0.54, 2), (1.9, 2.1, 2)],
    "cmt::walk.wait_input": [(0.0, 0.05, 1), (0.9, 0.901, 1)],
    "cmt::walk.wait_output": [(0.95, 0.953, 1), (1.95, 1.952, 1)],
    "bench::decode": [(0.001, 0.039, 2)],
}

# Each reader's value on SPANS: host ms an image, or syncs a batch.
WANT = {
    "rg_sync_ms.offline": 1000 * (9 * 0.002 + 3 * 0.001 + 2 * 0.004 + 0.01) / IMAGES,
    "canny_syncs.offline": 9 / 2,
    "connectivity_syncs.offline": 5 / 2,
    "walk_wait_ms.offline": 1000 * (0.05 + 0.001 + 0.003 + 0.002) / IMAGES,
    # the third decode is clipped at the window's end
    "walk_decode_ms.offline": 1000 * (0.04 + 0.04 + 0.1) / IMAGES,
}
# The span names each reader reads; without them it reads None.
READS = {
    "rg_sync_ms.offline": ("cmt::sync.canny", "cmt::sync.components", "cmt::sync.merge",
                           "cmt::sync.slic"),
    "canny_syncs.offline": ("cmt::sync.canny",),
    "connectivity_syncs.offline": ("cmt::sync.components", "cmt::sync.merge"),
    "walk_wait_ms.offline": ("cmt::walk.wait_input", "cmt::walk.wait_output"),
    "walk_decode_ms.offline": ("cmt::walk.decode",),
}


@pytest.mark.parametrize("name", sorted(WANT))
def test_reader_value(name):
    got = _reader(name).read({"trace": _trace(SPANS), "images": IMAGES, "batches": BATCHES})
    assert got == pytest.approx(WANT[name], rel=1e-9)


@pytest.mark.parametrize("name", sorted(WANT))
def test_reader_none_without_its_spans(name):
    """A trace without the reader's spans (the parent program's), or a
    window that completed nothing, reads None, never 0."""
    absent = {k: v for k, v in SPANS.items() if k not in READS[name]}
    reader = _reader(name)
    assert reader.read({"trace": _trace(absent), "images": IMAGES, "batches": BATCHES}) is None
    assert reader.read({"trace": _trace(SPANS), "images": 0, "batches": []}) is None


def test_connectivity_syncs_reads_either_test():
    """Merge tests alone (a program whose components test moved) still read."""
    spans = {"cmt::sync.merge": SPANS["cmt::sync.merge"]}
    got = _reader("connectivity_syncs.offline").read(
        {"trace": _trace(spans), "images": IMAGES, "batches": BATCHES})
    assert got == 1.0
