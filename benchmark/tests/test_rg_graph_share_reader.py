"""The reader of ``rg_graph_share.offline`` on a hand-built
:class:`tracing.Trace`: the program's ``cmt::graph.replay`` spans over its
four RG-build stage ranges, in %, and None where the stage ranges or the
graph spans are absent (a program without stage graphs reports nothing)."""

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


STAGE_SPANS = {name: [(0.1, 0.2, 1), (1.1, 1.2, 1)]
               for name in ("cmt::slic", "cmt::canny", "cmt::region_features", "cmt::rag")}
REPLAYS = {"cmt::graph.replay": [(0.1 + 0.01 * i, 0.105 + 0.01 * i, 1) for i in range(4)]
           + [(1.1 + 0.01 * i, 1.105 + 0.01 * i, 1) for i in range(4)]}
CAPTURES = {"cmt::graph.capture": [(0.15, 0.19, 1)]}


@pytest.mark.parametrize("spans,want", [
    ({**STAGE_SPANS, **REPLAYS}, 100.0),
    ({**STAGE_SPANS, **CAPTURES}, 0.0),
    ({**STAGE_SPANS, **CAPTURES, "cmt::graph.replay": REPLAYS["cmt::graph.replay"][4:]}, 50.0),
    (REPLAYS, None),
    (STAGE_SPANS, None),
], ids=["replays_only", "capture_no_replay", "half_replayed", "no_stage_range", "no_graph_span"])
def test_rg_graph_share(spans, want):
    """Replays over the four stage ranges, in %: 100 when every stage
    replayed, 0 after a capture with no replay; None with no stage range,
    or with no graph span at all (a program without stage graphs)."""
    got = _reader("rg_graph_share.offline").read(
        {"trace": _trace(spans), "images": IMAGES, "batches": BATCHES})
    assert got == (None if want is None else pytest.approx(want, rel=1e-12))
