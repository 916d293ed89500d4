"""``counts.py`` against shapes worked by hand."""

import json

import pytest

import counts
from harness import HERE
from reference.models import FusionDetector


@pytest.fixture
def cfg352():
    with open(HERE / "configs" / "cod10k-352.json") as f:
        return json.load(f)


def test_fusion_forward_at_490_nodes(cfg352):
    # projections 32,112,640 + 851,968; each attention direction 138,381,312;
    # feed-forwards 256,901,120 + 6,815,744; fusion MLP 393,216; heads 263,680
    assert counts.fusion_forward_flops(490, cfg352) == 574_100_992


def test_gnn_forward_at_490_nodes(cfg352):
    # GAT 12,042,240 + three GCN 50,803,200 + shared FC and heads 40,454,400
    assert counts.gnn_forward_flops(490, cfg352) == 103_299_840


def test_slic_stage_at_352(cfg352):
    work = counts.slic_stage(352, 352, cfg352)
    # Lab and blur 148 a pixel, 10 assignments at 68.0625, 9 sums at 6
    assert work["flops"] == 109_360_768
    # 32 B a pixel, 10 × (28 B a pixel + 484 centers × 20 B), 9 × (24 B + 484 × 24 B)
    assert work["bytes"] == 65_622_656


def test_fusion_params_match_the_reference_model(cfg352):
    f = cfg352["fusion"]
    model = FusionDetector(f["rg_dim"], f["kg_dim"], f["hidden_dim"], f["num_heads"],
                           f["num_classes"], f["dropout"])
    assert counts.fusion_params(cfg352) == sum(p.numel() for p in model.parameters()) == 1_448_710


def test_train_step_is_three_forwards_and_adamw(cfg352):
    nodes = [492, 500, 510, 525]
    want = sum(3 * counts.fusion_forward_flops(n, cfg352) for n in nodes) + 14 * 1_448_710
    assert counts.train_step_flops(nodes, cfg352) == want


def test_bound_takes_the_larger_side():
    assert counts.bound_s(67e12, 0) == pytest.approx(1.0)
    assert counts.bound_s(0, 3.35e12) == pytest.approx(1.0)
    assert counts.bound_s(67e12, 6.7e12) == pytest.approx(2.0)
