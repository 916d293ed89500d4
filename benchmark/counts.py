"""Operations and bytes of the work each cell asks for, from the
configuration's shapes and each input's real node count; never from the
program, so a later change that replaces a kernel is held to the same work.

Conventions: a multiply-add is two operations; elementwise steps (softmax,
LayerNorm, activations) are left out where a matrix product dominates them;
bytes count each input read once and each output written once, whatever an
implementation reads again. Peaks are NVIDIA's published H100 SXM rates at
the 700 W limit: 3.35 TB/s of HBM and 67 TFLOP/s of float32 outside the
tensor cores, the precision the configurations state (TF32 off).
"""

from __future__ import annotations

from typing import Dict, Iterable

PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
F32 = 4

# The segment graph's mean degree: a planar map of regions has fewer than
# six neighbours a region on average; the graph layers are counted at six
# neighbours plus the self loop, an upper bound on the work they need.
MEAN_DEGREE = 6


def bound_s(flops: float, nbytes: float) -> float:
    """The least time the chip could take: the larger of the two bounds."""
    return max(flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES_PER_S)


def _dense(rows: float, cin: int, cout: int) -> float:
    return 2.0 * rows * cin * cout


# ---------------------------------------------------------------------------
# Region-graph GNN
# ---------------------------------------------------------------------------

def gnn_forward_flops(n: int, cfg: Dict) -> float:
    """RG GNN forward of one graph of ``n`` real nodes: GAT (its projection,
    the two attention terms and the aggregation over each node's neighbours
    and itself, every head), three GCN layers (projection and aggregation),
    the shared FC and the three heads."""
    g = cfg["rg_gnn"]
    cin, hid, heads = g["in_channels"], g["hidden_channels"], g["gat_heads"]
    nbrs = MEAN_DEGREE + 1
    gat = _dense(n, cin, heads * hid) + 2 * 2.0 * n * heads * hid + 2.0 * n * nbrs * heads * hid
    gcn = 3 * (_dense(n, hid, hid) + 2.0 * n * nbrs * hid)
    heads_fc = _dense(n, hid, hid) + sum(_dense(n, hid, hid // 2) + _dense(n, hid // 2, out)
                                         for out in (g["num_classes"], g["num_classes"], 1))
    return gat + gcn + heads_fc


# ---------------------------------------------------------------------------
# Fusion
# ---------------------------------------------------------------------------

def _mha_flops(nq: int, nk: int, e: int) -> float:
    """Projections of queries, keys, values and output, the logits and the
    probability-weighted values (all heads together)."""
    return (_dense(nq, e, e) + 2 * _dense(nk, e, e) + _dense(nq, e, e)
            + 2 * 2.0 * nq * nk * e)


def fusion_forward_flops(n: int, cfg: Dict) -> float:
    """Cross-attention fusion and its four heads for one image of ``n``
    real nodes against the configuration's KG categories."""
    f = cfg["fusion"]
    e, rg, kg, nkg = f["hidden_dim"], f["rg_dim"], f["kg_dim"], f["kg_categories"]
    flops = _dense(n, rg, e) + _dense(nkg, kg, e)                       # projections
    flops += _mha_flops(n, nkg, e) + _mha_flops(nkg, n, e)              # both directions
    flops += _dense(n, e, 2 * e) + _dense(n, 2 * e, e)                  # RG feed-forward
    flops += _dense(nkg, e, 2 * e) + _dense(nkg, 2 * e, e)              # KG feed-forward
    flops += _dense(1, 2 * e, e) + _dense(1, e, e)                      # fusion MLP
    flops += sum(_dense(1, e, e // 2) + _dense(1, e // 2, out)
                 for out in (f["num_classes"], f["num_classes"], 1, 1))
    return flops


def fusion_params(cfg: Dict) -> int:
    """Parameters of the cross-attention detector (weights and biases)."""
    f = cfg["fusion"]
    e, rg, kg = f["hidden_dim"], f["rg_dim"], f["kg_dim"]

    def lin(a, b):
        return a * b + b

    n = (lin(rg, e) if rg != e else 0) + (lin(kg, e) if kg != e else 0)
    n += 2 * 4 * lin(e, e)                                   # two attentions
    n += 2 * 2 * e                                           # two LayerNorms
    n += 2 * (lin(e, 2 * e) + lin(2 * e, e))                 # two feed-forwards
    n += lin(2 * e, e) + lin(e, e)                           # fusion MLP
    n += sum(lin(e, e // 2) + lin(e // 2, out)
             for out in (f["num_classes"], f["num_classes"], 1, 1))
    return n


def fusion_forward_bytes(nodes: Iterable[int], cfg: Dict) -> float:
    """One batched fusion call: its weights read once, each image's node
    embeddings and the KG matrix read, its attention maps and outputs
    written."""
    f = cfg["fusion"]
    nkg, rg, kg = f["kg_categories"], f["rg_dim"], f["kg_dim"]
    total = fusion_params(cfg) * F32
    for n in nodes:
        total += (n * rg + nkg * kg + 2 * n * nkg + 2 * f["num_classes"] + 2) * F32
    return total


def train_step_flops(nodes: Iterable[int], cfg: Dict) -> float:
    """One fusion training step: forward and backward (twice the forward's
    products) of each record, and AdamW over every parameter (about 14
    operations a parameter with the clip)."""
    return sum(3.0 * fusion_forward_flops(n, cfg) for n in nodes) + 14.0 * fusion_params(cfg)


# ---------------------------------------------------------------------------
# SLIC stage
# ---------------------------------------------------------------------------

def slic_stage(height: int, width: int, cfg: Dict) -> Dict[str, float]:
    """SLIC of one image, as the stage runs it: the Lab conversion and blur
    (RGB float read, five-channel pixel features written), ``iters``
    assignment passes (each pixel's features and previous label read, its
    label written, scored against the centers its ±step box reaches: about
    ((2·step + 1) / step)² of them on the seed grid, 16 operations each)
    and ``iters − 1`` center-sum passes (features and labels read, six sums
    a pixel). Returns ``{"flops", "bytes"}``."""
    s = cfg["slic"]
    iters, k = s["iterations"], s["k"]
    hw = height * width
    step = max(1, round((hw / s["n_segments"]) ** 0.5))
    reach = ((2 * step + 1) / step) ** 2
    blur_taps = 2 * int(4.0 * s["sigma"] + 0.5) + 1
    flops = hw * (40 + 3 * 2 * 2 * blur_taps)                  # Lab, separable blur
    nbytes = hw * (3 + 5) * F32
    flops += iters * hw * reach * 16
    nbytes += iters * (hw * (5 * F32 + 4 + 4) + k * 5 * F32)
    flops += (iters - 1) * hw * 6
    nbytes += (iters - 1) * (hw * (5 * F32 + 4) + k * 6 * F32)
    return {"flops": float(flops), "bytes": float(nbytes)}
