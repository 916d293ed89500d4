"""Parity of the PyTorch port's fusion training with the JAX package, on the
CPU: the attention backward (kernel B3's plain version), dropout, losses,
schedule, optimizer step, dataset, the 2-D / 4-D / late-fusion model paths
and ``FusionTrainer`` as a whole.

Inputs and noise come from numpy with a seed and go through both packages.
Tolerances: gradients 1e-4 (the JAX package's own bar between its two
attention paths, tests/test_pallas.py:98-103); losses and optimizer steps
1e-6 (same float32 formulas, another operation order); model outputs 1e-4
through attention and 1e-5 without; a whole training run 1e-3 (two epochs
of float32 steps from shared weights). Dataset outputs are numpy on both
sides and must be bit-equal.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

jax.config.update("jax_platforms", "cpu")

from camouflage_multimodal_tpu.api import load_multimodal_model as j_load_multimodal  # noqa: E402
from camouflage_multimodal_tpu.data import labels as j_labels  # noqa: E402
from camouflage_multimodal_tpu.models.fusion import (  # noqa: E402
    MultimodalCamouflageDetector as JDetector)
from camouflage_multimodal_tpu.ops.attention import (  # noqa: E402
    init_mha_params, multihead_attention as j_mha)
from camouflage_multimodal_tpu.ops.pallas_attention import (  # noqa: E402
    pallas_multihead_attention_trainable)
from camouflage_multimodal_tpu.train import losses as j_losses  # noqa: E402
from camouflage_multimodal_tpu.train.schedules import (  # noqa: E402
    cosine_warm_restarts as j_schedule)
from camouflage_multimodal_tpu.train.state import (  # noqa: E402
    TrainState, apply_updates as j_apply_updates, make_adamw_tx)
from camouflage_multimodal_tpu.train.train_fusion import (  # noqa: E402
    FusionDataset as JDataset, FusionTrainer as JTrainer)
from camouflage_multimodal_tpu_torch import data as T_data  # noqa: E402
from camouflage_multimodal_tpu_torch.convert import (  # noqa: E402
    fusion_params_from_state_dict, fusion_state_dict)
from camouflage_multimodal_tpu_torch.models.fusion import (  # noqa: E402
    MultimodalCamouflageDetector as TDetector)
from camouflage_multimodal_tpu_torch.ops import attention as A  # noqa: E402
from camouflage_multimodal_tpu_torch.train import losses as T_losses  # noqa: E402
from camouflage_multimodal_tpu_torch.train.schedules import cosine_warm_restarts  # noqa: E402
from camouflage_multimodal_tpu_torch.train.state import (  # noqa: E402
    apply_updates, clip_by_global_norm_, make_adamw)
from camouflage_multimodal_tpu_torch.train.train_fusion import (  # noqa: E402
    FusionDataset, FusionTrainer, calculate_f1_score)

GRAD_TOL = dict(rtol=1e-4, atol=1e-4)
QUIET = dict(log_fn=lambda *_: None)


def t(x):
    return torch.from_numpy(np.array(x))


def _leaves(tree, prefix=""):
    if isinstance(tree, dict) or hasattr(tree, "items"):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    else:
        yield prefix, np.asarray(tree)


# ---------------------------------------------------------------------------
# Kernel B3's plain version
# ---------------------------------------------------------------------------

def _mha_case(seed=0, B=3, nq=32, nk=13, E=128):
    """Batch row 1 has masked keys, row 2 has every key masked."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, nq, E)).astype(np.float32)
    k = rng.standard_normal((B, nk, E)).astype(np.float32)
    v = rng.standard_normal((B, nk, E)).astype(np.float32)
    mask = np.arange(nk)[None, :] < np.array([[nk], [nk - 4], [0]])
    params = {n: np.asarray(p) for n, p in init_mha_params(jax.random.PRNGKey(1), E).items()}
    for n in ("bq", "bk", "bv", "bo"):
        params[n] = rng.standard_normal(E).astype(np.float32) * 0.1
    d_out = rng.standard_normal((B, nq, E)).astype(np.float32)
    d_probs = rng.standard_normal((B, nq, nk)).astype(np.float32)
    return params, q, k, v, mask, d_out, d_probs


def _reference_grads(reference, params, q, k, v, mask, d_out, d_probs, H):
    """(d_params, d_q, d_k, d_v) of <out, d_out> + <probs, d_probs>."""
    if reference == "autograd":
        leaves = [t(x).requires_grad_() for x in (q, k, v)]
        tp = {n: t(p).requires_grad_() for n, p in params.items()}
        out, probs = A.multihead_attention(tp, *leaves, H, t(mask))
        grads = torch.autograd.grad([out, probs], leaves + [tp[n] for n in A.PARAM_NAMES],
                                    [t(d_out), t(d_probs)])
        grads = [g.numpy() for g in grads]
        return dict(zip(A.PARAM_NAMES, grads[3:])), grads[0], grads[1], grads[2]

    jmask = jnp.asarray(mask)

    def loss(p, q_, k_, v_):
        if reference == "pallas":   # interpret mode off the TPU
            out, probs = pallas_multihead_attention_trainable(p, q_, k_, v_, H, jmask)
        else:
            out, probs = j_mha(p, q_, k_, v_, H, key_mask=jmask)
        return jnp.sum(out * d_out) + jnp.sum(probs * d_probs)

    gp, gq, gk, gv = jax.grad(loss, argnums=(0, 1, 2, 3))(
        {n: jnp.asarray(p) for n, p in params.items()}, jnp.asarray(q), jnp.asarray(k),
        jnp.asarray(v))
    return {n: np.asarray(g) for n, g in gp.items()}, np.asarray(gq), np.asarray(gk), np.asarray(gv)


@pytest.mark.parametrize("reference", ["autograd", "jnp", "pallas"])
def test_mha_plain_backward_matches(reference):
    """The written-out backward against torch.autograd of the plain forward,
    jax.grad of the JAX function and jax.grad through the Pallas custom VJP,
    with a live cotangent on the attention maps."""
    H = 8
    params, q, k, v, mask, d_out, d_probs = _mha_case()
    want_p, want_q, want_k, want_v = _reference_grads(reference, params, q, k, v, mask,
                                                      d_out, d_probs, H)
    d_params, d_q, d_k, d_v = A.multihead_attention_backward(
        {n: t(p) for n, p in params.items()}, t(q), t(k), t(v), H, t(mask), t(d_out), t(d_probs))
    for name, got, want in (("d_q", d_q, want_q), ("d_k", d_k, want_k), ("d_v", d_v, want_v)):
        np.testing.assert_allclose(got.numpy(), want, **GRAD_TOL, err_msg=name)
    for name in A.PARAM_NAMES:
        np.testing.assert_allclose(d_params[name].numpy(), want_p[name], **GRAD_TOL, err_msg=name)
    # A masked logit passes no gradient, also where every key is masked and
    # the probabilities are uniform: the key side of batch row 2 gets
    # nothing through the logits.
    only_logits = A.multihead_attention_backward(
        {n: t(p) for n, p in params.items()}, t(q), t(k), t(v), H, t(mask), None, t(d_probs))
    assert float(only_logits[2][2].abs().max()) == 0.0       # d_k of row 2
    assert float(only_logits[1][2].abs().max()) == 0.0       # d_q of row 2


def test_fused_mha_autograd_function_on_cpu():
    """``fused_mha`` under autograd goes through ``FusedMHA`` (plain forward
    and plain backward for CPU tensors): same gradients as autograd of the
    plain forward, with key and value one tensor, a missing cotangent for
    the maps and a strided ``d_out``; without grad it skips the Function."""
    H = 4
    params, q, k, _, mask, d_out, _ = _mha_case(seed=2, nq=20, E=64)
    tp = {n: t(p).requires_grad_() for n, p in params.items()}
    tq, tk = t(q).requires_grad_(), t(k).requires_grad_()
    weight = t(d_out).transpose(1, 2).contiguous().transpose(1, 2)    # strided
    assert not weight.is_contiguous()
    leaves = [tq, tk] + [tp[n] for n in A.PARAM_NAMES]

    out, probs = A.fused_mha(tp, tq, tk, tk, H, t(mask))
    assert out.grad_fn is not None and type(out.grad_fn).__name__ == "FusedMHABackward"
    got = torch.autograd.grad((out * weight).sum(), leaves)
    ref_out, _ = A.multihead_attention(tp, tq, tk, tk, H, t(mask))
    want = torch.autograd.grad((ref_out * weight).sum(), leaves)
    for name, a, b in zip(("d_q", "d_kv") + A.PARAM_NAMES, got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **GRAD_TOL, err_msg=name)
    with torch.no_grad():
        plain_out, _ = A.fused_mha(tp, tq, tk, tk, H, t(mask))
    assert plain_out.grad_fn is None
    np.testing.assert_array_equal(plain_out.numpy(), out.detach().numpy())


def test_attention_dropout():
    """Keep rate 1 − p, kept weights scaled by 1/(1 − p), pre-dropout
    probabilities returned, and the same generator seed → the same result."""
    H, rate = 4, 0.3
    params, q, k, v, mask, _, _ = _mha_case(seed=3, B=2, nq=64, nk=40, E=64)
    mask = np.ones_like(mask[:2])
    tp = {n: t(p) for n, p in params.items()}
    # Identity value/output projections expose the dropped attention matrix.
    tp["wv"], tp["wo"] = torch.eye(64), torch.eye(64)
    tp["bv"], tp["bo"] = torch.zeros(64), torch.zeros(64)
    base_out, base_p = A.multihead_attention(tp, t(q), t(k), t(v), H, t(mask))

    def run(seed):
        g = torch.Generator().manual_seed(seed)
        return A.multihead_attention(tp, t(q), t(k), t(v), H, t(mask),
                                     dropout_rate=rate, generator=g)

    out1, p1 = run(5)
    out2, p2 = run(5)
    out3, _ = run(6)
    assert torch.equal(out1, out2) and torch.equal(p1, p2)
    assert not torch.equal(out1, out3)
    np.testing.assert_array_equal(p1.numpy(), base_p.numpy())       # pre-dropout maps
    # Reproduce the draw: the same generator yields the same keep mask.
    g = torch.Generator().manual_seed(5)
    keep = torch.rand(2, H, 64, 40, generator=g) < 1.0 - rate
    assert abs(float(keep.float().mean()) - (1.0 - rate)) < 0.02
    _, _, vh, probs, _ = A._head_probs(tp, t(q), t(k), t(v), H, t(mask))
    want = A._merge_heads(torch.where(keep, probs / (1.0 - rate), 0.0) @ vh)
    np.testing.assert_allclose(out1.numpy(), want.numpy(), rtol=1e-6, atol=1e-6)
    assert not torch.allclose(out1, base_out)


# ---------------------------------------------------------------------------
# Losses, schedule, optimizer
# ---------------------------------------------------------------------------

def _loss_inputs(name):
    rng = np.random.default_rng(len(name))
    n = 37
    mask = rng.random(n) > 0.3
    if name in ("weighted_cross_entropy", "focal_loss"):
        return (rng.standard_normal((n, 2)).astype(np.float32) * 2,
                rng.integers(0, 2, n)), mask
    if name == "bce_with_logits":
        return (rng.standard_normal(n).astype(np.float32) * 2,
                rng.integers(0, 2, n).astype(np.float32)), mask
    return (rng.random(n).astype(np.float32), rng.random(n).astype(np.float32)), mask


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("name,kwargs", [
    ("weighted_cross_entropy", {"class_weights": [1.0, 2.5]}),
    ("weighted_cross_entropy", {}),
    ("bce_with_logits", {"pos_weight": 2.0}),
    ("focal_loss", {"alpha": 0.6, "gamma": 3.0}),
    ("mse", {}),
])
def test_losses_match_jax(name, kwargs, masked):
    (a, b), mask = _loss_inputs(name)
    want = getattr(j_losses, name)(jnp.asarray(a), jnp.asarray(b), **kwargs,
                                   mask=jnp.asarray(mask) if masked else None)
    got = getattr(T_losses, name)(t(a), t(b), **kwargs, mask=t(mask) if masked else None)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6, atol=1e-6)


def test_loss_terms_sum_to_the_reduced_losses():
    (logits, labels), _ = _loss_inputs("focal_loss")
    np.testing.assert_allclose(
        float(T_losses.focal_terms(t(logits), t(labels)).mean()),
        float(T_losses.focal_loss(t(logits), t(labels))), rtol=1e-6)
    (x, y), _ = _loss_inputs("bce_with_logits")
    np.testing.assert_allclose(float(T_losses.bce_terms(t(x), t(y)).mean()),
                               float(T_losses.bce_with_logits(t(x), t(y))), rtol=1e-6)


def test_cosine_warm_restarts_exact():
    for base in (5e-4, 1e-3):
        for epoch in range(70):
            assert cosine_warm_restarts(epoch, base) == j_schedule(epoch, base)
    assert cosine_warm_restarts(10, 1e-3) == 1e-3 and cosine_warm_restarts(30, 1e-3) == 1e-3


@pytest.mark.parametrize("steps", [1, 5])
def test_adamw_steps_match_optax(steps):
    """``apply_updates`` vs the JAX ``make_adamw_tx`` + ``apply_updates``
    with gradients large enough that the global-norm clip is active."""
    rng = np.random.default_rng(steps)
    shapes = {"w": (7, 5), "b": (5,), "s": (3, 4, 2)}
    params = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: (rng.standard_normal(s) * (3.0 if i % 2 == 0 else 0.05)).astype(np.float32)
              for k, s in shapes.items()} for i in range(steps)]
    lrs = [1e-2 * (i + 1) for i in range(steps)]

    tx = make_adamw_tx(weight_decay=1e-2)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    state = TrainState(params=jp, batch_stats={}, opt_state=tx.init(jp),
                       step=jnp.zeros((), jnp.int32))
    tparams = {k: torch.nn.Parameter(t(v)) for k, v in params.items()}
    opt = make_adamw(tparams.values(), weight_decay=1e-2)
    for g, lr in zip(grads, lrs):
        state = j_apply_updates(tx, state, {k: jnp.asarray(v) for k, v in g.items()},
                                jnp.asarray(lr, jnp.float32))
        for k, p in tparams.items():
            p.grad = t(g[k])
        apply_updates(opt, lr)
        assert all(p.grad is None for p in tparams.values())
    for k in shapes:
        np.testing.assert_allclose(tparams[k].detach().numpy(), np.asarray(state.params[k]),
                                   rtol=1e-6, atol=1e-6, err_msg=k)


def test_clip_by_global_norm_divides_by_the_norm():
    g = [torch.full((4,), 3.0), torch.full((9,), -2.0)]
    norm = clip_by_global_norm_(g, 1.0)
    np.testing.assert_allclose(float(norm), np.sqrt(4 * 9 + 9 * 4), rtol=1e-6)
    total = torch.sqrt(sum((x ** 2).sum() for x in g))
    np.testing.assert_allclose(float(total), 1.0, rtol=1e-6)
    small = [torch.full((4,), 0.1)]
    clip_by_global_norm_(small, 1.0)
    assert torch.equal(small[0], torch.full((4,), 0.1))


# ---------------------------------------------------------------------------
# Dataset and labels
# ---------------------------------------------------------------------------

def _records(seed, n=24, nodes=16, nkg=4, ragged=False, separable=True):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        label = i % 2 if i % 5 else 1          # class 1 is the majority
        k = nodes - (i % 3) if ragged else nodes
        base = np.full((k, 128), 2.0 * label - 1.0 if separable else 0.0, np.float32)
        out.append({
            "image_name": f"x{i}.jpg",
            "rg_node_embeddings": base + rng.standard_normal((k, 128)).astype(np.float32) * 0.1,
            "kg_embeddings": rng.standard_normal((nkg, 128)).astype(np.float32),
            "label": label, "confidence": float(0.5 + 0.5 * rng.random()),
            "edge_label": float(label), "score_label": float(rng.random()),
        })
    return out


def test_fusion_dataset_equals_jax_dataset():
    """Collate with numpy-RNG augmentation, both weight schemes, the bucket
    rule and the truncation accounting: bit-equal to the JAX class."""
    recs = _records(1, ragged=True)
    recs[3]["rg_node_embeddings"] = np.ones((21, 128), np.float32)       # overflows 16
    t_msgs, j_msgs = [], []
    tds = FusionDataset.from_samples(recs, max_rg_nodes=16, augment=True, seed=4,
                                     log_fn=t_msgs.append)
    jds = JDataset.from_samples(recs, max_rg_nodes=16, augment=True, seed=4,
                                log_fn=j_msgs.append)
    for idx in ([0, 3, 5, 7], [3, 2], list(range(24))):
        got, want = tds.collate(idx), jds.collate(idx)
        assert list(got) == list(want)
        for key in want:
            assert got[key].dtype == want[key].dtype
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    assert (tds.truncated_nodes, tds.truncated_samples) == (jds.truncated_nodes,
                                                            jds.truncated_samples) == (15, 3)
    assert t_msgs == j_msgs and len(t_msgs) == 1
    assert tds.get_aggressive_sample_weights() == jds.get_aggressive_sample_weights()
    assert tds.get_balanced_sample_weights() == jds.get_balanced_sample_weights()
    assert len(tds) == 24 and tds.get_labels() == jds.get_labels()
    for bucket in (None, 576):
        assert (FusionDataset.from_samples(recs, max_rg_nodes=bucket).max_rg_nodes
                == JDataset.from_samples(recs, max_rg_nodes=bucket).max_rg_nodes)
    assert FusionDataset.from_samples(recs, max_rg_nodes=None).max_rg_nodes == 64


def _gt_masks():
    rng = np.random.default_rng(9)
    yy, xx = np.mgrid[:96, :96]
    blob = (((yy - 48) ** 2 + (xx - 40) ** 2) < 30 ** 2).astype(np.uint8) * 255
    specks = (rng.random((96, 96)) > 0.93).astype(np.uint8) * 255
    faint = (blob // 255 * 60).astype(np.uint8)
    return {"empty": np.zeros((96, 96), np.uint8), "blob": blob, "specks": specks,
            "faint": faint, "both": np.maximum(blob, specks)}


@pytest.mark.parametrize("name", ["empty", "blob", "specks", "faint", "both"])
def test_extract_label_from_mask_matches_jax(name, tmp_path):
    from PIL import Image

    mask = _gt_masks()[name]
    assert T_data.extract_label_from_mask(mask) == j_labels.extract_label_from_mask(mask)
    p = str(tmp_path / "m.png")
    Image.fromarray(mask).save(p)
    assert T_data.extract_label_from_mask(p) == j_labels.extract_label_from_mask(p)
    assert T_data.extract_label_from_mask(str(tmp_path / "missing.png")) == (0, 0.0)


def test_mask_stats_without_cv2_match_the_jax_fallback(monkeypatch):
    """With cv2 unimportable the port uses its own Canny and a scipy
    component count, as the JAX package's fallback does."""
    monkeypatch.setitem(sys.modules, "cv2", None)
    for name in ("blob", "specks"):
        mask = _gt_masks()[name]
        edge_ratio, complexity = T_data._mask_stats(mask)
        want_ratio, want_complexity = j_labels._stats_fallback(mask)
        assert complexity == want_complexity
        np.testing.assert_allclose(edge_ratio, float(want_ratio), atol=2e-3)


def test_fusion_dataset_from_gt_files_matches_jax(tmp_path):
    """The file-scanning constructor: samples without all three GT files are
    dropped, labels come from the mask heuristic."""
    from PIL import Image

    dirs = {k: tmp_path / k for k in ("mask", "instance", "edge")}
    for d in dirs.values():
        d.mkdir()
    masks = _gt_masks()
    recs = _records(2, n=3)
    for rec, name in zip(recs, ("blob", "empty", "specks")):
        base = os.path.splitext(rec["image_name"])[0]
        for kind, d in dirs.items():
            if kind == "edge" and name == "specks":
                continue                         # incomplete sample
            Image.fromarray(masks[name]).save(str(d / f"{base}.png"))
    args = ([{k: r[k] for k in ("image_name", "rg_node_embeddings", "kg_embeddings")}
             for r in recs], str(dirs["mask"]), str(dirs["instance"]), str(dirs["edge"]))
    tds, jds = FusionDataset(*args, **QUIET), JDataset(*args, **QUIET)
    assert len(tds) == len(jds) == 2 and tds.max_rg_nodes == jds.max_rg_nodes == 576
    for a, b in zip(tds.samples, jds.samples):
        for key in ("label", "confidence", "edge_label", "score_label"):
            assert a[key] == b[key], key


def test_f1_score_matches_jax():
    from camouflage_multimodal_tpu.train.train_fusion import calculate_f1_score as j_f1

    rng = np.random.default_rng(0)
    p, y = rng.integers(0, 2, 50), rng.integers(0, 2, 50)
    assert calculate_f1_score(p, y) == j_f1(p, y)


# ---------------------------------------------------------------------------
# Model paths the trainer needs
# ---------------------------------------------------------------------------

def _jax_and_port(rg, kg, **cfg):
    jmodel = JDetector(rg_dim=rg.shape[-1], kg_dim=kg.shape[-1], hidden_dim=64, num_heads=4, **cfg)
    params = jmodel.init(jax.random.PRNGKey(3), jnp.asarray(rg), jnp.asarray(kg))["params"]
    rng = np.random.default_rng(5)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.05 * rng.standard_normal(a.shape).astype(np.float32), params)
    tmodel = TDetector(rg_dim=rg.shape[-1], kg_dim=kg.shape[-1], hidden_dim=64, num_heads=4, **cfg)
    tmodel.load_state_dict(fusion_state_dict(params))
    return jmodel, params, tmodel


def _compare_outputs(got, ref, tol):
    for key in ("mask_logits", "instance_logits", "edge_logits", "score"):
        np.testing.assert_allclose(got[key].detach().numpy(), np.asarray(ref[key]),
                                   rtol=tol, atol=tol, err_msg=key)


@pytest.mark.parametrize("use_pallas", [True, False])
def test_fusion_train_mode_without_dropout_matches_jax(use_pallas):
    """``train=True`` with dropout 0: through the fused path (``FusedMHA``
    here, the Pallas custom VJP there) and through the plain one."""
    rng = np.random.default_rng(6)
    rg = rng.standard_normal((2, 24, 32)).astype(np.float32)
    kg = rng.standard_normal((2, 13, 32)).astype(np.float32)
    rg_mask = np.arange(24)[None] < np.array([[24], [10]])
    jmodel, params, tmodel = _jax_and_port(rg, kg, dropout=0.0, use_pallas=use_pallas)
    ref = jmodel.apply({"params": params}, jnp.asarray(rg), jnp.asarray(kg),
                       rg_mask=jnp.asarray(rg_mask), train=True, return_attention=True,
                       rngs={"dropout": jax.random.PRNGKey(0)})
    got = tmodel.train()(t(rg), t(kg), rg_mask=t(rg_mask), return_attention=True)
    _compare_outputs(got, ref, 1e-4)
    for key in ("rg2kg", "kg2rg"):
        np.testing.assert_allclose(got["attention"][key].detach().numpy(),
                                   np.asarray(ref["attention"][key]), rtol=1e-3, atol=2e-3)
    assert (type(got["attention"]["rg2kg"].grad_fn).__name__ == "FusedMHABackward") == use_pallas


def test_model_dropout_draws_from_its_generator():
    """Train mode with dropout 0.3 takes the plain attention (no ``FusedMHA``
    even with ``use_pallas``), eval mode is deterministic, and the generator
    given to ``set_generator`` decides every draw."""
    rng = np.random.default_rng(7)
    rg = rng.standard_normal((2, 24, 32)).astype(np.float32)
    kg = rng.standard_normal((2, 13, 32)).astype(np.float32)
    _, _, tmodel = _jax_and_port(rg, kg, dropout=0.3, use_pallas=True)

    def run(seed):
        tmodel.set_generator(torch.Generator().manual_seed(seed))
        return tmodel(t(rg), t(kg), return_attention=True)

    tmodel.train()
    a, b, c = run(1), run(1), run(2)
    assert torch.equal(a["mask_logits"], b["mask_logits"])
    assert not torch.equal(a["mask_logits"], c["mask_logits"])
    assert type(a["attention"]["rg2kg"].grad_fn).__name__ != "FusedMHABackward"
    tmodel.eval()
    with torch.no_grad():
        assert torch.equal(run(1)["mask_logits"], run(2)["mask_logits"])


@pytest.mark.parametrize("rg_shape,kg_shape", [
    ((3, 32), (3, 32)),                    # 2-D: one token per sample
    ((3, 1, 10, 32), (3, 13, 32)),         # 4-D, singleton second axis
    ((3, 10, 1, 32), (3, 13, 1, 32)),      # 4-D, singleton third axis
    ((3, 4, 5, 32), (3, 13, 32)),          # 4-D, merged
])
def test_fusion_collapses_2d_and_4d_inputs_like_jax(rg_shape, kg_shape):
    rng = np.random.default_rng(sum(rg_shape))
    rg = rng.standard_normal(rg_shape).astype(np.float32)
    kg = rng.standard_normal(kg_shape).astype(np.float32)
    jmodel, params, tmodel = _jax_and_port(rg, kg)
    ref = jmodel.apply({"params": params}, jnp.asarray(rg), jnp.asarray(kg))
    with torch.no_grad():
        got = tmodel.eval()(t(rg), t(kg))
    _compare_outputs(got, ref, 1e-5)


@pytest.mark.parametrize("rg_shape,kg_shape,masked", [
    ((3, 20, 32), (3, 13, 48), True), ((3, 20, 32), (3, 13, 48), False),
    ((3, 32), (3, 48), False),
])
def test_late_fusion_matches_jax(rg_shape, kg_shape, masked):
    rng = np.random.default_rng(8)
    rg = rng.standard_normal(rg_shape).astype(np.float32)
    kg = rng.standard_normal(kg_shape).astype(np.float32)
    rg_mask = np.arange(20)[None] < np.array([[20], [7], [1]]) if masked else None
    jmodel, params, tmodel = _jax_and_port(rg, kg, fusion_type="late")
    ref = jmodel.apply({"params": params}, jnp.asarray(rg), jnp.asarray(kg),
                       rg_mask=None if rg_mask is None else jnp.asarray(rg_mask),
                       return_attention=True)
    with torch.no_grad():
        got = tmodel.eval()(t(rg), t(kg), rg_mask=None if rg_mask is None else t(rg_mask),
                            return_attention=True)
    _compare_outputs(got, ref, 1e-5)
    assert got["attention"] is None and ref["attention"] is None
    assert got["mask_logits"].shape == (3, 2)
    # The reverse map gives back the JAX tree, late-fusion keys included.
    back = dict(_leaves(fusion_params_from_state_dict(tmodel.state_dict())))
    want = dict(_leaves(params))
    assert set(back) == set(want)
    for key in want:
        np.testing.assert_array_equal(back[key], want[key], err_msg=key)
    with pytest.raises(ValueError, match="Unknown fusion_type"):
        TDetector(fusion_type="sum")


# ---------------------------------------------------------------------------
# The slice as a whole: FusionTrainer
# ---------------------------------------------------------------------------

SMALL = {"hidden_dim": 64, "num_heads": 4, "dropout": 0.0, "use_pallas": True}


def test_fusion_trainer_matches_jax_trainer():
    """JAX ``FusionTrainer._fit_loop`` vs the port's host-loop ``fit`` from
    the same initial parameters (carried over by ``convert``), the same
    split, sampling and numpy augmentation: per-epoch losses within 1e-3
    relative (7e-6 seen), the same predictions (equal F1 and accuracy
    histories), final parameters within 1e-3 (5e-6 seen; 5e-5 for the key
    bias ``bk``, whose exact gradient is zero — a shift of all keys leaves
    the softmax unchanged — so Adam's normalisation amplifies each side's
    float32 rounding of that zero)."""
    recs = _records(11, ragged=True)
    epochs, batch, lr = 2, 4, 5e-4
    jtrainer = JTrainer(model_config=SMALL, learning_rate=lr)
    init = jtrainer.init_state(jax.random.PRNGKey(0), rg_dim=128, n_kg=4, max_rg_nodes=16)
    jstate, jhist = jtrainer._fit_loop(
        JDataset.from_samples(recs, max_rg_nodes=16, augment=True, **QUIET),
        epochs=epochs, batch_size=batch, seed=0, **QUIET)

    model = TDetector(hidden_dim=64, num_heads=4, dropout=0.0, use_pallas=True)
    model.load_state_dict(fusion_state_dict(init.params))
    trainer = FusionTrainer(model=model, learning_rate=lr)
    _, hist = trainer.fit(
        FusionDataset.from_samples(recs, max_rg_nodes=16, augment=True, **QUIET),
        epochs=epochs, batch_size=batch, seed=0, device="cpu", **QUIET)

    assert set(hist) == set(jhist)
    for key in ("train_loss", "val_loss"):
        np.testing.assert_allclose(hist[key], jhist[key], rtol=1e-3, err_msg=key)
    for key in hist:
        if key not in ("train_loss", "val_loss"):
            assert hist[key] == pytest.approx(jhist[key], abs=1e-12), key
    got = dict(_leaves(fusion_params_from_state_dict(model.state_dict())))
    want = dict(_leaves(jstate.params))
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=0, atol=1e-3, err_msg=key)


def test_device_resident_epochs_learn_separable_data():
    """The counterpart of the JAX scan epochs (tests/test_train.py:213-237):
    mechanics and learning, with on-device augmentation."""
    recs = _records(12, n=32)
    ds = FusionDataset.from_samples(recs, max_rg_nodes=16, augment=True)
    state_before = ds.rng.bit_generator.state
    trainer = FusionTrainer(model_config={"hidden_dim": 64, "num_heads": 4}, learning_rate=1e-3)
    _, history = trainer.fit(ds, epochs=6, batch_size=8, device_resident=True, device="cpu",
                             **QUIET)
    assert len(history["train_loss"]) == 6
    assert history["train_loss"][-1] < history["train_loss"][0]
    assert history["val_f1_avg"][-1] > 0.8
    assert ds.rng.bit_generator.state == state_before      # host RNG left alone
    assert ds.augment is True


@pytest.mark.parametrize("device_resident", [True, False])
def test_fusion_trainer_resume_bitmatch(tmp_path, device_resident):
    """A run resumed from its snapshot bit-matches an uninterrupted one
    (with dropout and augmentation on, so both generators matter)."""
    recs = _records(13, n=16, nodes=8, separable=False)
    cfg = {"hidden_dim": 32, "num_heads": 4, "dropout": 0.2}
    kw = dict(batch_size=4, device_resident=device_resident, device="cpu", **QUIET)
    resume = str(tmp_path / "resume.ckpt")

    def dataset():
        return FusionDataset.from_samples(recs, max_rg_nodes=8, augment=True)

    full_model, full_hist = FusionTrainer(model_config=cfg).fit(dataset(), epochs=4, **kw)
    FusionTrainer(model_config=cfg).fit(dataset(), epochs=2, resume_path=resume, **kw)
    cont_model, cont_hist = FusionTrainer(model_config=cfg).fit(
        dataset(), epochs=4, resume_from=resume, **kw)

    assert cont_hist == full_hist
    for (k, a), b in zip(full_model.state_dict().items(), cont_model.state_dict().values()):
        assert torch.equal(a, b), k


def test_port_trained_checkpoint_loads_in_the_jax_package(tmp_path):
    """The best checkpoint and the history file of a port run; the JAX
    package's ``load_multimodal_model`` reads the checkpoint and its model
    gives the port's logits at 1e-4; the port's own loader reads it too."""
    from camouflage_multimodal_tpu_torch.api import load_multimodal_model

    recs = _records(14)
    ds = FusionDataset.from_samples(recs, max_rg_nodes=16)
    trainer = FusionTrainer(model_config=SMALL, learning_rate=1e-3)
    model, history = trainer.fit(ds, epochs=2, batch_size=4, device="cpu",
                                 checkpoint_dir=str(tmp_path), max_patience=1, **QUIET)
    ckpt = str(tmp_path / "multimodal_best_fixed.ckpt")
    with open(tmp_path / "training_history_fixed.json") as f:
        assert json.load(f) == history
    best = int(np.argmax(history["val_f1_class_1"]))

    jmodel, variables, config = j_load_multimodal(ckpt)
    assert config == {"model": SMALL} and jmodel.hidden_dim == 64 and jmodel.use_pallas
    batch = ds.collate([0, 1, 2, 3, 4])
    ref = jmodel.apply(variables, jnp.asarray(batch["rg"]), jnp.asarray(batch["kg"]),
                       rg_mask=jnp.asarray(batch["rg_mask"]))
    loaded, port_config = load_multimodal_model(ckpt, device="cpu")
    assert port_config == config
    with torch.no_grad():
        got = loaded(t(batch["rg"]), t(batch["kg"]), rg_mask=t(batch["rg_mask"]))
        if best == len(history["val_loss"]) - 1:           # saved at the last epoch
            now = model.eval()(t(batch["rg"]), t(batch["kg"]), rg_mask=t(batch["rg_mask"]))
            assert torch.equal(now["mask_logits"], got["mask_logits"])
    _compare_outputs(got, ref, 1e-4)

    from camouflage_multimodal_tpu_torch.core.checkpoint import load_checkpoint
    blob = load_checkpoint(ckpt)
    assert blob["epoch"] == best and blob["opt_state"]["step"] > 0
    assert set(dict(_leaves(blob["opt_state"]["mu"]))) == set(dict(_leaves(blob["params"])))


def test_fit_refuses_a_mesh_and_a_missing_card():
    """``mesh=`` takes only a ``parallel.sharding.make_mesh`` mesh, a batch
    that does not divide over its data axis raises the JAX ``ValueError``
    (on a two-rank mesh of torch's fake backend), and ``cuda`` raises
    without a card. Data-parallel fits themselves are held in
    tests/test_torch_port_parallel.py."""
    from test_torch_port_parallel import fake_mesh

    ds = FusionDataset.from_samples(_records(15, n=8), max_rg_nodes=16)
    trainer = FusionTrainer(model_config=SMALL)
    with pytest.raises(TypeError, match="DeviceMesh"):
        trainer.fit(ds, epochs=1, mesh=object(), device="cpu", **QUIET)
    with fake_mesh(2) as mesh:
        with pytest.raises(ValueError, match="not divisible by the mesh's data axis"):
            trainer.fit(ds, epochs=1, batch_size=3, mesh=mesh, device="cpu", **QUIET)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="is_available"):
            trainer.fit(ds, epochs=1, **QUIET)
