"""Parity of the PyTorch port's attention, GNN and fusion models with the
JAX package, with weights carried over by ``convert``, on the CPU.

Random inputs come from numpy with a seed; JAX ``init`` makes the random
weights, the committed checkpoints the trained ones.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

jax.config.update("jax_platforms", "cpu")

from camouflage_multimodal_tpu.core.checkpoint import load_checkpoint as j_load  # noqa: E402
from camouflage_multimodal_tpu.models.fusion import (  # noqa: E402
    MultimodalCamouflageDetector as JDetector)
from camouflage_multimodal_tpu.models.region_graph import RegionGraphGNN as JGNN  # noqa: E402
from camouflage_multimodal_tpu.ops.attention import (  # noqa: E402
    init_mha_params, multihead_attention as j_mha)
from camouflage_multimodal_tpu.ops.pallas_attention import (  # noqa: E402
    pallas_multihead_attention)
from camouflage_multimodal_tpu_torch.api import (  # noqa: E402
    load_multimodal_model, load_rg_model)
from camouflage_multimodal_tpu_torch.convert import (  # noqa: E402
    fusion_state_dict, region_graph_state_dict)
from camouflage_multimodal_tpu_torch.models.fusion import (  # noqa: E402
    MultimodalCamouflageDetector as TDetector)
from camouflage_multimodal_tpu_torch.models.region_graph import RegionGraphGNN as TGNN  # noqa: E402
from camouflage_multimodal_tpu_torch.ops.attention import fused_mha  # noqa: E402

RG_CKPT = "artifacts/rg_model.ckpt"
FUSION_CKPT = "artifacts/checkpoints_balanced/multimodal_best_fixed.ckpt"

# Logits / outputs at 1e-4 and attention probabilities at rtol 1e-3 / atol
# 2e-3: the JAX package's own bar between its two attention paths
# (tests/test_pallas.py:30-33) — float32 matmuls summed in another order.
OUT_TOL = dict(rtol=1e-4, atol=1e-4)
PROB_TOL = dict(rtol=1e-3, atol=2e-3)
# RegionGraphGNN outputs: the bar of tests/test_torch_compat.py:34.
GNN_TOL = dict(rtol=2e-4, atol=2e-5)


def t(x):
    return torch.from_numpy(np.array(x))


def _tree_to_torch(tree):
    return {k: t(v) for k, v in tree.items()}


# ---------------------------------------------------------------------------
# Kernel B2's plain version
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("nq,nk", [(640, 13), (13, 640)])
def test_mha_plain_matches_jax_and_pallas(nq, nk):
    """Both main-path directions (rg2kg: 640 queries × 13 keys; kg2rg: 13 ×
    640 under the RG node mask), with partial masks and one batch row whose
    keys are ALL masked (−1e30 logits → uniform weights on both sides)."""
    rng = np.random.default_rng(nq)
    B, E, H = 3, 256, 8
    q = rng.standard_normal((B, nq, E)).astype(np.float32)
    k = rng.standard_normal((B, nk, E)).astype(np.float32)
    mask = np.arange(nk)[None, :] < np.array([[nk - 3], [nk], [0]])
    params = {n: np.asarray(v) for n, v in init_mha_params(jax.random.PRNGKey(0), E).items()}
    params["bq"] = rng.standard_normal(E).astype(np.float32) * 0.1
    params["bo"] = rng.standard_normal(E).astype(np.float32) * 0.1
    jp = {n: jnp.asarray(v) for n, v in params.items()}

    got_out, got_p = fused_mha(_tree_to_torch(params), t(q), t(k), t(k), H, t(mask))
    for name, fn in (("jnp", lambda: j_mha(jp, jnp.asarray(q), jnp.asarray(k),
                                           jnp.asarray(k), H, key_mask=jnp.asarray(mask))),
                     ("pallas", lambda: pallas_multihead_attention(
                         jp, jnp.asarray(q), jnp.asarray(k), jnp.asarray(k), H,
                         jnp.asarray(mask), interpret=True))):
        ref_out, ref_p = fn()
        np.testing.assert_allclose(got_out.numpy(), np.asarray(ref_out), **OUT_TOL,
                                   err_msg=name)
        np.testing.assert_allclose(got_p.numpy(), np.asarray(ref_p), **PROB_TOL,
                                   err_msg=name)
    np.testing.assert_allclose(got_p[2].numpy(), 1.0 / nk, rtol=1e-6)


def test_fused_mha_refuses_unknown_devices():
    x = torch.zeros(1, 2, 8, device="meta")
    params = {n: torch.zeros((8, 8) if n[0] == "w" else (8,), device="meta")
              for n in ("wq", "bq", "wk", "bk", "wv", "bv", "wo", "bo")}
    with pytest.raises(ValueError, match="unsupported device"):
        fused_mha(params, x, x, x, 2)


# ---------------------------------------------------------------------------
# RegionGraphGNN
# ---------------------------------------------------------------------------

def _graph_batch(rng, B, K, n_valid):
    x = rng.standard_normal((B, K, 15)).astype(np.float32)
    mask = np.arange(K)[None, :] < np.asarray(n_valid)[:, None]
    a = rng.random((B, K, K)) < 0.08
    adj = (a | a.transpose(0, 2, 1)) & mask[:, None, :] & mask[:, :, None]
    adj &= ~np.eye(K, dtype=bool)
    w = np.where(adj, rng.random((B, K, K)), 0).astype(np.float32)
    w = (w + w.transpose(0, 2, 1)) / 2
    x = np.where(mask[..., None], x, 0).astype(np.float32)
    return x, adj, w, mask


def _gnn_parity(jmodel, variables, tmodel, x, adj, w, mask):
    ref = jmodel.apply(variables, jnp.asarray(x), jnp.asarray(adj), jnp.asarray(w),
                       jnp.asarray(mask))
    with torch.no_grad():
        got = tmodel(t(x), t(adj), t(w), t(mask))
    assert set(got) == set(ref)
    for key in ref:
        np.testing.assert_allclose(got[key].numpy(), np.asarray(ref[key]), **GNN_TOL,
                                   err_msg=key)


def test_region_graph_gnn_carry_over_small():
    """JAX init (hidden 32) → convert → port; batch stats perturbed so the
    running-statistics path is exercised."""
    rng = np.random.default_rng(4)
    x, adj, w, mask = _graph_batch(rng, 2, 48, [48, 30])
    jmodel = JGNN(hidden_channels=32)
    variables = jmodel.init(jax.random.PRNGKey(1), jnp.asarray(x), jnp.asarray(adj),
                            jnp.asarray(w), jnp.asarray(mask))
    bs = jax.tree_util.tree_map(
        lambda a: np.abs(np.asarray(a) + rng.standard_normal(a.shape).astype(np.float32)),
        variables["batch_stats"])
    variables = {"params": variables["params"], "batch_stats": bs}
    tmodel = TGNN(hidden_channels=32).eval()
    tmodel.load_state_dict(region_graph_state_dict(variables["params"], bs))
    _gnn_parity(jmodel, variables, tmodel, x, adj, w, mask)


def test_region_graph_gnn_committed_checkpoint():
    """The committed full-width checkpoint (GAT 15→4×128, 3× GCN 128),
    loaded by the port's own ``.ckpt`` reader, on a 640-node bucket."""
    rng = np.random.default_rng(5)
    x, adj, w, mask = _graph_batch(rng, 2, 640, [560, 500])
    x[..., :6] = np.abs(x[..., :6]) * 0.2        # feature-like magnitudes
    ck = j_load(RG_CKPT)
    variables = {"params": ck["params"], "batch_stats": ck["batch_stats"]}
    tmodel = load_rg_model(RG_CKPT, device="cpu")
    _gnn_parity(JGNN(), variables, tmodel, x, adj, w, mask)


# ---------------------------------------------------------------------------
# MultimodalCamouflageDetector
# ---------------------------------------------------------------------------

def _fusion_parity(jmodel, params, tmodel, rg, kg, rg_mask):
    ref = jmodel.apply({"params": params}, jnp.asarray(rg), jnp.asarray(kg),
                       rg_mask=jnp.asarray(rg_mask), return_attention=True)
    with torch.no_grad():
        got = tmodel(t(rg), t(kg), rg_mask=t(rg_mask), return_attention=True)
    for key in ("mask_logits", "instance_logits", "edge_logits", "score"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(ref[key]), **OUT_TOL,
                                   err_msg=key)
    for key in ("rg2kg", "kg2rg"):
        np.testing.assert_allclose(got["attention"][key].numpy(),
                                   np.asarray(ref["attention"][key]), **PROB_TOL,
                                   err_msg=key)


def test_fusion_carry_over_small():
    """JAX init (hidden 64, 4 heads, rg/kg dim 32) → convert → port."""
    rng = np.random.default_rng(6)
    B, N, Nkg = 2, 96, 13
    rg = rng.standard_normal((B, N, 32)).astype(np.float32)
    kg = rng.standard_normal((B, Nkg, 32)).astype(np.float32)
    rg_mask = np.arange(N)[None] < np.array([[96], [40]])
    jmodel = JDetector(rg_dim=32, kg_dim=32, hidden_dim=64, num_heads=4)
    params = jmodel.init(jax.random.PRNGKey(2), jnp.asarray(rg), jnp.asarray(kg),
                         rg_mask=jnp.asarray(rg_mask))["params"]
    params = jax.tree_util.tree_map(          # non-zero biases and LayerNorm affine
        lambda a: np.asarray(a) + 0.05 * rng.standard_normal(a.shape).astype(np.float32),
        params)
    tmodel = TDetector(rg_dim=32, kg_dim=32, hidden_dim=64, num_heads=4).eval()
    tmodel.load_state_dict(fusion_state_dict(params))
    _fusion_parity(jmodel, params, tmodel, rg, kg, rg_mask)


def test_fusion_committed_checkpoint():
    """The committed cross-attention checkpoint (hidden 256, 8 heads, rg/kg
    128) on node embeddings shaped like the main path's (640-node bucket,
    13 KG categories)."""
    rng = np.random.default_rng(7)
    rg = np.maximum(rng.standard_normal((2, 640, 128)), 0).astype(np.float32)
    kg = rng.standard_normal((2, 13, 128)).astype(np.float32) * 0.3
    rg_mask = np.arange(640)[None] < np.array([[530], [470]])
    rg = np.where(rg_mask[..., None], rg, 0).astype(np.float32)
    tmodel, config = load_multimodal_model(FUSION_CKPT, device="cpu")
    assert config["model"]["hidden_dim"] == 256
    _fusion_parity(JDetector(), j_load(FUSION_CKPT)["params"], tmodel, rg, kg, rg_mask)
