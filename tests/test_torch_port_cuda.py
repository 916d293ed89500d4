"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: without a CUDA device every test here skips. Run on a
machine with an NVIDIA GPU (sm_90a) and the CUDA toolkit with

    python -m pytest tests/test_torch_port_cuda.py -m cuda --noconftest -q

(``--noconftest``: the suite's conftest imports JAX, which such a machine
need not have; these tests import only the port.)
"""

import os

import numpy as np
import pytest
import torch

from camouflage_multimodal_tpu_torch.core import kernels
from camouflage_multimodal_tpu_torch.ops import attention as A
from camouflage_multimodal_tpu_torch.ops import slic as S

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _images(dev, n, size, seed):
    g = torch.Generator().manual_seed(seed)
    base = torch.rand(n, 1, 1, 3, generator=g)
    yy = torch.linspace(0, 1, size)[:, None, None]
    xx = torch.linspace(0, 1, size)[None, :, None]
    img = base + 0.3 * torch.sin(9 * yy + 5 * xx * torch.rand(3, generator=g))
    img = img + 0.05 * torch.randn(n, size, size, 3, generator=g)
    return img.clamp(0, 1).to(dev)


@pytest.mark.parametrize("size,n_segments,iters", [(96, 60, 0), (256, 500, 4), (200, 300, 2)])
def test_slic_assign_kernel_equals_plain(dev, size, n_segments, iters):
    """Same float32 operations in the same order: labels bit-equal."""
    pix, centers, step, ratio = S.slic_features(_images(dev, 2, size, size), n_segments)
    labels = torch.zeros(pix.shape[:2], dtype=torch.int32, device=dev)
    for _ in range(iters):
        labels = S.slic_assign_plain(pix, centers, labels, ratio, step)
        centers = S.update_centers(pix, labels, centers)
    before = kernels.LAUNCHES["slic_assign"]
    got = S.slic_assign(pix, centers, labels, ratio, step)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["slic_assign"] == before + 1
    want = S.slic_assign_plain(pix, centers, labels, ratio, step)
    assert torch.equal(got, want)


@pytest.mark.parametrize("iters", [0, 5])
def test_slic_assign_build_batch_equals_plain(dev, iters):
    """The RG graph build's shape, 16 images of 256² against K = 529 with the
    image width given: labels bit-equal."""
    pix, centers, step, ratio = S.slic_features(_images(dev, 16, 256, 256), 500)
    assert pix.shape == (16, 256 * 256, 5) and centers.shape[1] == 529
    labels = torch.zeros(pix.shape[:2], dtype=torch.int32, device=dev)
    for _ in range(iters):
        labels = S.slic_assign_plain(pix, centers, labels, ratio, step)
        centers = S.update_centers(pix, labels, centers)
    got = S.slic_assign(pix, centers, labels, ratio, step, width=256)
    torch.cuda.synchronize()
    assert torch.equal(got, S.slic_assign_plain(pix, centers, labels, ratio, step))


def _center_case(case, centers, step, height, width, dev):
    """Center states that stress the per-tile candidate lists of B1."""
    c = centers.clone()
    g = torch.Generator(device=dev).manual_seed(3)
    if case == "jitter":
        c[..., 3:] += (torch.rand(c[..., 3:].shape, generator=g, device=dev) - 0.5) * 2 * step
    elif case == "collapsed":       # every center inside one tile: the list holds all K
        c[..., 3] = 20.0 + 9.0 * torch.rand(c.shape[:2], generator=g, device=dev)
        c[..., 4] = 36.0 + 9.0 * torch.rand(c.shape[:2], generator=g, device=dev)
    elif case == "outside":         # half of the centers pushed off the image
        off = torch.rand(c.shape[:2], generator=g, device=dev) < 0.5
        c[..., 3] = torch.where(off, c[..., 3] - height - 3.5 * step, c[..., 3])
        c[..., 4] = torch.where(~off, c[..., 4] + width + 0.5 * step, c[..., 4])
    return c.contiguous()


@pytest.mark.parametrize("tile_width", [16, 32, 256])
@pytest.mark.parametrize("height,width,n_segments,case", [
    (256, 256, 500, "seed"), (256, 256, 500, "jitter"), (256, 256, 500, "collapsed"),
    (256, 256, 500, "outside"), (97, 131, 60, "jitter"), (97, 131, 60, "collapsed"),
    (352, 352, 500, "jitter"), (416, 416, 500, "jitter")])
def test_slic_assign_tiles_equal_plain(dev, monkeypatch, height, width, n_segments, case,
                                       tile_width):
    """The tiled kernel with the image width given: bit-equal labels for
    seeded, jittered, collapsed and out-of-image centers, square and ragged
    images, at every tile shape."""
    monkeypatch.setattr(S, "TILE_WIDTH", tile_width)
    g = torch.Generator().manual_seed(height)
    imgs = torch.rand(2, height, width, 3, generator=g).to(dev)
    pix, centers, step, ratio = S.slic_features(imgs, n_segments)
    centers = _center_case(case, centers, step, height, width, dev)
    prev = torch.randint(0, centers.shape[1], pix.shape[:2], generator=g).int().to(dev)
    got = S.slic_assign(pix, centers, prev, ratio, step, width=width)
    torch.cuda.synchronize()
    want = S.slic_assign_plain(pix, centers, prev, ratio, step)
    assert torch.equal(got, want)
    assert torch.equal(S.slic_assign(pix, centers, prev, ratio, step), want)   # no width


@pytest.mark.parametrize("nq,nk,e,heads", [(576, 13, 256, 8), (13, 576, 256, 8),
                                           (37, 75, 256, 8), (5, 32, 64, 4), (3, 33, 32, 8)])
def test_fused_mha_kernel_repeats_bit_equal(dev, nq, nk, e, heads):
    """Training shapes, a ragged case and both sides of the short-key /
    key-split boundary: within the bars, finite, and bit-equal on repeat
    (every sum runs in a fixed order)."""
    params, q, k, v, mask, _, _ = _mha_case(dev, nq, nk, e, nq + nk)
    before = kernels.LAUNCHES["fused_mha"]
    out, probs = A.fused_mha(params, q, k, v, heads, mask)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["fused_mha"] == before + 1
    ref_out, ref_p = A.multihead_attention(params, q, k, v, heads, mask)
    assert torch.isfinite(out).all() and torch.isfinite(probs).all()
    torch.testing.assert_close(out, ref_out, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(probs, ref_p, rtol=1e-3, atol=2e-3)
    torch.testing.assert_close(probs[2], torch.full_like(probs[2], 1.0 / nk))   # all masked
    again_out, again_p = A.fused_mha(params, q, k, v, heads, mask)
    assert torch.equal(out, again_out) and torch.equal(probs, again_p)


@pytest.mark.parametrize("nq,nk,e,heads", [(640, 13, 256, 8), (13, 640, 256, 8),
                                           (70, 1, 64, 4), (33, 700, 128, 8)])
def test_fused_mha_kernel_matches_plain(dev, nq, nk, e, heads):
    """out 1e-4, probs rtol 1e-3 / atol 2e-3 (tests/test_pallas.py:30-33);
    batch row 2 has every key masked (uniform weights on both sides)."""
    g = torch.Generator(device=dev).manual_seed(nq * nk)
    B = 3
    q = torch.randn(B, nq, e, generator=g, device=dev)
    k = torch.randn(B, nk, e, generator=g, device=dev)
    v = torch.randn(B, nk, e, generator=g, device=dev)
    mask = torch.arange(nk, device=dev)[None] < torch.tensor([[nk], [max(1, nk - 3)], [0]],
                                                             device=dev)
    params = {n: (torch.randn(e, e, generator=g, device=dev) / e ** 0.5 if n[0] == "w"
                  else 0.1 * torch.randn(e, generator=g, device=dev))
              for n in A.PARAM_NAMES}
    out, probs = A.fused_mha(params, q, k, v, heads, mask)
    torch.cuda.synchronize()
    ref_out, ref_p = A.multihead_attention(params, q, k, v, heads, mask)
    torch.testing.assert_close(out, ref_out, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(probs, ref_p, rtol=1e-3, atol=2e-3)


def test_wrappers_check_inputs(dev):
    pix = torch.zeros(1, 16, 5, device=dev)
    centers = torch.zeros(1, 4, 5, device=dev)
    prev = torch.zeros(1, 16, dtype=torch.int32, device=dev)
    with pytest.raises(TypeError):
        S.slic_assign(pix, centers, prev.long(), 1.0, 2)
    with pytest.raises(ValueError):
        S.slic_assign(pix.transpose(0, 1).contiguous().transpose(0, 1)[:, ::2], centers,
                      prev[:, :8], 1.0, 2)
    with pytest.raises(ValueError, match="does not divide"):
        S.slic_assign(pix, centers, prev, 1.0, 2, width=5)
    x = torch.zeros(1, 4, 64, device=dev)
    params = {n: torch.zeros((64, 64) if n[0] == "w" else (64,), device=dev)
              for n in A.PARAM_NAMES}
    with pytest.raises(ValueError, match="at most 32"):
        A.fused_mha(params, x, x, x, 1)
    with pytest.raises(ValueError, match="contiguous"):
        A.fused_mha(params, x.transpose(1, 2).contiguous().transpose(1, 2), x, x, 2)
    with pytest.raises(ValueError, match="16-byte aligned"):
        A.fused_mha(params, torch.zeros(4 * 64 + 1, device=dev)[1:].view(1, 4, 64), x, x, 2)
    y = torch.zeros(1, 4, 24, device=dev)
    small = {n: torch.zeros((24, 24) if n[0] == "w" else (24,), device=dev)
             for n in A.PARAM_NAMES}
    with pytest.raises(ValueError, match="multiples of 4"):
        A.fused_mha(small, y, y, y, 4)
    with pytest.raises(TypeError, match="d_out must be float32"):
        A._check_cotangents(x, 4, x.double(), None)
    with pytest.raises(ValueError, match="d_probs must be"):
        A._check_cotangents(x, 4, x, torch.zeros(1, 4, 5, device=dev))
    strided = torch.zeros(1, 64, 4, device=dev).transpose(1, 2)
    assert A._check_cotangents(x, 4, strided, None)[0].is_contiguous()


def test_slic_on_card_matches_cpu(dev):
    """Whole SLIC on the card vs the CPU port: raw labels ≥ 99.5 % equal
    (the card's Lab conversion and blur round differently; the center sums
    run in the CPU's order)."""
    imgs = _images(dev, 2, 128, 1)
    got = S.slic(imgs, n_segments=100)[0].cpu().numpy()
    want = S.slic(imgs.cpu(), n_segments=100)[0].numpy()
    assert (got == want).mean() >= 0.995
    assert np.isin(got, np.arange(got.max() + 1)).all()


def _mha_case(dev, nq, nk, e, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    B = 3
    q = torch.randn(B, nq, e, generator=g, device=dev)
    k = torch.randn(B, nk, e, generator=g, device=dev)
    v = torch.randn(B, nk, e, generator=g, device=dev)
    mask = torch.arange(nk, device=dev)[None] < torch.tensor([[nk], [max(1, nk - 3)], [0]],
                                                             device=dev)
    params = {n: (torch.randn(e, e, generator=g, device=dev) / e ** 0.5 if n[0] == "w"
                  else 0.1 * torch.randn(e, generator=g, device=dev))
              for n in A.PARAM_NAMES}
    d_out = torch.randn(B, nq, e, generator=g, device=dev)
    d_probs = torch.randn(B, nq, nk, generator=g, device=dev)
    return params, q, k, v, mask, d_out, d_probs


@pytest.mark.parametrize("with_probs", [True, False])
@pytest.mark.parametrize("nq,nk,e,heads", [(576, 13, 256, 8), (13, 576, 256, 8),
                                           (70, 1, 64, 4), (33, 700, 128, 8),
                                           (37, 101, 64, 4), (5, 32, 64, 4), (3, 33, 32, 8),
                                           (1100, 20, 64, 4), (40, 200, 64, 4)])
def test_fused_mha_bwd_kernel_matches_plain(dev, nq, nk, e, heads, with_probs):
    """Kernel B3 through ``torch.autograd`` against its plain backward at
    1e-4 (tests/test_pallas.py:98-103), with a partly and a fully masked
    batch row, a live or an absent cotangent for the attention maps, and a
    repeat that must be bit-equal (every sum in a fixed order). Beside the
    training shapes: a ragged one that is no multiple of any tile, chunk or
    row group, both sides of the short-key / key-split boundary, more groups
    of query rows than the short pass has blocks, and several key chunks
    against several row groups."""
    params, q, k, v, mask, d_out, d_probs = _mha_case(dev, nq, nk, e, nq * nk)
    d_probs = d_probs if with_probs else None
    leaves = [t.clone().requires_grad_() for t in (q, k, v, *(params[n] for n in A.PARAM_NAMES))]

    def grads():
        lq, lk, lv, *lw = leaves
        out, probs = A.fused_mha(dict(zip(A.PARAM_NAMES, lw)), lq, lk, lv, heads, mask)
        if d_probs is None:
            return torch.autograd.grad([out], leaves, [d_out])
        return torch.autograd.grad([out, probs], leaves, [d_out, d_probs])

    before = kernels.LAUNCHES["fused_mha_bwd"]
    got = grads()
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["fused_mha_bwd"] == before + 1
    on_card = kernels.device_launches("fused_mha_bwd")
    grads()
    assert 0 < kernels.device_launches("fused_mha_bwd") - on_card < 7
    d_params, d_q, d_k, d_v = A.multihead_attention_backward(
        params, q, k, v, heads, mask, d_out, d_probs)
    want = (d_q, d_k, d_v, *(d_params[n] for n in A.PARAM_NAMES))
    for name, a, b in zip(("d_q", "d_k", "d_v") + A.PARAM_NAMES, got, want):
        assert torch.isfinite(a).all(), name
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4, msg=lambda m: f"{name}: {m}")
    for a, b in zip(got, grads()):
        assert torch.equal(a, b)


@pytest.mark.parametrize("rows,e", [(2304, 256), (52, 256), (37, 64), (600, 132)])
def test_gemm_header_transposed_forms(dev, rows, e):
    """The two transposed forms of ``csrc/gemm_3xtf32.cuh`` alone, against
    float64 products at 1e-5 of the result's largest entry: ``dy @ w^T`` and
    ``x^T dy`` by chunks of 256 rows with the chunks' column sums of ``dy``
    (the weight and bias gradients), at the training sizes and at ragged
    ones (rows, width and chunk no multiple of a tile)."""
    g = torch.Generator(device=dev).manual_seed(rows + e)
    x = torch.relu(torch.randn(rows, e, generator=g, device=dev))
    dy = torch.randn(rows, e, generator=g, device=dev)
    w = torch.randn(e, e, generator=g, device=dev) / e ** 0.5
    lib = kernels.library("fused_mha_bwd")
    stream = kernels.stream_handle(x)

    y = torch.full((rows, e), float("nan"), device=dev)
    rc = lib.fused_mha_bwd_gemm(dy.data_ptr(), w.data_ptr(), y.data_ptr(), None, rows, e, 1, stream)
    kernels.check(lib, rc, "fused_mha_bwd_gemm")
    want = dy.double() @ w.double().T
    assert float((y - want).abs().max() / want.abs().max()) <= 1e-5

    chunks = -(-rows // A._BWD_ROW_CHUNK)
    parts = torch.full((chunks, e, e), float("nan"), device=dev)
    sums = torch.full((chunks, e), float("nan"), device=dev)
    rc = lib.fused_mha_bwd_gemm(x.data_ptr(), dy.data_ptr(), parts.data_ptr(), sums.data_ptr(),
                                rows, e, 2, stream)
    kernels.check(lib, rc, "fused_mha_bwd_gemm")
    torch.cuda.synchronize()
    for c in range(chunks):
        rs = slice(c * A._BWD_ROW_CHUNK, (c + 1) * A._BWD_ROW_CHUNK)
        want = x[rs].double().T @ dy[rs].double()
        assert float((parts[c] - want).abs().max() / want.abs().max()) <= 1e-5, c
        want = dy[rs].double().sum(0)
        assert float((sums[c] - want).abs().max() / want.abs().max()) <= 1e-5, c
    again = torch.empty_like(parts)
    lib.fused_mha_bwd_gemm(x.data_ptr(), dy.data_ptr(), again.data_ptr(), sums.data_ptr(),
                           rows, e, 2, stream)
    assert torch.equal(parts, again)


def test_fused_mha_bwd_shared_key_value_and_strided_cotangent(dev):
    """The fusion passes one tensor as key and value (autograd adds d_k and
    d_v) and autograd may hand the backward a strided ``d_out``."""
    params, q, k, _, mask, _, _ = _mha_case(dev, 40, 13, 64, 5)
    kk = k.clone().requires_grad_()
    out, _ = A.fused_mha(params, q, kk, kk, 4, mask)
    weight = torch.randn(out.shape[0], out.shape[2], out.shape[1], device=dev).transpose(1, 2)
    (got,) = torch.autograd.grad((out * weight).sum(), [kk])
    d_params, _, d_k, d_v = A.multihead_attention_backward(
        params, q, k, k, 4, mask, weight.contiguous(), None)
    torch.testing.assert_close(got, d_k + d_v, rtol=1e-4, atol=1e-4)


def test_train_step_on_card_matches_cpu(dev):
    """One ``FusionTrainer`` step at full width (forward B2, backward B3)
    against the CPU port from the same weights: loss 1e-4 relative, every
    parameter gradient within rtol 1e-3 / atol 1e-5 (float32 sums in
    another order). Gradients, not stepped parameters, are compared: Adam's
    first update is lr * sign(g), which turns rounding noise around g = 0
    into full steps."""
    from camouflage_multimodal_tpu_torch.train.state import make_adamw
    from camouflage_multimodal_tpu_torch.train.train_fusion import FusionTrainer

    rng = np.random.default_rng(3)
    batch = {"rg": rng.standard_normal((4, 576, 128)).astype(np.float32),
             "rg_mask": np.arange(576)[None] < np.array([[576], [500], [431], [380]]),
             "kg": rng.standard_normal((4, 13, 128)).astype(np.float32),
             "y": np.array([0, 1, 1, 0]), "edge": np.array([0, 1, 1, 0], np.float32),
             "score": np.array([0.1, 0.8, 0.6, 0.0], np.float32)}
    results = {}
    for device in ("cpu", "cuda"):
        trainer = FusionTrainer(model_config={"dropout": 0.0, "use_pallas": True})
        trainer.model.reset_parameters(torch.Generator().manual_seed(0))
        trainer.model.to(device).train()
        trainer.optimizer = make_adamw(trainer.model.parameters(), trainer.weight_decay)
        on_dev = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
        kernels.reset_launches()
        out = trainer.model(on_dev["rg"], on_dev["kg"], rg_mask=on_dev["rg_mask"])
        loss = trainer.batch_loss(out, on_dev)
        loss.backward()
        grads = {k: p.grad.cpu() for k, p in trainer.model.named_parameters()}
        trainer.model.zero_grad()
        stepped, _ = trainer.train_step(on_dev, 5e-4)
        assert float(stepped) == float(loss.detach())
        results[device] = (float(loss), grads, dict(kernels.LAUNCHES))
    assert results["cuda"][2] == {"slic_assign": 0, "fused_mha": 4, "fused_mha_bwd": 4}
    assert results["cpu"][2] == {"slic_assign": 0, "fused_mha": 0, "fused_mha_bwd": 0}
    assert abs(results["cuda"][0] - results["cpu"][0]) <= 1e-4 * abs(results["cpu"][0])
    for key, want in results["cpu"][1].items():
        torch.testing.assert_close(results["cuda"][1][key], want, rtol=1e-3, atol=1e-5,
                                   msg=lambda m: f"{key}: {m}")


def _blob_batch(n, size, seed):
    """uint8 images with one disc each, its mask and a ring as edge map."""
    g = np.random.default_rng(seed)
    yy, xx = np.mgrid[:size, :size]
    images, masks, edges = [], [], []
    for _ in range(n):
        img = g.integers(0, 256, (size, size, 3)).astype(np.float64)
        img = (img + np.roll(img, 1, 0) + np.roll(img, 1, 1)) / 3
        cy, cx = g.integers(size // 4, 3 * size // 4, 2)
        d2 = (yy - cy) ** 2 + (xx - cx) ** 2
        mask = d2 < (size / 5) ** 2
        img[mask] = 0.4 * img[mask] + g.integers(60, 200, 3)
        images.append(np.clip(img, 0, 255).astype(np.uint8))
        masks.append((mask * 255).astype(np.uint8))
        edges.append((((d2 >= (size / 5 - 2) ** 2) & (d2 < (size / 5 + 2) ** 2)) * 255).astype(np.uint8))
    return {"image": np.stack(images), "mask": np.stack(masks), "instance": np.stack(masks),
            "edge": np.stack(edges)}


class _BlobDataset:
    def __init__(self, n, size, seed):
        self.raw = _blob_batch(n, size, seed)

    def __len__(self):
        return len(self.raw["image"])

    def load_batch(self, idx):
        return {k: v[list(idx)] for k, v in self.raw.items()}


def test_rg_graph_build_launches_b1_and_matches_cpu(dev):
    """The cached-dataset build launches B1 once per SLIC iteration and
    build batch (20 images in batches of 16: two), a train step never; the
    card's segment maps are ≥ 99 % the CPU's and the node labels equal
    wherever a node covers the same pixels."""
    from camouflage_multimodal_tpu_torch.train.train_rg import LABEL_KEYS, RGTrainer

    ds = _BlobDataset(20, 96, 0)
    trainer = RGTrainer(n_segments=60, max_nodes=128, slic_iters=3)
    kernels.reset_launches()
    data = trainer.build_cached_dataset(ds, batch_size=16, device="cuda")
    torch.cuda.synchronize()
    assert kernels.LAUNCHES == {"slic_assign": 6, "fused_mha": 0, "fused_mha_bwd": 0}
    trainer.model.to(dev)
    trainer.optimizer = torch.optim.AdamW(trainer.model.parameters())
    trainer.train_step(trainer.gather(data, torch.arange(4, device=dev)), 1e-3)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["slic_assign"] == 6
    raw = ds.load_batch(range(4))
    gpu = trainer.build_graphs(raw["image"], raw["mask"], raw["instance"], raw["edge"], "cuda")
    cpu = trainer.build_graphs(raw["image"], raw["mask"], raw["instance"], raw["edge"], "cpu")
    seg_g, seg_c = gpu[0].segments.cpu().numpy(), cpu[0].segments.numpy()
    assert (seg_g == seg_c).mean() >= 0.99
    flat_g, flat_c = seg_g.reshape(4, -1), seg_c.reshape(4, -1)
    agree = np.array([[np.array_equal(flat_g[b] == k, flat_c[b] == k) for k in range(128)]
                      for b in range(4)])
    for key in LABEL_KEYS:
        np.testing.assert_array_equal(gpu[1][key].cpu().numpy()[agree], cpu[1][key].numpy()[agree])


def _rg_graphs(K=640, counts=(640, 560, 431, 17), seed=5):
    g = np.random.default_rng(seed)
    B = len(counts)
    x = g.random((B, K, 15)).astype(np.float32)
    mask = np.arange(K)[None] < np.array(counts)[:, None]
    adj = g.random((B, K, K)) < 0.01
    adj = (adj | adj.transpose(0, 2, 1)) & mask[:, None, :] & mask[:, :, None]
    w = np.where(adj, g.random((B, K, K)) * 0.9 + 0.1, 0.0).astype(np.float32)
    w = np.maximum(w, w.transpose(0, 2, 1))
    labels = {"mask_labels": g.integers(0, 2, (B, K)), "instance_labels": g.integers(0, 2, (B, K)),
              "edge_labels": g.integers(0, 2, (B, K)).astype(np.float32)}
    return {"features": x, "edge_weights": w, "node_mask": mask, **labels}


def test_rg_train_step_on_card_matches_cpu(dev):
    """The full-width RG model (640 nodes, 4 GAT heads of 128, BatchNorm in
    train mode) forward and backward on the card against the CPU: loss
    within 1e-5 relative, gradients within rtol 1e-3 / atol 1e-5, and the
    input gradient finite and zero at padded nodes (their GAT rows are
    all masked)."""
    from camouflage_multimodal_tpu_torch.models.region_graph import RegionGraphGNN
    from camouflage_multimodal_tpu_torch.train.train_rg import rg_loss

    batch = _rg_graphs()
    results = {}
    for device in ("cpu", "cuda"):
        model = RegionGraphGNN(dropout=0.0, head_dropout=0.0)
        model.reset_parameters(torch.Generator().manual_seed(0))
        model.to(device).train()
        b = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
        x = b["features"].clone().requires_grad_()
        w = b["edge_weights"]
        loss, _ = rg_loss(model(x, w > 0, w, b["node_mask"]), b, b["node_mask"])
        loss.backward()
        assert torch.isfinite(x.grad).all()
        assert float(x.grad[~b["node_mask"]].abs().max()) == 0.0
        results[device] = (float(loss), {k: p.grad.cpu() for k, p in model.named_parameters()})
    assert abs(results["cuda"][0] - results["cpu"][0]) <= 1e-5 * abs(results["cpu"][0])
    for key, want in results["cpu"][1].items():
        torch.testing.assert_close(results["cuda"][1][key], want, rtol=1e-3, atol=1e-5,
                                   msg=lambda m: f"{key}: {m}")


def test_kg_train_step_on_card_matches_cpu(dev):
    """The full-width KG model (64-node bucket, batch 32) forward and
    backward on the card against the CPU, as for the RG model."""
    from camouflage_multimodal_tpu_torch.models.knowledge_graph import KnowledgeGraphGNN

    g = np.random.default_rng(6)
    counts = g.integers(6, 40, 32)
    mask = np.arange(64)[None] < counts[:, None]
    x = np.where(mask[..., None], g.random((32, 64, 32)), 0).astype(np.float32)
    adj = g.random((32, 64, 64)) < 0.1
    adj = (adj | adj.transpose(0, 2, 1)) & mask[:, None, :] & mask[:, :, None]
    y = g.random(32).astype(np.float32)
    results = {}
    for device in ("cpu", "cuda"):
        model = KnowledgeGraphGNN(dropout=0.0)
        model.head_drop.p = 0.0
        model.reset_parameters(torch.Generator().manual_seed(0))
        model.to(device).train()
        out = model(*(torch.from_numpy(a).to(device) for a in (x, adj, mask)))
        loss = torch.mean((out["score"][:, 0] - torch.from_numpy(y).to(device)) ** 2)
        loss.backward()
        results[device] = (float(loss), {k: p.grad.cpu() for k, p in model.named_parameters()})
    assert abs(results["cuda"][0] - results["cpu"][0]) <= 1e-5 * abs(results["cpu"][0])
    for key, want in results["cpu"][1].items():
        torch.testing.assert_close(results["cuda"][1][key], want, rtol=1e-3, atol=1e-5,
                                   msg=lambda m: f"{key}: {m}")


# ---------------------------------------------------------------------------
# The workflow slice: a build that repeats to the bit, extraction, metrics
# ---------------------------------------------------------------------------

RG_CKPT = "artifacts/rg_model.ckpt"


def test_index_sum_on_card_equals_cpu(dev):
    """The card's fixed-order segment sum gives the CPU's ``index_add_``
    bits on the same inputs, on every run."""
    from camouflage_multimodal_tpu_torch.ops.regions import index_sum

    g = torch.Generator().manual_seed(4)
    vals = torch.randn(16 * 65536, 17, generator=g)
    idx = torch.randint(0, 16 * 641, (16 * 65536,), generator=g)
    want = index_sum(vals, idx, 16 * 641)
    first = index_sum(vals.to(dev), idx.to(dev), 16 * 641)
    again = index_sum(vals.to(dev), idx.to(dev), 16 * 641)
    assert torch.equal(first, again) and torch.equal(first.cpu(), want)


def test_graph_build_repeats_bit_equal(dev):
    """16 images of 256² built twice on the card with the committed RG
    weights: segments, features, adjacency, edge weights, node embeddings
    and heatmaps equal to the bit."""
    from camouflage_multimodal_tpu_torch.api import load_rg_model
    from camouflage_multimodal_tpu_torch.pipeline import RegionGraphPipeline, build_region_graphs

    images = torch.from_numpy(_blob_batch(16, 256, 7)["image"]).to(dev)
    builds = [build_region_graphs(images) for _ in range(2)]
    for name in ("segments", "features", "adjacency", "edge_weights", "node_mask"):
        assert torch.equal(getattr(builds[0], name), getattr(builds[1], name)), name
    pipe = RegionGraphPipeline(load_rg_model(RG_CKPT, device=dev))
    outs = [pipe(images) for _ in range(2)]
    for name in ("node_embeddings", "graph_embedding", "heatmap", "region_features"):
        assert torch.equal(outs[0][name], outs[1][name]), name


def test_extraction_on_card_matches_cpu(dev, tmp_path):
    """``batch_extract_embeddings`` of 4 PNGs at 256², 500 segments, on the
    card and on the CPU: segment maps ≥ 99 % equal, graph embeddings within
    1e-2, the same names and files."""
    from PIL import Image

    from camouflage_multimodal_tpu_torch.api import load_rg_model
    from camouflage_multimodal_tpu_torch.extract import batch_extract_embeddings
    from camouflage_multimodal_tpu_torch.pipeline import RegionGraphPipeline

    for i, img in enumerate(_blob_batch(4, 256, 8)["image"]):
        Image.fromarray(img).save(tmp_path / f"COD10K-CAM-1-Aquatic-1-Crab-{i}.png")
    res = {}
    for d in ("cuda", "cpu"):
        pipe = RegionGraphPipeline(load_rg_model(RG_CKPT, device=d))
        kernels.reset_launches()
        res[d] = batch_extract_embeddings(pipe, str(tmp_path), str(tmp_path / d), batch_size=4,
                                          save_individual=True, log_fn=lambda *_: None)[0]
        assert kernels.LAUNCHES["slic_assign"] == (10 if d == "cuda" else 0)
    assert list(res["cuda"]) == list(res["cpu"])
    assert sorted(os.listdir(tmp_path / "cuda")) == sorted(os.listdir(tmp_path / "cpu"))
    for name in res["cpu"]:
        base = os.path.splitext(name)[0]
        with np.load(tmp_path / "cuda" / f"{base}_embedding.npz") as a, \
                np.load(tmp_path / "cpu" / f"{base}_embedding.npz") as b:
            assert (a["segments"] == b["segments"]).mean() >= 0.99
        np.testing.assert_allclose(res["cuda"][name]["graph_embedding"],
                                   res["cpu"][name]["graph_embedding"], rtol=0, atol=1e-2)


def test_metrics_on_card_match_cpu(dev):
    """Every metric, batch statistic and curve computed on the card within
    1e-5 of the same functions on the CPU, confusion counts equal."""
    from camouflage_multimodal_tpu_torch.eval import curves as C
    from camouflage_multimodal_tpu_torch.eval import metrics as M

    g = torch.Generator().manual_seed(9)
    pred = torch.rand(8, 256, 256, generator=g)
    gt = (torch.rand(8, 256, 256, generator=g) > 0.6).float()
    gt[1] = 0.0
    gt[2] = 1.0
    pred[3] = gt[3]
    for fn in (M.evaluate_segmentation, M.batch_evaluate, C.threshold_curves):
        want = fn(pred, gt)
        got = fn(pred.to(dev), gt.to(dev))
        for key in want:
            torch.testing.assert_close(got[key].cpu(), want[key], rtol=1e-5, atol=1e-5,
                                       msg=lambda m: f"{fn.__name__} {key}: {m}")
    for a, b in zip(C._confusion_curves(pred.to(dev), gt.to(dev)), C._confusion_curves(pred, gt)):
        assert torch.equal(a.cpu(), b)
