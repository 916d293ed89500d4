"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: without a CUDA device every test here skips. Run on a
machine with an NVIDIA GPU (sm_90a) and the CUDA toolkit with

    python -m pytest tests/test_torch_port_cuda.py -m cuda --noconftest -q

(``--noconftest``: the suite's conftest imports JAX, which such a machine
need not have; these tests import only the port.)
"""

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
    x = torch.zeros(1, 4, 64, device=dev)
    params = {n: torch.zeros((64, 64) if n[0] == "w" else (64,), device=dev)
              for n in A.PARAM_NAMES}
    with pytest.raises(ValueError, match="at most 32"):
        A.fused_mha(params, x, x, x, 1)
    with pytest.raises(ValueError, match="contiguous"):
        A.fused_mha(params, x.transpose(1, 2).contiguous().transpose(1, 2), x, x, 2)


def test_slic_on_card_matches_cpu(dev):
    """Whole SLIC on the card vs the CPU port: raw labels ≥ 99.5 % equal
    (center sums run in another order with atomics on the card)."""
    imgs = _images(dev, 2, 128, 1)
    got = S.slic(imgs, n_segments=100)[0].cpu().numpy()
    want = S.slic(imgs.cpu(), n_segments=100)[0].numpy()
    assert (got == want).mean() >= 0.995
    assert np.isin(got, np.arange(got.max() + 1)).all()
