"""Canny's hysteresis: the plain version against a labelling oracle on the
CPU, the CUDA kernel (``csrc/canny_hysteresis.cu``) against the plain
version on the card.

The oracle is ``scipy.ndimage.label(low, structure=np.ones((3, 3)))``,
keeping the components that hold a pixel of ``high & low``: the unique
fixed point, so every version must give it to the bit. The kernel's
design (bit rows, run fills by carries chained across a warp's words,
bands swept down and up until a round adds nothing) is also held to the
oracle here, on the CPU, through :func:`_emulate_kernel`, which follows the
kernel's arithmetic word for word.

The tests marked ``cuda`` skip without a card. Run them on a machine with an
NVIDIA GPU (sm_90a) and the CUDA toolkit with

    python -m pytest tests/test_torch_port_canny_hysteresis.py -m cuda --noconftest -q
"""

import importlib
import importlib.util
import pathlib

import numpy as np
import pytest
import scipy.ndimage
import torch

from camouflage_multimodal_tpu_torch.core import kernels
from camouflage_multimodal_tpu_torch.ops.image import rgb_to_gray

# ops.canny is the function; the module by name
C = importlib.import_module("camouflage_multimodal_tpu_torch.ops.canny")

REPO = pathlib.Path(__file__).resolve().parents[1]


def _scenes_module():
    """``benchmark/scenes.py``, the benchmark's seeded scenes, by path."""
    spec = importlib.util.spec_from_file_location("benchmark_scenes", REPO / "benchmark" / "scenes.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def oracle(low: torch.Tensor, high: torch.Tensor) -> np.ndarray:
    """The components of ``low`` (8-connected) that hold a pixel of
    ``high & low``, image by image over the leading dimensions."""
    lo = low.cpu().numpy().reshape(-1, *low.shape[-2:])
    hi = high.cpu().numpy().reshape(lo.shape)
    out = np.zeros_like(lo)
    for i in range(len(lo)):
        labels, _ = scipy.ndimage.label(lo[i], structure=np.ones((3, 3)))
        keep = np.unique(labels[lo[i] & hi[i]])
        out[i] = np.isin(labels, keep[keep > 0])
    return out.reshape(low.shape)


# ---------------------------------------------------------------------------
# Cases: (low, high) bool masks on the CPU
# ---------------------------------------------------------------------------

def _spiral(n: int):
    """A one-pixel square spiral with one-pixel gaps between its arms,
    walked from the corner inwards (arms of n-1, n-1, n-1, n-3, n-3, n-5,
    ...), the one strong pixel at its inner end: the longest chain an n × n
    image holds, the plain version's worst case."""
    low = np.zeros((n, n), bool)
    y = x = 0
    low[0, 0] = True
    moves = ((0, 1), (1, 0), (0, -1), (-1, 0))
    lengths = [n - 1, n - 1] + [n - 1 - 2 * (k // 2) for k in range(2, 2 * n)]
    for k, length in enumerate(lengths):
        if length <= 0:
            break
        dy, dx = moves[k % 4]
        for _ in range(length):
            y, x = y + dy, x + dx
            low[y, x] = True
    high = np.zeros_like(low)
    high[y, x] = True
    return torch.from_numpy(low), torch.from_numpy(high)


def _random(shape, seed: int, density: float = 0.5, strong: float = 0.003):
    """Low pixels at about the 8-connected percolation density, so the
    components are large and winding, and a few strong pixels."""
    rng = np.random.default_rng(seed)
    low = rng.random(shape) < density
    high = rng.random(shape) < strong
    return torch.from_numpy(low), torch.from_numpy(high)


def _scene_masks(n: int, size: int, seed: int, thresholds=(0.1, 0.2), device="cpu"):
    """Canny's low and high masks (sigma 2, the graph build's) of ``n`` of
    the benchmark's scenes made at ``size``²."""
    g = torch.Generator(device=device).manual_seed(seed)
    images = _scenes_module().scenes(g, n, size, size).float() / 255.0
    return C._threshold_masks(rgb_to_gray(images), 2.0, *thresholds)


def _case(name: str):
    if name == "spiral":
        return _spiral(41)
    if name == "empty":
        return torch.zeros(40, 50, dtype=torch.bool), torch.zeros(40, 50, dtype=torch.bool)
    if name == "all_high":
        low, _ = _random((40, 50), 1)
        return low, torch.ones_like(low)
    if name == "low_no_high":
        low, _ = _random((40, 50), 2)
        return low, torch.zeros_like(low)
    if name == "low_above_high":       # low_threshold > high_threshold
        return _scene_masks(2, 64, 3, thresholds=(0.15, 0.05))
    if name == "row_1xN":
        return _random((1, 300), 4, strong=0.02)
    if name == "col_Nx1":
        return _random((300, 1), 5, strong=0.02)
    if name == "ragged_37x45":
        return _random((37, 45), 6)
    if name == "batch_2x3":
        return _random((2, 3, 40, 48), 7)
    if name == "scenes_352":
        return _scene_masks(2, 352, 8)
    raise KeyError(name)


CASES = ("spiral", "empty", "all_high", "low_no_high", "low_above_high", "row_1xN",
         "col_Nx1", "ragged_37x45", "batch_2x3", "scenes_352")


@pytest.mark.parametrize("name", CASES)
def test_plain_hysteresis_equals_oracle(name):
    """The plain version, which CPU tensors take, is the labelling oracle's
    set on every case."""
    low, high = _case(name)
    got = C.canny_hysteresis(low, high)
    assert got.dtype == torch.bool and got.shape == low.shape
    assert np.array_equal(got.numpy(), oracle(low, high))


def test_the_cases_are_not_trivial():
    """The oracle's answer differs from both masks where a case means it to:
    components are dropped and low pixels are reached from strong ones."""
    for name in ("spiral", "ragged_37x45", "batch_2x3", "scenes_352", "row_1xN"):
        low, high = _case(name)
        want = oracle(low, high)
        assert want.sum() > (low & high).sum().item(), name
    for name in ("ragged_37x45", "batch_2x3", "scenes_352"):
        low, high = _case(name)
        assert oracle(low, high).sum() < low.sum().item(), name
    low, high = _spiral(41)
    assert low.sum() > 800 and np.array_equal(oracle(low, high), low.numpy())


def test_cpu_tensors_launch_no_kernel():
    """On the CPU ``canny`` and ``canny_hysteresis`` take the plain version:
    the kernel's launch count stays where it was; rounds are the kernel's."""
    before = kernels.LAUNCHES["canny_hysteresis"]
    gray = torch.rand(2, 48, 48, generator=torch.Generator().manual_seed(0))
    C.canny(gray, sigma=1.0)
    low, high = _case("ragged_37x45")
    C.canny_hysteresis(low, high)
    assert kernels.LAUNCHES["canny_hysteresis"] == before
    with pytest.raises(ValueError, match="rounds"):
        C.canny_hysteresis(low, high, return_rounds=True)


def test_kernel_is_registered():
    """The kernel builds like the others (``core/kernels.py``): its source,
    its launch counter and its launcher's C signature."""
    assert "canny_hysteresis" in kernels.KERNELS and "canny_hysteresis" in kernels.LAUNCHES
    assert (kernels.CSRC / "canny_hysteresis.cu").exists()
    sig = kernels._SIGNATURES["canny_hysteresis"]
    assert sig == [kernels._P] * 5 + [kernels._I] * 3 + [kernels._P]


# ---------------------------------------------------------------------------
# The kernel's design, emulated on the CPU
# ---------------------------------------------------------------------------

_FULL = 0xFFFFFFFF
_WARPS = 32


def _brev(x: int) -> int:
    return int(f"{x:032b}"[::-1], 2)


def _run_fill(ms, ss, reversed_, carry):
    """``run_fill`` of the kernel over the 32 lanes of a warp."""
    sums = [(m + s) & _FULL for m, s in zip(ms, ss)]
    gen = sum(1 << lane for lane in range(32) if sums[lane] < ms[lane])
    prop = sum(1 << lane for lane in range(32) if sums[lane] == _FULL)
    if reversed_:
        gen, prop = _brev(gen), _brev(prop)
    a, b = gen | prop, gen
    total = a + b + carry
    out = []
    for lane in range(32):
        pos = 31 - lane if reversed_ else lane
        carry_in = ((total ^ a ^ b) >> pos) & 1
        out.append(((((sums[lane] + carry_in) & _FULL) ^ ms[lane]) | ss[lane]) & ms[lane])
    return out, total >> 32


def _update_row(low, cur, y):
    """``update_row`` of the kernel: one warp, lane j0 + l on word j0 + l."""
    height, words = low.shape
    grew = False
    carry = 0
    for j0 in range(0, words, 32):
        ms, ss = [0] * 32, [0] * 32
        for lane in range(32):
            j = j0 + lane
            if j >= words:
                continue

            def nb(k):
                up = int(cur[y - 1, k]) if y > 0 else 0
                down = int(cur[y + 1, k]) if y + 1 < height else 0
                return up | down

            n = nb(j)
            left = nb(j - 1) if j > 0 else 0
            right = nb(j + 1) if j + 1 < words else 0
            old = int(cur[y, j])
            ms[lane] = int(low[y, j])
            ss[lane] = (old | n | ((n << 1) & _FULL) | (left >> 31) | (n >> 1)
                        | ((right << 31) & _FULL)) & ms[lane]
            grew |= ss[lane] != old
        fs, carry = _run_fill(ms, ss, False, carry)
        for lane in range(32):
            if j0 + lane < words:
                grew |= fs[lane] != ss[lane]
                cur[y, j0 + lane] = fs[lane]
    carry = 0
    for j0 in range((words - 1) // 32 * 32, -1, -32):
        ms = [_brev(int(low[y, j0 + lane])) if j0 + lane < words else 0 for lane in range(32)]
        ss = [_brev(int(cur[y, j0 + lane])) if j0 + lane < words else 0 for lane in range(32)]
        fs, carry = _run_fill(ms, ss, True, carry)
        for lane in range(32):
            if j0 + lane < words:
                grew |= fs[lane] != ss[lane]
                cur[y, j0 + lane] = _brev(fs[lane])
    return grew


def _pack(mask: np.ndarray) -> np.ndarray:
    """Bit rows: pixel x of a row is bit x % 32 of word x // 32."""
    H, W = mask.shape
    words = -(-W // 32)
    padded = np.zeros((H, words * 32), bool)
    padded[:, :W] = mask
    weights = (1 << np.arange(32, dtype=np.uint64))
    return (padded.reshape(H, words, 32) * weights).sum(-1).astype(np.uint64)


def _emulate_kernel(low: np.ndarray, high: np.ndarray):
    """The kernel's block on one image, its warps run one after another in
    each round (one of the orders the card may take): the result and the
    rounds."""
    H, W = low.shape
    lo, cur = _pack(low), _pack(low & high)
    rounds = 0
    while True:
        grew = False
        for warp in range(_WARPS):
            r0, r1 = warp * H // _WARPS, (warp + 1) * H // _WARPS
            for y in list(range(r0, r1)) + list(range(r1 - 2, r0 - 1, -1)):
                grew |= _update_row(lo, cur, y)
        rounds += 1
        if not grew:
            break
    bits = (cur[:, :, None] >> np.arange(32, dtype=np.uint64)) & np.uint64(1)
    return bits.reshape(H, -1)[:, :W].astype(bool), rounds


@pytest.mark.parametrize("name", ["spiral", "all_high", "row_1xN", "col_Nx1", "ragged_37x45",
                                  "wide_4x2100"])
def test_kernel_design_equals_oracle(name):
    """The kernel's arithmetic, emulated: the oracle's set, in at least one
    round. Rows of three segments of 32 words (``wide``): one run across a
    whole row seeded at its first pixel and one at its last, so the carries
    chain across the segments upward and downward."""
    if name == "wide_4x2100":
        low = np.random.default_rng(9).random((4, 2100)) < 0.5
        low[0], low[1], low[2] = True, False, True
        high = np.zeros_like(low)
        high[0, 0] = high[2, 2099] = True
        low, high = torch.from_numpy(low), torch.from_numpy(high)
    else:
        low, high = _case(name)
    want = oracle(low, high)
    got, rounds = _emulate_kernel(low.numpy(), high.numpy())
    assert np.array_equal(got, want) and rounds >= 1
    if name == "spiral":    # an arm along a row is filled in one row update
        assert rounds < low.sum().item() // 4


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

CARD_CASES = CASES + ("spiral_101", "wide_64x2100", "limit_908x1024", "scenes_16x352",
                      "scenes_16x256", "large_2048")


def _card_case(name: str, dev):
    if name == "spiral_101":
        low, high = _spiral(101)
    elif name == "wide_64x2100":     # three segments of words a row, in shared memory
        low, high = _random((64, 2100), 10)
    elif name == "limit_908x1024":   # the most shared memory a block takes (opted in past 48 KB)
        low, high = _random((908, 1024), 14, density=0.45)
    elif name == "scenes_16x352":
        return _scene_masks(16, 352, 11, device=dev.type)
    elif name == "scenes_16x256":
        return _scene_masks(16, 256, 12, device=dev.type)
    elif name == "large_2048":       # 2 x 1 MB of packed masks: the device-memory path
        return _scene_masks(1, 2048, 13, device=dev.type)
    else:
        low, high = _case(name)
    return low.to(dev), high.to(dev)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", CARD_CASES)
def test_kernel_equals_plain_on_the_card(dev, name):
    """One launch a call, bit-equal to the plain version run on the card
    and to the oracle, at least one round an image."""
    low, high = _card_case(name, dev)
    state = 8 * low.shape[-2] * -(-low.shape[-1] // 32)     # bytes of the two packed masks
    if name == "large_2048":
        assert state > C._SHARED_BYTES
    if name == "limit_908x1024":
        assert state == C._SHARED_BYTES
    before = kernels.LAUNCHES["canny_hysteresis"]
    got, rounds = C.canny_hysteresis(low, high, return_rounds=True)
    torch.cuda.synchronize()
    on_card = kernels.device_launches("canny_hysteresis")
    got2 = C.canny_hysteresis(low, high)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["canny_hysteresis"] == before + 2
    assert kernels.device_launches("canny_hysteresis") == on_card + 1
    want = C._hysteresis(low, high)
    assert got.dtype == torch.bool and got.shape == low.shape and got.device == low.device
    assert torch.equal(got, want) and torch.equal(got2, want)
    assert np.array_equal(got.cpu().numpy(), oracle(low, high))
    assert rounds.shape == low.shape[:-2] and rounds.dtype == torch.int32
    assert int(rounds.min()) >= 1


@pytest.mark.cuda
def test_kernel_call_makes_no_host_sync(dev):
    """Under ``set_sync_debug_mode("error")`` a call on the card, rounds
    included, raises nothing: no host synchronisation inside it, on the
    shared-memory path and on the device-memory one."""
    cases = [_card_case("scenes_16x352", dev), _card_case("large_2048", dev)]
    C.canny_hysteresis(*cases[0])                    # builds and loads the library
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        outs = [C.canny_hysteresis(low, high, return_rounds=True) for low, high in cases]
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    for (low, high), (out, rounds) in zip(cases, outs):
        assert torch.equal(out, C._hysteresis(low, high)) and int(rounds.min()) >= 1


@pytest.mark.cuda
def test_kernel_wrapper_refuses_bad_inputs(dev):
    low, high = _card_case("ragged_37x45", dev)
    with pytest.raises(TypeError):
        C.canny_hysteresis(low.to(torch.uint8), high)
    with pytest.raises(ValueError, match="contiguous"):
        C.canny_hysteresis(low.t(), high.t())
    with pytest.raises(ValueError, match="shapes"):
        C.canny_hysteresis(low, high[:, :-1].contiguous())
    with pytest.raises(ValueError, match="on"):
        C.canny_hysteresis(low, high.cpu())
    with pytest.raises(ValueError, match="no pixel"):
        C.canny_hysteresis(low[:0], high[:0])
