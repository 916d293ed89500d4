"""Label-map connectivity enforcement (skimage's ``enforce_connectivity``).

Port of ``camouflage_multimodal_tpu/ops/connectivity.py``'s per-pixel path,
batched over a leading axis: :func:`enforce_label_connectivity`. Its
contract, bit for bit:

1. split each cluster into 4-connected components, rooted at their min
   raster index (min-label propagation by row/column segmented min scans to
   a fixed point),
2. rank roots in raster order into a compact table of ``C`` ids
   (``max_components``, by default ``16·n_segments``, at most H·W);
   raster-late overflow clamps into id ``C − 1``,
3. merge components smaller than ``min_size = round(min_size_factor·H·W /
   n_segments)`` into the component owning their raster-first large ring
   pixel (a small component with no large contact falls back to its
   raster-first smaller-id small neighbour), resolving chains by pointer
   jumping, to a fixed point (at most 64 rounds),
4. relabel survivors sequentially in raster order, clamped to
   ``max_labels − 1``.

The JAX ``lax.while_loop``s become Python loops with a convergence test, a
host read each, inside a ``cmt::sync.components`` span (every
``_SWEEPS_PER_CHECK`` sweeps of step 1) or a ``cmt::sync.merge`` span
(every merge round of step 3). A round applied to an image that has
already converged is a no-op, so the batch runs until its slowest image
converges and each image gets exactly its own result; ``return_rounds``
counts each image's own rounds, as the JAX package's ``vmap`` of its loop
does. Everything is int64, where the JAX package packs int32.

The JAX package's run-structured form of the same pass (regular scans over
row-runs instead of gathers) is a TPU device: on the H100 it gave the same
labels to the bit and was slower at every size timed, so the port has this
one path.

Under spatial sharding (``row_group``: each rank holds a block of rows) the
label map is gathered over the ranks with a byte-exact gather (8 bytes a
pixel, 512 KB at 256²), the pass runs on the whole map on every rank, and
each keeps its rows. Its fixed points take many rounds, and a distributed
form would need a collective per round (~30 ms apiece for gloo on CUDA
tensors, PERF.md §5); it waits for a benchmark that shows the gather
matters.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from camouflage_multimodal_tpu_torch.core.profiling import annotate
from camouflage_multimodal_tpu_torch.parallel.sharding import gather_dim

_MAX_MERGE_ROUNDS = 64
_SMALL_BIT = 1 << 24
_SWEEPS_PER_CHECK = 2   # CC sweeps between host-synchronising convergence tests


def _neighbor_shifts(x: torch.Tensor, fill):
    """The four 4-connected neighbour maps of (B, H, W), edge-filled:
    value at (y−1, x), (y+1, x), (y, x−1), (y, x+1)."""
    row = torch.full_like(x[:, :1], fill)
    col = torch.full_like(x[:, :, :1], fill)
    up = torch.cat([row, x[:, :-1]], dim=1)
    down = torch.cat([x[:, 1:], row], dim=1)
    left = torch.cat([col, x[:, :, :-1]], dim=2)
    right = torch.cat([x[:, :, 1:], col], dim=2)
    return up, down, left, right


def _run_ids(labels: torch.Tensor, dim: int) -> torch.Tensor:
    """Index of each element's run of equal labels along ``dim``."""
    reset = labels != torch.roll(labels, 1, dims=dim)
    reset.narrow(dim, 0, 1).fill_(True)
    return torch.cumsum(reset.long(), dim=dim)


def _seg_min_scan(comp: torch.Tensor, run_ids: torch.Tensor, dim: int,
                  offset: int) -> torch.Tensor:
    """Min of ``comp`` over each run along ``dim``: a plain cummin of
    ``comp ∓ offset·run`` in both directions (``offset`` > max(comp))."""
    off = run_ids * offset
    fwd = torch.cummin(comp - off, dim=dim).values + off
    bwd = torch.cummin((comp + off).flip(dim), dim=dim).values.flip(dim) - off
    return torch.minimum(fwd, bwd)


def connected_components(labels: torch.Tensor) -> torch.Tensor:
    """Per-pixel component root (min raster index, int64) of the
    4-connected components of (B, H, W) label maps."""
    B, H, W = labels.shape
    HW = H * W
    comp = torch.arange(HW, device=labels.device).reshape(1, H, W).expand(B, H, W)
    s_cols = _run_ids(labels, 2)
    s_rows = _run_ids(labels, 1)
    while True:
        prev = comp
        for _ in range(_SWEEPS_PER_CHECK):   # sweeps past the fixed point are no-ops
            comp = _seg_min_scan(comp, s_cols, 2, HW)
            comp = _seg_min_scan(comp, s_rows, 1, HW)
        with annotate("cmt::sync.components"):
            converged = torch.equal(comp, prev)
        if converged:
            return comp


def _ring_best(comp, small, nbr_idx, big: int, none: int) -> torch.Tensor:
    """Each small pixel's merge candidate (see the JAX ``absorb_pass``): the
    raster index of its raster-first neighbour in a large component, else
    (biased by +H·W) of a neighbour in a smaller-id small component, else
    ``none``. (B, H, W) int64."""
    best = torch.full_like(comp, none)
    for cn, sn, ni in zip(_neighbor_shifts(comp, -1), _neighbor_shifts(small, True), nbr_idx):
        ok = (cn >= 0) & (cn != comp)
        cand = torch.where(ok & ~sn, ni, torch.where(ok & sn & (cn < comp), ni + big, none))
        best = torch.minimum(best, cand)
    return torch.where(small, best, none)


def _whole_map(fn, labels: torch.Tensor, row_group, **kw):
    """Run ``fn`` on the label maps gathered over ``row_group`` and keep this
    rank's rows of its label output (module docstring)."""
    rows = labels.shape[1]
    res = fn(gather_dim(labels, 1, row_group), **kw)
    first = rows * dist.get_rank(row_group)
    if isinstance(res, tuple):
        return (res[0][:, first:first + rows], *res[1:])
    return res[:, first:first + rows]


def enforce_label_connectivity(labels: torch.Tensor, n_segments: int,
                               min_size_factor: float = 0.5,
                               max_labels: int | None = None,
                               return_count: bool = False,
                               return_rounds: bool = False,
                               return_raw_count: bool = False,
                               max_components: int | None = None,
                               row_group=None):
    """(B, H, W) integer label maps → 0-based sequential raster-ordered
    component labels (int64), at most ``max_labels`` of them. Under a
    ``row_group`` each rank holds a block of rows of the maps, and gets its
    rows of the result (module docstring).

    The extras come after the labels, in this order, each a (B,) int64
    tensor: ``return_count`` the survivors before the ``max_labels`` clamp,
    ``return_rounds`` the image's merge rounds (the first included),
    ``return_raw_count`` its raw components (more than ``C`` means the
    compact table overflowed and its raster tail was merged into id C − 1)."""
    kw = dict(n_segments=n_segments, min_size_factor=min_size_factor,
              max_labels=max_labels, return_count=return_count,
              return_rounds=return_rounds, return_raw_count=return_raw_count,
              max_components=max_components)
    if row_group is not None:
        return _whole_map(enforce_label_connectivity, labels, row_group, **kw)
    B, H, W = labels.shape
    HW = H * W
    C = min(16 * n_segments if max_components is None else max_components, HW)
    if HW >= 2 ** 30 or C >= _SMALL_BIT:
        raise ValueError(f"label maps of {H}x{W} with {n_segments} segments exceed "
                         "the int32 packing of the JAX formulation")
    dev = labels.device
    min_size = round(min_size_factor * H * W / n_segments)
    big = HW
    none = 2 * big
    idx = torch.arange(HW, device=dev)

    flatroot = connected_components(labels).reshape(B, HW)
    is_root = flatroot == idx
    ranks = torch.cumsum(is_root.long(), dim=1) - 1
    ones = torch.ones(B, HW, dtype=torch.long, device=dev)
    size_t = torch.zeros(B, HW, dtype=torch.long, device=dev).scatter_add_(1, flatroot, ones)
    small_t = (size_t > 0) & (size_t < min_size)
    packed_t = torch.clamp(ranks, max=C - 1) + torch.where(small_t, _SMALL_BIT, 0)
    g0 = torch.gather(packed_t, 1, flatroot)
    flat0 = g0 & (_SMALL_BIT - 1)                       # compact ids in [0, C)
    small0 = (g0 >= _SMALL_BIT).reshape(B, H, W)
    size0 = torch.zeros(B, C, dtype=torch.long, device=dev).scatter_add_(1, flat0, ones)

    ident = torch.arange(C, device=dev).expand(B, C)
    nbr_idx = _neighbor_shifts(idx.reshape(1, H, W), big)
    n_jumps = max(int(C - 1).bit_length(), 1)

    def absorb_pass(comp, small, cur, size):
        """One absorption round: the raster-first candidate of each
        component (one H·W-sized scatter-min), then the C-sized end: each
        component's absorbing id from its target ring pixel, chains resolved
        by pointer jumping, composed into ``cur`` and ``size``."""
        best = _ring_best(comp, small, nbr_idx, big, none)
        flat = comp.reshape(B, HW)
        target = torch.full((B, C), none, dtype=torch.long, device=dev)
        target.scatter_reduce_(1, flat, best.reshape(B, HW), reduce="amin")
        ring = torch.where(target < big, target, target - big)
        absorb = torch.where(target < none,
                             torch.gather(flat, 1, torch.clamp(ring, 0, big - 1)), ident)
        for _ in range(n_jumps):      # resolve merge chains to their roots
            absorb = torch.gather(absorb, 1, absorb)
        return torch.gather(absorb, 1, cur), torch.zeros_like(size).scatter_add_(1, absorb, size)

    # Round 1: ``cur`` is the identity and smallness comes from raw sizes.
    cur, size = absorb_pass(flat0.reshape(B, H, W), small0, ident, size0)
    rounds = torch.ones(B, dtype=torch.long, device=dev)
    for _ in range(_MAX_MERGE_ROUNDS - 1):
        small_c = (size > 0) & (size < min_size)
        pending = small_c.any(dim=1)
        with annotate("cmt::sync.merge"):
            merging = bool(pending.any())
        if not merging:
            break
        rounds += pending
        packed_c = cur + torch.where(torch.gather(small_c, 1, cur), _SMALL_BIT, 0)
        g = torch.gather(packed_c, 1, flat0).reshape(B, H, W)
        cur, size = absorb_pass(g & (_SMALL_BIT - 1), g >= _SMALL_BIT, cur, size)

    live = size > 0
    rank = torch.cumsum(live.long(), dim=1) - 1
    if max_labels is not None:
        rank = torch.clamp(rank, max=max_labels - 1)
    out = torch.gather(torch.gather(rank, 1, cur), 1, flat0).reshape(B, H, W)
    extras = [x for x, on in ((live.sum(1), return_count), (rounds, return_rounds),
                              (is_root.sum(1), return_raw_count)) if on]
    return (out, *extras) if extras else out
