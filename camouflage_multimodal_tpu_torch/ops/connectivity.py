"""Label-map connectivity enforcement (skimage's ``enforce_connectivity``).

Port of ``camouflage_multimodal_tpu/ops/connectivity.py``, batched over a
leading axis: the per-pixel path (:func:`enforce_label_connectivity`), the
run-structured path (:func:`enforce_label_connectivity_runs`) and the JAX
main path's entry (:func:`enforce_label_connectivity_batched`). Their
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

The run-structured path works on row-runs of equal labels (each lies in one
component, and every component's root is a run start), so its merge rounds
regenerate the per-pixel maps from per-run tables with segmented
``cummax`` fills instead of gathers. The JAX package's reason for it — an
irregular H·W-sized op costs ~1 ms an image on a TPU, a regular scan ~0.03
(the ms figures of its docstring are a TPU's) — does not carry over to a
card with cheap gathers: on the H100 the per-pixel path measured faster at
every size timed (PERF.md §5). So the dispatcher always runs the per-pixel
path, whose output is the same to the bit, and reports the JAX package's
choice only as its ``return_fallback`` flag; the runs path runs only when
called by name.

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


def _resolve(target, flat, ident, cur, size, big: int, none: int, n_jumps: int):
    """The C-sized end of an absorption round: each component's absorbing
    id from its target ring pixel (``flat`` maps pixels to ids), chains
    resolved by pointer jumping, composed into ``cur`` and ``size``."""
    ring = torch.where(target < big, target, target - big)
    safe = torch.clamp(ring, 0, big - 1)
    absorb = torch.where(target < none, torch.gather(flat, 1, safe), ident)
    for _ in range(n_jumps):      # resolve merge chains to their roots
        absorb = torch.gather(absorb, 1, absorb)
    return torch.gather(absorb, 1, cur), torch.zeros_like(size).scatter_add_(1, absorb, size)


def _bucket(H: int, W: int, n_segments: int, max_components):
    """The compact table's size C."""
    return min(16 * n_segments if max_components is None else max_components, H * W)


def _extras(out, count, rounds, raw_count, return_count, return_rounds, return_raw_count):
    extras = [x for x, on in ((count, return_count), (rounds, return_rounds),
                              (raw_count, return_raw_count)) if on]
    return (out, *extras) if extras else out


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
    component labels (int64), at most ``max_labels`` of them: the per-pixel
    path. Under a ``row_group`` each rank holds a block of rows of the maps,
    and gets its rows of the result (module docstring).

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
    C = _bucket(H, W, n_segments, max_components)
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
        component (one H·W-sized scatter-min), then the C-sized resolution."""
        best = _ring_best(comp, small, nbr_idx, big, none)
        flat = comp.reshape(B, HW)
        target = torch.full((B, C), none, dtype=torch.long, device=dev)
        target.scatter_reduce_(1, flat, best.reshape(B, HW), reduce="amin")
        return _resolve(target, flat, ident, cur, size, big, none, n_jumps)

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
    return _extras(out, live.sum(1), rounds, is_root.sum(1),
                   return_count, return_rounds, return_raw_count)


# ---------------------------------------------------------------------------
# Run-structured formulation
# ---------------------------------------------------------------------------

def _row_run_starts(labels: torch.Tensor) -> torch.Tensor:
    """(B, H, W) bool: True where a row-run of equal labels starts (column 0
    and every horizontal label change). Runs never span rows."""
    rs = labels != torch.roll(labels, 1, dims=2)
    rs[:, :, 0] = True
    return rs


def _fill_runs(paint: torch.Tensor, rowrun: torch.Tensor, bits: int) -> torch.Tensor:
    """Forward-fill non-negative values painted at run starts across each
    run: a plain ``cummax`` along W with the row-run offset trick (values
    below ``2**bits``; pixels other than starts hold 0, which any painted
    start value dominates within its run)."""
    off = rowrun << bits
    return torch.cummax(paint + off, dim=2).values - off


def _seg_row_min(vals: torch.Tensor, rowrun: torch.Tensor, bits: int) -> torch.Tensor:
    """Forward segmented min of ``vals`` (in ``[0, 2**bits)``) within each
    row-run; the value at a run's last pixel is the run's min. The offset
    makes earlier runs larger, so it is subtracted (the fills add it)."""
    off = rowrun << bits
    return torch.cummin(vals - off, dim=2).values + off


def _run_packing_bits(H: int, W: int, C: int):
    """Bits of the compact id (``cid_bits``) and of the candidate priorities
    in [0, 2·H·W] (``hw_bits``) that the row-run offsets shift past."""
    return max(int(C).bit_length(), 1), int(2 * H * W + 1).bit_length()


def enforce_label_connectivity_runs(labels: torch.Tensor, n_segments: int,
                                    min_size_factor: float = 0.5,
                                    max_labels: int | None = None,
                                    run_bucket: int | None = None,
                                    max_components: int | None = None,
                                    return_count: bool = False,
                                    return_rounds: bool = False,
                                    return_raw_count: bool = False):
    """The run-structured connectivity pass: the contract and output of
    :func:`enforce_label_connectivity` (extras too), PROVIDED every map has
    at most ``run_bucket`` (default H·W // 4) row-runs, which callers
    guarantee. It is the JAX package's function for parity; no path of the
    port dispatches to it (module docstring).

    Per image it keeps R-entry run tables (start, length, component) and
    C-entry component tables. Each merge round paints the per-run packed
    (compact id, smallness) at the run starts and fills them along the rows,
    takes the ring candidates, reduces them per run with a segmented row
    min read at the run's last pixel (``nxt − 1``), and per component with
    one R-sized scatter-min. JAX's dropped out-of-range writes (``mode=
    "drop"``) land in a dump slot at the end of each table, sliced off.
    Round-1 smallness comes from the RAW per-root sizes, as in the
    per-pixel path, so the two agree when raw components overflow C."""
    B, H, W = labels.shape
    HW = H * W
    R = min(HW, HW // 4 if run_bucket is None else run_bucket)
    C = _bucket(H, W, n_segments, max_components)
    cid_bits, hw_bits = _run_packing_bits(H, W, C)
    dev = labels.device
    min_size = round(min_size_factor * H * W / n_segments)
    big = HW
    none = 2 * big
    idx = torch.arange(HW, device=dev).expand(B, HW)

    comp0 = connected_components(labels).reshape(B, HW)
    rs = _row_run_starts(labels)
    rowrun = torch.cumsum(rs.long(), dim=2)                     # 1-based, ≤ W
    rid = torch.cumsum(rs.reshape(B, HW).long(), dim=1) - 1      # the image's run ids
    start = torch.full((B, R), HW, dtype=torch.long, device=dev)
    start.scatter_reduce_(1, torch.clamp(rid, max=R - 1), idx, reduce="amin")
    nxt = torch.cat([start[:, 1:], torch.full((B, 1), HW, dtype=torch.long, device=dev)], 1)
    run_len = torch.clamp(nxt - start, min=0)                    # 0 for empty slots
    valid = run_len > 0
    sstart = torch.clamp(start, max=HW - 1)

    def table(n, fill=0):
        """A zeroed (B, n + 1) table: entry n is the dump slot."""
        return torch.full((B, n + 1), fill, dtype=torch.long, device=dev)

    rcomp = torch.gather(comp0, 1, sstart)                       # component root of each run
    is_root = valid & (rcomp == start)
    rank = torch.clamp(torch.cumsum(is_root.long(), dim=1) - 1, max=C - 1)
    ptab = table(HW).scatter_(1, torch.where(is_root, sstart, HW), rank)[:, :HW]
    cid = torch.where(valid, torch.gather(ptab, 1, torch.clamp(rcomp, max=HW - 1)), C)
    size0 = table(C).scatter_add_(1, cid, run_len)[:, :C]
    size_raw = table(HW).scatter_add_(1, torch.where(valid, rcomp, HW), run_len)[:, :HW]
    small_raw_run = valid & (torch.gather(size_raw, 1, torch.clamp(rcomp, max=HW - 1)) < min_size)

    ident = torch.arange(C, device=dev).expand(B, C)
    nbr_idx = _neighbor_shifts(torch.arange(HW, device=dev).reshape(1, H, W), big)
    n_jumps = max(int(C - 1).bit_length(), 1)
    paint_idx = torch.where(valid, start, HW)
    cid_c = torch.clamp(cid, max=C - 1)
    last = torch.clamp(nxt - 1, max=HW - 1)

    def paint_fill(run_vals):
        """Per-run values painted at the run starts and filled along rows."""
        paint = table(HW).scatter_(1, paint_idx, run_vals)[:, :HW]
        return _fill_runs(paint.reshape(B, H, W), rowrun, cid_bits + 1)

    def absorb_from_tables(packed_c_run, cur, size):
        g = paint_fill(packed_c_run)
        comp = g >> 1
        best = _ring_best(comp, (g & 1) == 1, nbr_idx, big, none)
        scanned = _seg_row_min(best, rowrun, hw_bits).reshape(B, HW)
        run_best = torch.where(valid, torch.gather(scanned, 1, last), none)
        comp_run = torch.where(valid, packed_c_run >> 1, C)
        target = table(C, none).scatter_reduce_(1, comp_run, run_best, reduce="amin")[:, :C]
        return _resolve(target, comp.reshape(B, HW), ident, cur, size, big, none, n_jumps)

    packed0 = torch.where(valid, (cid_c << 1) | small_raw_run.long(), 0)
    cur, size = absorb_from_tables(packed0, ident, size0)
    rounds = torch.ones(B, dtype=torch.long, device=dev)
    for _ in range(_MAX_MERGE_ROUNDS - 1):
        small_c = (size > 0) & (size < min_size)
        pending = small_c.any(dim=1)
        with annotate("cmt::sync.merge"):
            merging = bool(pending.any())
        if not merging:
            break
        rounds += pending
        packed_c = (cur << 1) | torch.gather(small_c, 1, cur).long()
        packed_run = torch.where(valid, torch.gather(packed_c, 1, cid_c), 0)
        cur, size = absorb_from_tables(packed_run, cur, size)

    live = size > 0
    rank_l = torch.cumsum(live.long(), dim=1) - 1
    if max_labels is not None:
        rank_l = torch.clamp(rank_l, max=max_labels - 1)
    label_run = torch.where(valid, torch.gather(torch.gather(rank_l, 1, cur), 1, cid_c), 0)
    out = paint_fill(label_run)
    return _extras(out, live.sum(1), rounds, is_root.sum(1),
                   return_count, return_rounds, return_raw_count)


def enforce_label_connectivity_batched(labels: torch.Tensor, n_segments: int,
                                       min_size_factor: float = 0.5,
                                       max_labels: int | None = None,
                                       run_bucket: int | None = None,
                                       max_components: int | None = None,
                                       return_fallback: bool = False,
                                       row_group=None):
    """Batched (B, H, W) connectivity, the JAX main path's entry: the
    per-pixel path's labels, which equal the run-structured path's to the
    bit (module docstring). ``return_fallback`` adds the JAX package's
    choice of path as a bool, True where it takes the per-pixel path: when
    an image's row-run count exceeds ``run_bucket`` (default H·W // 4; one
    host read of the largest count), or when the row-run offsets would
    overflow its int32 packing. Under a ``row_group`` the maps are gathered
    once and each rank keeps its rows (module docstring)."""
    kw = dict(n_segments=n_segments, min_size_factor=min_size_factor,
              max_labels=max_labels, max_components=max_components)
    if row_group is not None:
        return _whole_map(enforce_label_connectivity_batched, labels, row_group,
                          run_bucket=run_bucket, return_fallback=return_fallback, **kw)
    out = enforce_label_connectivity(labels, **kw)
    if not return_fallback:
        return out
    B, H, W = labels.shape
    HW = H * W
    R = min(HW, HW // 4 if run_bucket is None else run_bucket)
    cid_bits, hw_bits = _run_packing_bits(H, W, _bucket(H, W, n_segments, max_components))
    fallback = (W << (cid_bits + 2) >= 2 ** 31 or W << (hw_bits + 1) >= 2 ** 31
                or int(_row_run_starts(labels).sum(dim=(1, 2)).max()) > R)
    return out, fallback
