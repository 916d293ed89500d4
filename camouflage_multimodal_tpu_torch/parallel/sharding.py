"""The ``(data, model)`` mesh over ``torch.distributed``, port of
``camouflage_multimodal_tpu/parallel/sharding.py``.

The JAX package annotates arrays with a ``(data, model)`` mesh and lets
GSPMD insert the collectives. Here the mesh is a
``torch.distributed.device_mesh.DeviceMesh`` with the same two dimensions
over one process per card, and what GSPMD derived is written out.

The ``data`` axis (batch parallelism):

* each rank holds a contiguous block of every global batch
  (:func:`shard_batch`, ``P("data")``'s layout);
* sums that span the batch — loss normalizers, BatchNorm statistics —
  go through :func:`all_reduce_sum`, whose gradient is the all-reduce of
  the cotangent, and gradients are summed over the ranks
  (:func:`all_reduce_grads_`): each rank's loss is its share of the
  global loss;
* random draws over the batch (dropout, augmentation) are made for the
  global batch on every rank, from identically seeded generators, and
  each rank keeps its rows (:func:`rand_block`);
* results come back whole to every rank (:func:`gather_batch`).

The ``model`` axis (tensor parallelism of the fusion model,
:func:`shard_fusion_params`, JAX ``sharding.py:69-90``): model rank r of m
holds heads ``[r·H/m, (r+1)·H/m)`` of both cross-attentions — the columns
of ``wq, wk, wv`` and their biases, the rows of ``wo`` — and the matching
columns of each FFN's ``fc1`` and rows of its ``fc2``; everything else is
replicated. The modules declare that layout (``SHARD_DIMS`` in
``models/fusion.py``); this module only cuts and gathers. A sharded block takes its input through :func:`copy_to_model`
(identity forward, gradient summed over ``model``) and gives its output
through :func:`reduce_from_model` (summed over ``model`` forward, identity
backward), then adds the whole out-projection bias once. Draws over a
sharded activation are made for the whole activation and each rank keeps
its block (:func:`rand_block`), so m ranks draw what one rank draws.
:func:`gather_fusion_params` and :func:`unshard_fusion_params_` give the
whole weights back.

Spatial sharding of the region-graph build (:func:`shard_spatial`): image
rows over ``model``. Stencils read their neighbours' edge rows
(:func:`halo_rows`); the global passes gather (:func:`gather_dim`) or
all-reduce.

Every gather is an all-reduce (sum) of a zeroed buffer in which each rank
wrote its own entries, reinterpreted as bytes: a byte plus zeros is that
byte, so the gather is exact for any dtype, and one code path serves NCCL
on cards and gloo on the CPU or on a shared card (gloo's ``all_gather`` is
CPU-only; its ``all_reduce`` takes CUDA tensors).
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from camouflage_multimodal_tpu_torch.core.device import resolve_device


def make_mesh(devices: Optional[Any] = None, data_axis: Optional[int] = None,
              model_axis: int = 1) -> DeviceMesh:
    """A ``(data, model)`` mesh over the default process group.

    ``devices`` is the type of device the ranks compute on (``"cuda"``,
    ``"cpu"`` or a ``torch.device``); by default the card, which raises
    where there is none (:func:`core.device.resolve_device`). Without a
    process group, a group of one rank is made in-process (``gloo`` on the
    CPU, ``nccl`` on the card), so a world of 1 needs no launcher.
    ``data_axis · model_axis`` must be the world size; consecutive ranks
    share a data index (rank = data index · model_axis + model index)."""
    device_type = resolve_device("cuda" if devices is None else devices).type
    if model_axis < 1:
        raise ValueError(f"model_axis must be at least 1, got {model_axis}")
    if not dist.is_initialized():
        dist.init_process_group("nccl" if device_type == "cuda" else "gloo",
                                store=dist.HashStore(), rank=0, world_size=1)
    world = dist.get_world_size()
    if data_axis is None:
        data_axis = world // model_axis
    if data_axis * model_axis != world:
        raise ValueError(f"mesh {data_axis} x {model_axis} does not cover the "
                         f"{world} ranks of the process group")
    return init_device_mesh(device_type, (data_axis, model_axis),
                            mesh_dim_names=("data", "model"))


def mesh_shape(mesh: DeviceMesh) -> dict:
    """``{"data": n, "model": m}``, the JAX mesh's ``shape``."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def _check_mesh(mesh) -> None:
    if not isinstance(mesh, DeviceMesh) or mesh.mesh_dim_names != ("data", "model"):
        raise TypeError(f"expected a (data, model) DeviceMesh from make_mesh, got {mesh!r}")


def data_group(mesh: Optional[DeviceMesh]):
    """The process group of the mesh's ``data`` dimension (None for no
    mesh). Raises ``TypeError`` for anything but a :func:`make_mesh` mesh."""
    if mesh is None:
        return None
    _check_mesh(mesh)
    return mesh.get_group("data")


def model_group(mesh: Optional[DeviceMesh]):
    """The process group of the mesh's ``model`` dimension: the ranks that
    share this rank's data index. None for no mesh and for a ``model`` axis
    of 1 (nothing to shard). Raises ``TypeError`` for anything but a
    :func:`make_mesh` mesh."""
    if mesh is None:
        return None
    _check_mesh(mesh)
    if mesh_shape(mesh)["model"] == 1:
        return None
    return mesh.get_group("model")


def _block(n: int, group, what: str, axis: str) -> slice:
    if group is None:
        return slice(0, n)
    world, rank = dist.get_world_size(group), dist.get_rank(group)
    if n % world:
        raise ValueError(f"{what} of {n} does not divide over the mesh's {axis} axis ({world})")
    size = n // world
    return slice(rank * size, (rank + 1) * size)


def block(n: int, group) -> slice:
    """This rank's contiguous block of a leading (batch) axis of ``n`` (all
    of it for no group). Raises ``ValueError`` when ``n`` does not divide."""
    return _block(n, group, "a batch axis", "data")


def block_of(n: int, group) -> slice:
    """This rank's contiguous slice of a non-batch axis of ``n`` over
    ``group`` (all of it for no group): heads, hidden columns, image rows.
    Raises ``ValueError`` when ``n`` does not divide."""
    return _block(n, group, "an axis", "model")


def combine_(buf: torch.Tensor, group) -> torch.Tensor:
    """In place: the all-reduce of a buffer in which every rank wrote its
    own disjoint entries and zeros elsewhere, summed as bytes (exact for
    any dtype). ``buf`` for no group."""
    if group is None:
        return buf
    dist.all_reduce(buf.view(-1).view(torch.uint8), group=group)
    return buf


def gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """The whole leading axis on every rank from each rank's equal block
    (rank order), exact for any dtype. ``x`` itself for no group or a 0-d
    tensor."""
    if group is None or x.ndim == 0:
        return x
    world = dist.get_world_size(group)
    buf = torch.zeros((world * x.shape[0],) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    buf[block(buf.shape[0], group)] = x
    return combine_(buf, group)


def scatter_rows(x: torch.Tensor, rows: torch.Tensor, n: int, group) -> torch.Tensor:
    """(n, ...) on every rank from each rank's rows ``x`` at the global
    indices ``rows`` (disjoint across ranks, together covering [0, n))."""
    buf = torch.zeros((n,) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
    buf[rows] = x
    return buf if group is None else combine_(buf, group)


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree) if isinstance(tree, torch.Tensor) else tree


def shard_batch(tree: Any, mesh: DeviceMesh) -> Any:
    """This rank's contiguous block of the leading axis of every tensor
    leaf (0-d leaves kept whole). Raises ``ValueError`` when an axis does
    not divide over ``data``."""
    group = data_group(mesh)
    return _tree_map(lambda x: x if x.ndim == 0 else x[block(x.shape[0], group)], tree)


def gather_batch(tree: Any, mesh: DeviceMesh) -> Any:
    """Inverse of :func:`shard_batch`: every tensor leaf's whole leading
    axis on every rank."""
    group = data_group(mesh)
    return _tree_map(lambda x: gather_rows(x, group), tree)


def replicate(module_or_tensors: Any, mesh: DeviceMesh) -> Any:
    """In place: rank 0's parameters and buffers (of a module) or tensors
    (of a dict, list or tuple) on every rank, over the ``data`` and then
    the ``model`` dimension. Returns its argument."""
    if isinstance(module_or_tensors, torch.nn.Module):
        leaves: Iterable[torch.Tensor] = list(module_or_tensors.parameters()) + list(
            module_or_tensors.buffers())
    else:
        leaves = []
        _tree_map(leaves.append, module_or_tensors)
    for group in (data_group(mesh), model_group(mesh)):
        if group is None:
            continue
        src = dist.get_global_rank(group, 0)
        with torch.no_grad():
            for t in leaves:
                dist.broadcast(t.data, src=src, group=group)
    return module_or_tensors


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """Σ over the ranks of ``x``, on every rank; differentiable (the
    cotangent is all-reduced in turn). ``x`` itself for no group."""
    if group is None:
        return x
    return _AllReduceSum.apply(x, group)


def all_reduce_grads_(params: Iterable[torch.nn.Parameter], group) -> None:
    """In place: every gradient summed over the ranks, in one all-reduce
    of a flat buffer (a SUM, never a mean: each rank's loss is already its
    share of the global loss)."""
    grads = [p.grad for p in params if p.grad is not None]
    flat = torch._utils._flatten_dense_tensors(grads)
    dist.all_reduce(flat, group=group)
    for g, s in zip(grads, torch._utils._unflatten_dense_tensors(flat, grads)):
        g.copy_(s)


def rand_block(shape: Sequence[int], generator: Optional[torch.Generator], device,
               data_group=None, model_group=None, dim: int = -1) -> torch.Tensor:
    """``torch.rand(shape)`` for this rank's block of an activation: under a
    ``data_group`` the draw is made for the global batch (world ×
    ``shape[0]`` rows) and this rank keeps its rows; under a
    ``model_group`` (an activation split along ``dim``: heads, hidden
    columns) for the whole axis, and this rank keeps its block. The ranks'
    generators stay in step, and N ranks draw what one rank draws."""
    full = list(shape)
    for group, axis in ((data_group, 0), (model_group, dim)):
        if group is not None:
            full[axis] *= dist.get_world_size(group)
    draw = torch.rand(tuple(full), generator=generator, device=device)
    for group, axis in ((data_group, 0), (model_group, dim)):
        if group is not None:
            draw = draw.narrow(axis, dist.get_rank(group) * shape[axis], shape[axis])
    return draw


# ---------------------------------------------------------------------------
# The model axis: tensor parallelism of the fusion model
# ---------------------------------------------------------------------------

class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        y = x.contiguous().clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def copy_to_model(x: torch.Tensor, group) -> torch.Tensor:
    """The input of a block sharded over ``model``: ``x`` forward, its
    gradient summed over the ranks backward (each rank's block sees only
    its share of the heads or columns, so each holds a partial gradient).
    ``x`` itself for no group."""
    return x if group is None else _CopyToModel.apply(x, group)


def reduce_from_model(x: torch.Tensor, group) -> torch.Tensor:
    """The output of a block sharded over ``model``: the ranks' partials
    summed forward, the cotangent passed on unchanged backward (every rank
    holds the whole cotangent of the sum). Unlike :func:`all_reduce_sum`,
    which sums both ways, as a loss normalizer over ``data`` needs.
    ``x`` itself for no group."""
    return x if group is None else _ReduceFromModel.apply(x, group)


def shard_dims(model: torch.nn.Module) -> Dict[str, int]:
    """``{parameter name: axis}`` of every parameter of ``model`` split over
    ``model``: what the modules holding them declare in ``SHARD_DIMS`` (the
    fusion model's attention and FFN modules, ``models/fusion.py``); every
    other parameter is replicated."""
    return {f"{prefix}.{name}" if prefix else name: dim
            for prefix, m in model.named_modules()
            for name, dim in getattr(m, "SHARD_DIMS", {}).items()}


def shard_dim(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """This rank's block of ``x`` along ``dim`` (:func:`block_of`), as a
    tensor of its own."""
    part = block_of(x.shape[dim], group)
    return x.narrow(dim, part.start, part.stop - part.start).clone()


def gather_dim(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Inverse of :func:`shard_dim`: every rank's equal block along ``dim``,
    in rank order, on every rank; exact for any dtype. ``x`` itself for no
    group."""
    if group is None:
        return x
    return gather_rows(x.movedim(dim, 0).contiguous(), group).movedim(0, dim).contiguous()


def fusion_model_group(model: torch.nn.Module):
    """The ``model`` group a fusion model is sharded over (None when it is
    whole)."""
    for m in model.modules():
        group = getattr(m, "model_group", None)
        if group is not None:
            return group
    return None


def set_model_group(model: torch.nn.Module, group, shards: Optional[int] = None) -> None:
    """Every module of ``model`` that declares ``SHARD_DIMS`` computes over
    ``group`` (None: no group; the group may not outlive its caller, so a
    fit clears it whatever state the weights are in). ``shards``, when
    given, is how many shares their weights are now cut into; a module cut
    into shares with no group refuses to compute."""
    for m in model.modules():
        if hasattr(m, "SHARD_DIMS"):
            m.set_model_group(group, shards)


def shard_fusion_params(model: torch.nn.Module, mesh: DeviceMesh) -> torch.nn.Module:
    """In place: this rank's share of a ``MultimodalCamouflageDetector``
    over the mesh's ``model`` axis (:func:`shard_dims`), and its attention
    and FFN modules compute on that share from now on (module docstring). A
    ``model`` axis of 1 changes nothing. Raises ``ValueError`` when the
    heads or the FFN width do not divide. Call it on identical weights on
    every rank (after :func:`replicate`) and before building an optimizer.
    Returns ``model``."""
    group = model_group(mesh)
    if group is None:
        return model
    world = dist.get_world_size(group)
    for m in model.modules():
        heads = getattr(m, "num_heads", None)
        if hasattr(m, "SHARD_DIMS") and heads is not None and heads % world:
            raise ValueError(f"{heads} heads do not divide over the mesh's model axis ({world})")
    dims = shard_dims(model)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name in dims:
                p.data = shard_dim(p.data, dims[name], group)
    set_model_group(model, group, world)
    return model


def shard_fusion_state(model: torch.nn.Module, named: Dict[str, Any]) -> Dict[str, Any]:
    """Whole tensors (or arrays) by parameter name → this rank's share of
    each sharded one, for a model sharded by :func:`shard_fusion_params`
    (``named`` itself for a whole model). No collective."""
    group = fusion_model_group(model)
    if group is None:
        return named
    dims = shard_dims(model)
    return {name: shard_dim(torch.as_tensor(x), dims[name], group) if name in dims else x
            for name, x in named.items()}


def gather_fusion_state(model: torch.nn.Module,
                        named: Optional[Dict[str, torch.Tensor]] = None
                        ) -> Dict[str, torch.Tensor]:
    """Tensors by parameter name in the shapes of the (sharded) model — by
    default its ``state_dict`` — with every sharded one gathered whole, on
    every rank: the inverse of :func:`shard_fusion_state`. Every rank of
    the ``model`` group must call it."""
    named = dict(model.state_dict() if named is None else named)
    group = fusion_model_group(model)
    if group is None:
        return named
    dims = shard_dims(model)
    return {name: gather_dim(x, dims[name], group) if name in dims else x
            for name, x in named.items()}


def _each_moment(fn, model: torch.nn.Module, moments: Dict[str, Dict[str, Any]]):
    """``fn`` (:func:`gather_fusion_state` or :func:`shard_fusion_state`)
    applied to each of Adam's moments by parameter name; the step counts
    are kept."""
    out = {name: dict(st) for name, st in moments.items()}
    for key in ("exp_avg", "exp_avg_sq"):
        for name, x in fn(model, {n: st[key] for n, st in moments.items() if key in st}).items():
            out[name][key] = x
    return out


def gather_fusion_moments(model: torch.nn.Module, optimizer: torch.optim.Optimizer
                          ) -> Dict[str, Dict[str, torch.Tensor]]:
    """Adam's state by parameter name (``{"step", "exp_avg",
    "exp_avg_sq"}``), each sharded parameter's moments gathered whole as
    the parameter is (:func:`gather_fusion_state`)."""
    state = {name: optimizer.state[p] for name, p in model.named_parameters()
             if optimizer.state.get(p)}
    return _each_moment(gather_fusion_state, model, state)


def shard_fusion_moments(model: torch.nn.Module, moments: Dict[str, Dict[str, Any]]
                         ) -> Dict[str, Dict[str, Any]]:
    """Inverse of :func:`gather_fusion_moments` (a resume snapshot's whole
    moments → this rank's shares)."""
    return _each_moment(shard_fusion_state, model, moments)


def gather_fusion_params(model: torch.nn.Module) -> Dict[str, Any]:
    """The whole weights of a (sharded or whole) fusion model in the JAX
    package's layout, on every rank: what a checkpoint holds, the same tree
    a one-rank model gives. Every rank of the ``model`` group must call
    it."""
    from camouflage_multimodal_tpu_torch.convert import fusion_params_from_state_dict

    return fusion_params_from_state_dict(gather_fusion_state(model))


def unshard_fusion_params_(model: torch.nn.Module,
                           optimizer: Optional[torch.optim.Optimizer] = None) -> torch.nn.Module:
    """In place: the whole weights back on every rank (and, with an
    ``optimizer``, Adam's moments of each sharded parameter), and the model
    computes whole again. A whole model is left as it is. Returns
    ``model``."""
    if fusion_model_group(model) is None:
        return model
    moments = {} if optimizer is None else gather_fusion_moments(model, optimizer)
    params = dict(model.named_parameters())
    whole = gather_fusion_state(model, {name: p.data for name, p in params.items()})
    for name, p in params.items():
        p.data = whole[name]
        if name in moments:
            optimizer.state[p].update(moments[name])
    set_model_group(model, None, 1)
    return model


# ---------------------------------------------------------------------------
# Spatial sharding: image rows over the model axis
# ---------------------------------------------------------------------------

def shard_spatial(images: torch.Tensor, mesh: DeviceMesh) -> torch.Tensor:
    """This rank's block of image rows over ``model`` (and of the batch over
    ``data``) of (B, H, W, ...) images: ``P("data", "model")``'s layout.
    Raises ``ValueError`` when B or H does not divide."""
    images = shard_batch(images, mesh)
    return images[:, block_of(images.shape[1], model_group(mesh))]


def spatial_rows(rows: int, group) -> Tuple[slice, int]:
    """(the global rows this rank holds, the image's global height) for a
    block of ``rows`` rows over ``group`` (rank order is row order);
    ``(slice(0, rows), rows)`` for no group."""
    if group is None:
        return slice(0, rows), rows
    world, rank = dist.get_world_size(group), dist.get_rank(group)
    return slice(rank * rows, (rank + 1) * rows), rows * world


def halo_rows(x: torch.Tensor, depth: int, group, dim: int = 1) -> Tuple[torch.Tensor, int]:
    """``x``, this rank's block of rows along ``dim``, extended by ``depth``
    rows of each neighbour's block over ``group`` (rank order is row
    order), none beyond the image's global top and bottom edge, where a
    stencil pads as it would without sharding: returns ``(extended, top)``,
    ``top`` the number of rows added above (this rank's rows are
    ``extended[top:top + n]`` along ``dim``). One collective. ``(x, 0)``
    for no group; ``ValueError`` when a block is shorter than ``depth``."""
    if group is None:
        return x, 0
    world, rank = dist.get_world_size(group), dist.get_rank(group)
    n = x.shape[dim]
    if depth > n:
        raise ValueError(f"a halo of {depth} rows needs blocks of at least that many, "
                         f"got {n}")
    edges = torch.stack([x.narrow(dim, 0, depth), x.narrow(dim, n - depth, depth)])
    buf = torch.zeros((world,) + tuple(edges.shape), dtype=x.dtype, device=x.device)
    buf[rank] = edges
    combine_(buf, group)
    parts = [buf[rank - 1, 1]] if rank > 0 else []
    parts.append(x)
    if rank < world - 1:
        parts.append(buf[rank + 1, 0])
    return torch.cat(parts, dim=dim), depth if rank > 0 else 0


def all_reduce_(x: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """In place: ``x`` reduced over ``group`` with ``op`` (``x`` for no
    group). Not differentiable; the graph build's sums and ORs."""
    if group is not None:
        dist.all_reduce(x, op=op, group=group)
    return x
