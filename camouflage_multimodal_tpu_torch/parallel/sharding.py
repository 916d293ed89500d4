"""Data parallelism over ``torch.distributed``, port of the ``data`` axis of
``camouflage_multimodal_tpu/parallel/sharding.py``.

The JAX package annotates arrays with a ``(data, model)`` mesh and lets
GSPMD insert the collectives. Here the mesh is a
``torch.distributed.device_mesh.DeviceMesh`` with the same two dimensions
over one process per card, and what GSPMD derived is written out:

* each rank holds a contiguous block of every global batch
  (:func:`shard_batch`, ``P("data")``'s layout);
* sums that span the batch — loss normalizers, BatchNorm statistics —
  go through :func:`all_reduce_sum`, whose gradient is the all-reduce of
  the cotangent, and gradients are summed over the ranks
  (:func:`all_reduce_grads_`): each rank's loss is its share of the
  global loss;
* random draws over the batch (dropout, augmentation) are made for the
  global batch on every rank, from identically seeded generators, and
  each rank keeps its rows (:func:`rand_rows`);
* results come back whole to every rank (:func:`gather_batch`).

Every gather is an all-reduce (sum) of a zeroed buffer in which each rank
wrote its own entries, reinterpreted as bytes: a byte plus zeros is that
byte, so the gather is exact for any dtype, and one code path serves NCCL
on cards and gloo on the CPU or on a shared card (gloo's ``all_gather`` is
CPU-only; its ``all_reduce`` takes CUDA tensors).

The ``model`` axis (tensor-sharded fusion attention and FFN) and spatial
sharding of image rows are not ported: :func:`shard_fusion_params`,
:func:`shard_spatial` and ``make_mesh(model_axis > 1)`` raise.
"""

from __future__ import annotations

from typing import Any, Iterable, Optional, Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

MODEL_AXIS_ITEM = "ROADMAP Queue A item 9, the model axis"
SPATIAL_ITEM = "ROADMAP Queue A item 10, spatial sharding"


def make_mesh(devices: Optional[Any] = None, data_axis: Optional[int] = None,
              model_axis: int = 1) -> DeviceMesh:
    """A ``(data, model)`` mesh over the default process group.

    ``devices`` is the type of device the ranks compute on (``"cuda"``,
    ``"cpu"`` or a ``torch.device``); by default the card where there is
    one. Without a process group, a group of one rank is made in-process
    (``gloo`` on the CPU, ``nccl`` on the card), so a world of 1 needs no
    launcher. ``data_axis · model_axis`` must be the world size."""
    if model_axis != 1:
        raise NotImplementedError(f"model_axis={model_axis}: tensor sharding is not "
                                  f"ported yet ({MODEL_AXIS_ITEM})")
    if devices is None:
        device_type = "cuda" if torch.cuda.is_available() else "cpu"
    else:
        device_type = torch.device(devices).type
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


def data_group(mesh: Optional[DeviceMesh]):
    """The process group of the mesh's ``data`` dimension (None for no
    mesh). Raises ``TypeError`` for anything but a :func:`make_mesh` mesh."""
    if mesh is None:
        return None
    if not isinstance(mesh, DeviceMesh) or mesh.mesh_dim_names != ("data", "model"):
        raise TypeError(f"expected a (data, model) DeviceMesh from make_mesh, got {mesh!r}")
    return mesh.get_group("data")


def block(n: int, group) -> slice:
    """This rank's contiguous block of a leading axis of ``n`` (all of it
    for no group). Raises ``ValueError`` when ``n`` does not divide."""
    if group is None:
        return slice(0, n)
    world, rank = dist.get_world_size(group), dist.get_rank(group)
    if n % world:
        raise ValueError(f"a batch axis of {n} does not divide over the mesh's "
                         f"data axis ({world})")
    size = n // world
    return slice(rank * size, (rank + 1) * size)


def _combine_(buf: torch.Tensor, group) -> torch.Tensor:
    """In place: the all-reduce of a buffer in which every rank wrote its
    own disjoint entries and zeros elsewhere, summed as bytes."""
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
    return _combine_(buf, group)


def scatter_rows(x: torch.Tensor, rows: torch.Tensor, n: int, group) -> torch.Tensor:
    """(n, ...) on every rank from each rank's rows ``x`` at the global
    indices ``rows`` (disjoint across ranks, together covering [0, n))."""
    buf = torch.zeros((n,) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
    buf[rows] = x
    return buf if group is None else _combine_(buf, group)


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
    (of a dict, list or tuple) on every rank. Returns its argument."""
    group = data_group(mesh)
    if isinstance(module_or_tensors, torch.nn.Module):
        leaves: Iterable[torch.Tensor] = list(module_or_tensors.parameters()) + list(
            module_or_tensors.buffers())
    else:
        leaves = []
        _tree_map(leaves.append, module_or_tensors)
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


def rand_rows(shape: Sequence[int], generator: Optional[torch.Generator],
              device, group) -> torch.Tensor:
    """``torch.rand(shape)``; under a group, this rank's rows of the draw
    for the global batch (world × ``shape[0]`` rows), so the ranks'
    generators stay in step and N ranks draw what one rank draws."""
    if group is None:
        return torch.rand(tuple(shape), generator=generator, device=device)
    world, rank = dist.get_world_size(group), dist.get_rank(group)
    rows = shape[0]
    full = torch.rand((world * rows,) + tuple(shape[1:]), generator=generator, device=device)
    return full[rank * rows:(rank + 1) * rows]


def shard_spatial(images: torch.Tensor, mesh: DeviceMesh) -> torch.Tensor:
    """Image rows over ``model``: needs halo exchanges for the stencils and
    collectives for connectivity and the segment sums. Not ported."""
    raise NotImplementedError(f"spatial sharding is not ported yet ({SPATIAL_ITEM})")


def shard_fusion_params(params: Any, mesh: DeviceMesh) -> Any:
    """The fusion's attention and FFN kernels over ``model``: needs B2 and
    B3 on a subset of the heads per rank and all-reduces of the
    head-averaged probabilities and the out-projection partials. Not
    ported."""
    raise NotImplementedError(f"tensor sharding is not ported yet ({MODEL_AXIS_ITEM})")
