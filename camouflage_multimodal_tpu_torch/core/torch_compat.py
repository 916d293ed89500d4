"""The reference's torch checkpoints (``.pth`` / ``.pt``) → the port's models.

Port of ``camouflage_multimodal_tpu/core/torch_compat.py``. A reference
state dict is first put in the JAX package's layout as numpy arrays (the
same transposes and reshapes as there), and :mod:`convert` takes it from
there to the port's ``state_dict``s, so there is one weight mapping per
model and the JAX trees of both packages agree to the bit.

Reference formats:

* Region-graph: a bare ``state_dict`` of PyG ``GATConv`` / ``GCNConv`` +
  ``BatchNorm1d`` + ``Linear`` tensors.
* Knowledge-graph: ``{'model_state_dict', 'embedding_dim', ...}``.
* Multimodal fusion: ``{'model_state_dict', 'config', 'epoch', ...}`` in two
  generations, with ``val_acc`` / ``balanced_acc`` or with
  ``val_f1_class_1`` / ``val_acc_0``; cross-attention or late fusion.

Layout (torch → JAX): ``Linear.weight`` (out, in) → ``kernel`` (in, out);
``MultiheadAttention.in_proj_weight`` (3E, E) → ``wq/wk/wv`` (E, E) each
transposed, ``out_proj`` → ``wo/bo``; ``GATConv.lin.weight`` (heads·H, in)
→ (in, heads, H); ``att_src/att_dst`` (1, heads, H) → (heads, H);
``BatchNorm1d`` → ``scale/bias`` params + ``mean/var`` batch stats.
"""

from __future__ import annotations

import pickle
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch


def _np(t) -> np.ndarray:
    """torch.Tensor or array-like → float32 numpy array."""
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu().numpy()
    return np.asarray(t, np.float32)


def _dense(sd: Dict[str, Any], prefix: str) -> Dict[str, np.ndarray]:
    return {"kernel": _np(sd[f"{prefix}.weight"]).T,
            "bias": _np(sd[f"{prefix}.bias"])}


def _batchnorm(sd: Dict[str, Any], prefix: str) -> Tuple[Dict, Dict]:
    params = {"scale": _np(sd[f"{prefix}.weight"]), "bias": _np(sd[f"{prefix}.bias"])}
    stats = {"mean": _np(sd[f"{prefix}.running_mean"]),
             "var": _np(sd[f"{prefix}.running_var"])}
    return params, stats


def _first_key(sd: Dict[str, Any], *candidates: str) -> str:
    for key in candidates:
        if key in sd:
            return key
    raise KeyError(f"none of {candidates} in checkpoint (keys: {sorted(sd)[:8]}...)")


def _mha(sd: Dict[str, Any], prefix: str) -> Dict[str, np.ndarray]:
    """torch ``nn.MultiheadAttention`` → the attention parameter dict."""
    ipw = _np(sd[f"{prefix}.in_proj_weight"])
    ipb = _np(sd[f"{prefix}.in_proj_bias"])
    E = ipw.shape[1]
    return {
        "wq": ipw[:E].T, "wk": ipw[E:2 * E].T, "wv": ipw[2 * E:].T,
        "bq": ipb[:E], "bk": ipb[E:2 * E], "bv": ipb[2 * E:],
        "wo": _np(sd[f"{prefix}.out_proj.weight"]).T,
        "bo": _np(sd[f"{prefix}.out_proj.bias"]),
    }


def import_rg_state_dict(sd: Dict[str, Any]) -> Dict[str, Any]:
    """PyG ``RegionGraphGNN`` state dict → ``{'params', 'batch_stats'}``."""
    heads_lin = _np(sd[_first_key(sd, "conv1.lin.weight", "conv1.lin_src.weight")])
    att_src = _np(sd[_first_key(sd, "conv1.att_src", "conv1.att_l")])
    heads, H = att_src.shape[-2], att_src.shape[-1]
    params: Dict[str, Any] = {
        # (heads·H, in) → (in, heads·H) → (in, heads, H): PyG views the
        # projected features row-major as (N, heads, H).
        "gat_kernel": heads_lin.T.reshape(-1, heads, H),
        "gat_att_src": att_src.reshape(heads, H),
        "gat_att_dst": _np(sd[_first_key(sd, "conv1.att_dst", "conv1.att_r")]).reshape(heads, H),
        "gat_bias": _np(sd["conv1.bias"]),
    }
    batch_stats: Dict[str, Any] = {}
    for i in (1, 2, 3, 4):
        if i > 1:
            lin = _first_key(sd, f"conv{i}.lin.weight", f"conv{i}.weight")
            params[f"gcn{i}_kernel"] = _np(sd[lin]).T
            params[f"gcn{i}_bias"] = _np(sd[f"conv{i}.bias"])
        params[f"bn{i}"], batch_stats[f"bn{i}"] = _batchnorm(sd, f"bn{i}")
    for name in ("fc_shared", "fc_mask_1", "fc_mask_2", "fc_instance_1",
                 "fc_instance_2", "fc_edge_1", "fc_edge_2"):
        params[name] = _dense(sd, name)
    return {"params": params, "batch_stats": batch_stats}


def import_kg_state_dict(sd: Dict[str, Any]) -> Dict[str, Any]:
    """PyG ``KnowledgeGraphGNN`` state dict → ``{'params', 'batch_stats'}``."""
    params: Dict[str, Any] = {}
    batch_stats: Dict[str, Any] = {}
    for i in (1, 2, 3):
        lin = _first_key(sd, f"conv{i}.lin.weight", f"conv{i}.weight")
        params[f"gcn{i}_kernel"] = _np(sd[lin]).T
        params[f"gcn{i}_bias"] = _np(sd[f"conv{i}.bias"])
        params[f"bn{i}"], batch_stats[f"bn{i}"] = _batchnorm(sd, f"bn{i}")
    params["embedding"] = _dense(sd, "embedding_layer.0")
    params["classifier_1"] = _dense(sd, "classifier.0")
    params["classifier_2"] = _dense(sd, "classifier.3")
    return {"params": params, "batch_stats": batch_stats}


def import_fusion_state_dict(sd: Dict[str, Any]) -> Dict[str, Any]:
    """``MultimodalCamouflageDetector`` state dict (cross-attention or late
    fusion) → ``{'params'}``. The cross-attention projections ``rg_proj`` /
    ``kg_proj`` are ``nn.Identity`` when the widths already match; their
    keys are then absent on both sides."""
    fusion: Dict[str, Any] = {}
    if "fusion.fusion.0.weight" in sd:          # late fusion MLP
        for seq_idx, name in ((0, "fc1"), (3, "fc2"), (6, "fc3")):
            fusion[name] = _dense(sd, f"fusion.fusion.{seq_idx}")
    else:                                       # cross-attention
        for proj in ("rg_proj", "kg_proj"):
            if f"fusion.{proj}.weight" in sd:
                fusion[proj] = _dense(sd, f"fusion.{proj}")
        for attn in ("cross_attn_rg2kg", "cross_attn_kg2rg"):
            fusion[attn] = _mha(sd, f"fusion.{attn}")
        for ln in ("ln_rg", "ln_kg"):
            fusion[ln] = {"scale": _np(sd[f"fusion.{ln}.weight"]),
                          "bias": _np(sd[f"fusion.{ln}.bias"])}
        for ffn in ("ffn_rg", "ffn_kg"):
            fusion[ffn] = {"fc1": _dense(sd, f"fusion.{ffn}.0"),
                           "fc2": _dense(sd, f"fusion.{ffn}.3")}
        fusion["fusion_1"] = _dense(sd, "fusion.fusion_layer.0")
        fusion["fusion_2"] = _dense(sd, "fusion.fusion_layer.3")
    params: Dict[str, Any] = {"fusion": fusion}
    for head in ("mask_head", "instance_head", "edge_head", "score_head"):
        params[f"{head}_1"] = _dense(sd, f"{head}.0")
        params[f"{head}_2"] = _dense(sd, f"{head}.3")
    return {"params": params}


_RG_MARKERS = ("conv1.att_src", "conv1.att_l")


def detect_state_dict_kind(sd: Dict[str, Any]) -> str:
    if any(k in sd for k in _RG_MARKERS):
        return "region_graph"
    if "embedding_layer.0.weight" in sd:
        return "knowledge_graph"
    if any(k.startswith("mask_head.") for k in sd):
        return "fusion"
    raise ValueError(f"unrecognized torch state_dict (keys: {sorted(sd)[:8]}...)")


def _numpy_scalar_globals() -> list:
    """What a pickled numpy scalar (a metric a library returned as
    ``np.float64``, say) refers to: the scalar constructor, ``np.dtype`` and
    the dtype classes. None of them runs code of the file's choosing."""
    core = getattr(np, "_core", None) or np.core
    names = [core.multiarray.scalar, np.dtype]
    dtypes = getattr(np, "dtypes", None)
    if dtypes is not None:
        names += [getattr(dtypes, n) for n in dir(dtypes) if n.endswith("DType")]
    return names


def torch_load(path: str) -> Any:
    """``torch.load`` on the CPU with ``weights_only=True``: tensors,
    containers, plain and numpy scalars, and no other object is built, so
    no code of the file's runs. Every reference checkpoint and store
    loads that way; a file that needs more is refused with its name."""
    try:
        with torch.serialization.safe_globals(_numpy_scalar_globals()):
            return torch.load(path, map_location="cpu", weights_only=True)
    except pickle.UnpicklingError as err:
        raise ValueError(f"{path} holds objects other than tensors, containers and "
                         f"scalars; it is not loaded: {err}") from None


def load_torch_checkpoint(path: str, kind: Optional[str] = None
                          ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """A reference ``.pth`` / ``.pt`` checkpoint → ``(variables, meta)``:
    ``variables`` the JAX package's ``{'params'[, 'batch_stats']}`` tree
    with numpy leaves (what :mod:`convert` takes), ``meta`` the file's
    bookkeeping (epoch, config, the validation metrics of either
    generation) plus ``kind``."""
    blob = torch_load(path)
    meta: Dict[str, Any] = {}
    if isinstance(blob, dict) and "model_state_dict" in blob:
        sd = blob["model_state_dict"]
        meta = {k: v for k, v in blob.items()
                if k not in ("model_state_dict", "optimizer_state_dict")}
    else:
        sd = blob                       # a bare state dict (region-graph)
    sd = dict(sd)
    kind = kind or detect_state_dict_kind(sd)
    importer = {"region_graph": import_rg_state_dict,
                "knowledge_graph": import_kg_state_dict,
                "fusion": import_fusion_state_dict}[kind]
    meta["kind"] = kind
    return importer(sd), meta
