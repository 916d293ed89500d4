"""Weight carry-over between JAX parameter trees and the port's
``state_dict``s, both ways, for the region-graph, knowledge-graph and
fusion models.

Inputs are nested dicts of arrays as a ``.ckpt`` (:mod:`core.checkpoint`)
or flax ``init`` gives them. Layout rules:

* flax ``Dense`` kernels are (in, out) used as ``x @ kernel``; ``nn.Linear``
  weights are (out, in), so they are transposed;
* the attention weights ``wq/wk/wv/wo`` (E, E) are used as ``x @ w`` on
  both sides and kernel B2 reads that layout, so they are copied as is;
* the GAT kernel (in, heads, out) and attention vectors keep their layout;
* flax ``LayerNorm`` ``scale`` is torch's ``weight``; ``MaskedBatchNorm``
  ``scale``/``bias`` plus ``batch_stats`` ``mean``/``var`` become
  ``weight``/``bias``/``running_mean``/``running_var``.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from camouflage_multimodal_tpu_torch.ops.attention import PARAM_NAMES


def _t(a: Any) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _dense(prefix: str, p: Mapping) -> Dict[str, torch.Tensor]:
    return {f"{prefix}.weight": _t(p["kernel"]).T.contiguous(),
            f"{prefix}.bias": _t(p["bias"])}


def _norm(prefix: str, p: Mapping) -> Dict[str, torch.Tensor]:
    return {f"{prefix}.weight": _t(p["scale"]), f"{prefix}.bias": _t(p["bias"])}


def region_graph_state_dict(params: Mapping, batch_stats: Mapping
                            ) -> Dict[str, torch.Tensor]:
    """``RegionGraphGNN`` params + batch_stats → port ``RegionGraphGNN``."""
    sd = {
        "conv1.kernel": _t(params["gat_kernel"]),
        "conv1.att_src": _t(params["gat_att_src"]),
        "conv1.att_dst": _t(params["gat_att_dst"]),
        "conv1.bias": _t(params["gat_bias"]),
    }
    for j, i in enumerate((2, 3, 4)):
        sd[f"convs.{j}.lin.weight"] = _t(params[f"gcn{i}_kernel"]).T.contiguous()
        sd[f"convs.{j}.bias"] = _t(params[f"gcn{i}_bias"])
    for j in range(4):
        sd.update(_norm(f"bns.{j}", params[f"bn{j + 1}"]))
        sd[f"bns.{j}.running_mean"] = _t(batch_stats[f"bn{j + 1}"]["mean"])
        sd[f"bns.{j}.running_var"] = _t(batch_stats[f"bn{j + 1}"]["var"])
    sd.update(_dense("fc_shared", params["fc_shared"]))
    for name in ("mask", "instance", "edge"):
        sd.update(_dense(f"heads.{name}.0", params[f"fc_{name}_1"]))
        sd.update(_dense(f"heads.{name}.2", params[f"fc_{name}_2"]))
    return sd


def _arr(sd: Mapping[str, torch.Tensor], key: str) -> np.ndarray:
    return sd[key].detach().cpu().numpy().astype(np.float32)


def _dense_back(sd: Mapping[str, torch.Tensor], prefix: str) -> Dict[str, np.ndarray]:
    return {"kernel": np.ascontiguousarray(_arr(sd, f"{prefix}.weight").T),
            "bias": _arr(sd, f"{prefix}.bias")}


def _bn_back(sd: Mapping[str, torch.Tensor], prefix: str):
    """(params, batch_stats) leaves of one ``MaskedBatchNorm``."""
    return ({"scale": _arr(sd, f"{prefix}.weight"), "bias": _arr(sd, f"{prefix}.bias")},
            {"mean": _arr(sd, f"{prefix}.running_mean"), "var": _arr(sd, f"{prefix}.running_var")})


def region_graph_params_from_state_dict(sd: Mapping[str, torch.Tensor]):
    """Port ``RegionGraphGNN`` ``state_dict`` → (params, batch_stats) of the
    JAX ``RegionGraphGNN``, numpy leaves: the inverse of
    :func:`region_graph_state_dict`."""
    params: Dict[str, Any] = {
        "gat_kernel": _arr(sd, "conv1.kernel"),
        "gat_att_src": _arr(sd, "conv1.att_src"),
        "gat_att_dst": _arr(sd, "conv1.att_dst"),
        "gat_bias": _arr(sd, "conv1.bias"),
    }
    batch_stats: Dict[str, Any] = {}
    for j, i in enumerate((2, 3, 4)):
        params[f"gcn{i}_kernel"] = np.ascontiguousarray(_arr(sd, f"convs.{j}.lin.weight").T)
        params[f"gcn{i}_bias"] = _arr(sd, f"convs.{j}.bias")
    for j in range(4):
        params[f"bn{j + 1}"], batch_stats[f"bn{j + 1}"] = _bn_back(sd, f"bns.{j}")
    params["fc_shared"] = _dense_back(sd, "fc_shared")
    for name in ("mask", "instance", "edge"):
        params[f"fc_{name}_1"] = _dense_back(sd, f"heads.{name}.0")
        params[f"fc_{name}_2"] = _dense_back(sd, f"heads.{name}.2")
    return params, batch_stats


_KG_DENSE = ("embedding", "classifier_1", "classifier_2")


def knowledge_graph_state_dict(params: Mapping, batch_stats: Mapping
                               ) -> Dict[str, torch.Tensor]:
    """``KnowledgeGraphGNN`` params + batch_stats → port ``KnowledgeGraphGNN``."""
    sd: Dict[str, torch.Tensor] = {}
    for j in range(3):
        sd[f"convs.{j}.lin.weight"] = _t(params[f"gcn{j + 1}_kernel"]).T.contiguous()
        sd[f"convs.{j}.bias"] = _t(params[f"gcn{j + 1}_bias"])
        sd.update(_norm(f"bns.{j}", params[f"bn{j + 1}"]))
        sd[f"bns.{j}.running_mean"] = _t(batch_stats[f"bn{j + 1}"]["mean"])
        sd[f"bns.{j}.running_var"] = _t(batch_stats[f"bn{j + 1}"]["var"])
    for name in _KG_DENSE:
        sd.update(_dense(name, params[name]))
    return sd


def knowledge_graph_params_from_state_dict(sd: Mapping[str, torch.Tensor]):
    """The inverse of :func:`knowledge_graph_state_dict`: (params,
    batch_stats) of the JAX ``KnowledgeGraphGNN``, numpy leaves."""
    params: Dict[str, Any] = {}
    batch_stats: Dict[str, Any] = {}
    for j in range(3):
        params[f"gcn{j + 1}_kernel"] = np.ascontiguousarray(_arr(sd, f"convs.{j}.lin.weight").T)
        params[f"gcn{j + 1}_bias"] = _arr(sd, f"convs.{j}.bias")
        params[f"bn{j + 1}"], batch_stats[f"bn{j + 1}"] = _bn_back(sd, f"bns.{j}")
    for name in _KG_DENSE:
        params[name] = _dense_back(sd, name)
    return params, batch_stats


_FUSION_HEADS = ("mask_head", "instance_head", "edge_head", "score_head")


def _fusion_layout():
    """(kind, port key prefix, path in the JAX tree) of every parameter group
    a ``MultimodalCamouflageDetector`` can hold, cross-attention or late; a
    model has the rows its fusion type and widths give it."""
    rows = [("dense", f"fusion.{proj}", ("fusion", proj)) for proj in ("rg_proj", "kg_proj")]
    for attn in ("cross_attn_rg2kg", "cross_attn_kg2rg"):
        rows += [("raw", f"fusion.{attn}.{name}", ("fusion", attn, name))
                 for name in PARAM_NAMES]
    for side in ("rg", "kg"):
        rows.append(("norm", f"fusion.ln_{side}", ("fusion", f"ln_{side}")))
        rows += [("dense", f"fusion.ffn_{side}.{fc}", ("fusion", f"ffn_{side}", fc))
                 for fc in ("fc1", "fc2")]
    rows += [("dense", f"fusion.{name}", ("fusion", name))
             for name in ("fusion_1", "fusion_2", "fc1", "fc2", "fc3")]
    for head in _FUSION_HEADS:
        rows += [("dense", f"{head}.fc{i}", (f"{head}_{i}",)) for i in (1, 2)]
    return rows


def _lookup(tree: Mapping, path):
    for key in path:
        if not isinstance(tree, Mapping) or key not in tree:
            return None
        tree = tree[key]
    return tree


def fusion_state_dict(params: Mapping) -> Dict[str, torch.Tensor]:
    """``MultimodalCamouflageDetector`` params (cross-attention or late
    fusion) → port ``state_dict``."""
    sd: Dict[str, torch.Tensor] = {}
    for kind, prefix, path in _fusion_layout():
        node = _lookup(params, path)
        if node is None:
            continue
        if kind == "raw":
            sd[prefix] = _t(node)
        else:
            sd.update((_dense if kind == "dense" else _norm)(prefix, node))
    return sd


def fusion_params_from_state_dict(sd: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    """The reverse map: a port ``state_dict`` → the nested dict of numpy
    arrays the JAX ``MultimodalCamouflageDetector`` takes as ``params``, so
    a checkpoint the port trains is one the JAX package loads."""
    params: Dict[str, Any] = {}
    for kind, prefix, path in _fusion_layout():
        if kind == "raw":
            if prefix not in sd:
                continue
            leaf = _arr(sd, prefix)
        elif f"{prefix}.weight" not in sd:
            continue
        elif kind == "dense":
            leaf = _dense_back(sd, prefix)
        else:
            leaf = {"scale": _arr(sd, f"{prefix}.weight"), "bias": _arr(sd, f"{prefix}.bias")}
        node = params
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = leaf
    return params
