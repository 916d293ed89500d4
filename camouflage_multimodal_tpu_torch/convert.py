"""Weight carry-over: JAX parameter trees → the port's ``state_dict``s.

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


def fusion_state_dict(params: Mapping) -> Dict[str, torch.Tensor]:
    """``MultimodalCamouflageDetector`` (cross-attention) params → port."""
    f = params["fusion"]
    sd: Dict[str, torch.Tensor] = {}
    for proj in ("rg_proj", "kg_proj"):
        if proj in f:
            sd.update(_dense(f"fusion.{proj}", f[proj]))
    for attn in ("cross_attn_rg2kg", "cross_attn_kg2rg"):
        for name in PARAM_NAMES:
            sd[f"fusion.{attn}.{name}"] = _t(f[attn][name])
    for side in ("rg", "kg"):
        sd.update(_norm(f"fusion.ln_{side}", f[f"ln_{side}"]))
        sd.update(_dense(f"fusion.ffn_{side}.fc1", f[f"ffn_{side}"]["fc1"]))
        sd.update(_dense(f"fusion.ffn_{side}.fc2", f[f"ffn_{side}"]["fc2"]))
    sd.update(_dense("fusion.fusion_1", f["fusion_1"]))
    sd.update(_dense("fusion.fusion_2", f["fusion_2"]))
    for head in ("mask_head", "instance_head", "edge_head", "score_head"):
        sd.update(_dense(f"{head}.0", params[f"{head}_1"]))
        sd.update(_dense(f"{head}.2", params[f"{head}_2"]))
    return sd
