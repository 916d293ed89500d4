"""End-to-end mask-fidelity gate of the port against the reference side.

Port of the JAX system's ``scripts/fidelity_gate.py``, with its stages,
options, defaults and report keys:

1. ``graphs`` — region graphs of the train and test images built by the
   reference-side executor (the repo's ``tools/reference_pipeline.py``:
   canonical SLIC with skimage's knobs, skimage-style Canny, the
   reference's 15-feature loop), cached as npz.
2. ``train`` — the reference ``RegionGraphGNN`` (``tools/reference_impl.py``)
   trained by the reference's own recipe (AdamW 1e-3 / 1e-4, cosine warm
   restarts T0 = 10, T_mult = 2, CE weights [1, pos_weight] / [1, 4], BCE
   pos_weight 3, task weights 2 / 1 / 0.5, clip 1.0, batch 4 as one
   block-diagonal graph, 80/20 split, best-val checkpoint).
3. ``compare`` — the trained torch weights loaded into the port's
   ``RegionGraphPipeline(..., feature_norm=256)``, which runs on the card
   (kernel B1), against ``reference_heatmap`` on the cached graphs of the
   held-out images: per-pixel agreement of the binary masks under both
   paint-backs, heatmap MAE, the threshold sweep with its degeneracy guard,
   the per-category table, IoU against the CAM images' GT, and the
   model-only split (the torch model on the port's own graphs, their
   adjacency rebuilt by the port's ``ops.rag``).
4. ``fusion-train`` / ``fusion-compare`` — the reference's own
   ``fusion_model.py`` (``reference_impl.load_reference_fusion_module``)
   trained by its recipe on the torch RG model's node embeddings, then the
   port's ``MultimodalPredictor`` on the same ``.pth`` weights against it.
   A 256-only protocol, as in the JAX script.

The reference side runs where the JAX script runs it: torch on the CPU.
The repo's ``tools/`` goes on ``sys.path`` inside the stages that use it.

Where it reads and writes (the JAX script writes under ``artifacts/``
relative to the working directory):

* images and GT: ``REF_DATA`` (COD10K's layout: ``images/*.jpg``,
  ``gt_object/``, ``gt_instance/``, ``gt_edge/``), by default
  ``data/COD10K`` of the working directory (run from the reference
  checkout, or point the constant at a tree);
* outputs under ``--out`` (default ``artifacts/torch_port/`` of the repo),
  with the JAX names below it: ``fidelity/graphs[_<size>]/``,
  ``fidelity/best_model[_<size>].pth`` (+ ``.config.json``),
  ``fidelity/region_graph_model.pth``, ``fidelity/multimodal_best.pth``,
  ``fidelity_report[_<size>].json``, ``fidelity_fusion_report.json``;
* weights a stage did not train in this root are read from the repo's
  committed ``artifacts/fidelity/``; the KG embeddings from the repo's
  ``artifacts/kg_embeddings/all_embeddings.npz``.

    python -m camouflage_multimodal_tpu_torch.scripts.fidelity_gate \\
        [--stage all|graphs|train|compare|fusion-train|fusion-compare] \\
        [--n-train 120] [--n-test 200] [--epochs 30] [--size 256] [--out DIR]
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
import time
from collections import Counter, defaultdict

import numpy as np
import torch

from camouflage_multimodal_tpu_torch.core.device import resolve_device
from camouflage_multimodal_tpu_torch.data.cod10k import load_image_rgb, load_mask

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
TOOLS = os.path.join(REPO, "tools")
REF_DATA = os.path.join("data", "COD10K")
OUT = os.path.join(REPO, "artifacts", "torch_port")
COMMITTED = os.path.join(REPO, "artifacts")
KG_EMBEDDINGS = os.path.join(COMMITTED, "kg_embeddings", "all_embeddings.npz")
BATCH = 10          # the compare stage's pipeline batch


def reference_side() -> None:
    """Put the repo's ``tools/`` on ``sys.path``: the reference side both
    packages are held against."""
    if TOOLS not in sys.path:
        sys.path.insert(0, TOOLS)


def fidelity_dir(out: str) -> str:
    return os.path.join(out, "fidelity")


def cache_dir(size: int, out: str = OUT) -> str:
    """Per-resolution reference-graph cache (256 keeps the JAX layout)."""
    cache = os.path.join(fidelity_dir(out), "graphs")
    return cache if size == 256 else f"{cache}_{size}"


def weights(name: str, out: str = OUT) -> str:
    """``fidelity/<name>`` of the output root when a stage wrote it there,
    else the repo's committed one."""
    mine = os.path.join(fidelity_dir(out), name)
    return mine if os.path.exists(mine) else os.path.join(COMMITTED, "fidelity", name)


def category_of(base: str) -> str:
    """COD10K environment token (CAM images) or 'NonCAM'."""
    parts = base.split("-")
    if len(parts) > 3 and parts[1] == "CAM":
        return parts[3]
    return "NonCAM"


def _all_quadruples():
    names = []
    for p in sorted(glob.glob(os.path.join(REF_DATA, "images", "*.jpg"))):
        base = os.path.splitext(os.path.basename(p))[0]
        gt = [os.path.join(REF_DATA, d, base + ".png")
              for d in ("gt_object", "gt_instance", "gt_edge")]
        if all(os.path.exists(g) for g in gt):
            names.append((base, p, *gt))
    return names


def quadruples(n_train: int, n_test: int, split: str = "stratified"):
    """Train/test lists of (base, image, object, instance, edge) paths.

    ``stratified``: interleaved strides over the whole sorted listing, so
    both splits span every environment and the NonCAM tail; the test
    offsets sit halfway between the train strides (disjoint by
    construction). ``sorted``: the first ``n_train``, then the next
    ``n_test``."""
    names = _all_quadruples()
    if split == "sorted":
        return names[:n_train], names[n_train:n_train + n_test]
    N = len(names)
    tr_stride = max(N // n_train, 1)
    te_stride = max(N // n_test, 1)
    tr_idx = list(range(0, N, tr_stride))[:n_train]
    used = set(tr_idx)
    te_off = tr_stride // 2
    te_idx = [i for i in range(te_off, N, te_stride) if i not in used][:n_test]
    train = [names[i] for i in tr_idx]
    test = [names[i] for i in te_idx]
    print("train categories:", dict(Counter(category_of(b) for b, *_ in train)))
    print("test categories:", dict(Counter(category_of(b) for b, *_ in test)))
    return train, test


def stage_graphs(samples, n_segments: int = 500, size: int = 256, out: str = OUT) -> None:
    reference_side()
    from reference_pipeline import build_reference_graph, node_labels_np

    cache = cache_dir(size, out)
    os.makedirs(cache, exist_ok=True)
    t0 = time.time()
    for i, (base, img_p, mask_p, inst_p, edge_p) in enumerate(samples):
        path = os.path.join(cache, base + ".npz")
        if os.path.exists(path):
            continue
        img = load_image_rgb(img_p, size).astype(np.float64)
        g = build_reference_graph(img, n_segments)
        labels = node_labels_np(g, load_mask(mask_p, size), load_mask(inst_p, size),
                                load_mask(edge_p, size))
        np.savez_compressed(
            path, features=g["features"], adjacency=g["adjacency"],
            weights=g["weights"], segments=g["segments"],
            id_map_keys=np.asarray(sorted(g["id_map"], key=g["id_map"].get)),
            **labels)
        if (i + 1) % 10 == 0:
            rate = (time.time() - t0) / (i + 1)
            print(f"[graphs] {i + 1}/{len(samples)} ({rate:.1f}s/img)", flush=True)


def _load_graph(base: str, size: int = 256, out: str = OUT):
    z = np.load(os.path.join(cache_dir(size, out), base + ".npz"))
    id_map = {int(k): i for i, k in enumerate(z["id_map_keys"])}
    return {k: z[k] for k in z.files if k != "id_map_keys"} | {"id_map": id_map}


def _block_batch(graphs):
    """PyG-style block-diagonal batch: one dense graph, BN over all nodes."""
    x = torch.tensor(np.concatenate([g["features"] for g in graphs]))
    adj = torch.block_diag(*[torch.tensor(g["adjacency"]).float() for g in graphs])
    w = torch.block_diag(*[torch.tensor(g["weights"]) for g in graphs])
    y = torch.tensor(np.concatenate([g["y"] for g in graphs]))
    iy = torch.tensor(np.concatenate([g["instance_y"] for g in graphs]))
    ey = torch.tensor(np.concatenate([g["edge_y"] for g in graphs]))
    return x, adj, w, y, iy, ey


def _rg_name(size: int) -> str:
    """Per-resolution probe weights: the reference normalises position and
    area features by a hard-coded 256, so weights trained at 256² are off
    distribution at any other size and the gate trains them at the size it
    measures."""
    return "best_model.pth" if size == 256 else f"best_model_{size}.pth"


def stage_train(train_samples, epochs: int = 30, batch_size: int = 4, lr: float = 1e-3,
                seed: int = 0, size: int = 256, pos_weight: float = 5.0,
                out: str = OUT) -> None:
    """Train the shared probe weights by the reference's recipe
    (``pos_weight`` 5.0 is the recipe verbatim; raise it at other sizes,
    where the /256 features leave the recipe's probabilities diffuse)."""
    reference_side()
    from reference_impl import RefRegionGraphGNN

    graphs = [_load_graph(b, size, out) for b, *_ in train_samples]
    torch.manual_seed(seed)
    rng = np.random.default_rng(seed)
    n_train = int(0.8 * len(graphs))
    perm = rng.permutation(len(graphs))
    tr, va = [graphs[i] for i in perm[:n_train]], [graphs[i] for i in perm[n_train:]]

    model = RefRegionGraphGNN()
    opt = torch.optim.AdamW(model.parameters(), lr=lr, weight_decay=1e-4)
    sched = torch.optim.lr_scheduler.CosineAnnealingWarmRestarts(opt, T_0=10, T_mult=2)
    crit_mask = torch.nn.CrossEntropyLoss(weight=torch.tensor([1.0, pos_weight]))
    crit_inst = torch.nn.CrossEntropyLoss(weight=torch.tensor([1.0, 4.0]))
    crit_edge = torch.nn.BCEWithLogitsLoss(pos_weight=torch.tensor([3.0]))
    tw = {"mask": 2.0, "instance": 1.0, "edge": 0.5}

    def run_batches(batch_graphs, train):
        model.train(train)
        total, correct, count = 0.0, 0, 0
        order = rng.permutation(len(batch_graphs)) if train else np.arange(len(batch_graphs))
        for s in range(0, len(order), batch_size):
            chunk = [batch_graphs[i] for i in order[s:s + batch_size]]
            x, adj, w, y, iy, ey = _block_batch(chunk)
            with torch.set_grad_enabled(train):
                mo, io, eo = model(x, adj, w)
                loss = (crit_mask(mo, y) * tw["mask"]
                        + crit_inst(io, iy) * tw["instance"]
                        + crit_edge(eo.squeeze(-1), ey) * tw["edge"])
            if train:
                opt.zero_grad()
                loss.backward()
                torch.nn.utils.clip_grad_norm_(model.parameters(), max_norm=1.0)
                opt.step()
            total += float(loss.detach())
            correct += int((mo.argmax(1) == y).sum())
            count += len(y)
        return total / max(1, (len(order) + batch_size - 1) // batch_size), 100 * correct / count

    ckpt = os.path.join(fidelity_dir(out), _rg_name(size))
    os.makedirs(fidelity_dir(out), exist_ok=True)
    best = float("inf")
    t0 = time.time()
    for epoch in range(epochs):
        tr_loss, tr_acc = run_batches(tr, True)
        sched.step()
        va_loss, va_acc = run_batches(va, False)
        print(f"[train] epoch {epoch + 1}/{epochs} loss {tr_loss:.4f} mask {tr_acc:.1f}% "
              f"| val {va_loss:.4f} mask {va_acc:.1f}% ({time.time() - t0:.0f}s)", flush=True)
        if va_loss < best:
            best = va_loss
            torch.save(model.state_dict(), ckpt)
    with open(ckpt + ".config.json", "w") as f:
        json.dump({"epochs": epochs, "batch_size": batch_size, "lr": lr,
                   "seed": seed, "size": size, "pos_weight": pos_weight,
                   "reference_recipe_verbatim": pos_weight == 5.0}, f)
    if size == 256:
        torch.save(model.state_dict(), os.path.join(fidelity_dir(out), "region_graph_model.pth"))


def _mean(values) -> float:
    return float(np.mean(values))


def stage_compare(test_samples, n_segments: int = 500, size: int = 256, out: str = OUT,
                  device: str | torch.device = "cuda") -> dict:
    """The port's pipeline on ``device`` against the reference side; writes
    and returns the report. The pipeline runs the held-out images in
    batches of ``BATCH`` (unpadded: the port runs eagerly, each image on
    its own)."""
    from camouflage_multimodal_tpu_torch.api import load_rg_model
    from camouflage_multimodal_tpu_torch.ops.rag import rag_edge_weights, region_adjacency
    from camouflage_multimodal_tpu_torch.pipeline import RegionGraphPipeline

    reference_side()
    from reference_impl import RefRegionGraphGNN
    from reference_pipeline import reference_heatmap

    dev = resolve_device(device)
    ckpt = weights(_rg_name(size), out)
    tmodel = RefRegionGraphGNN()
    tmodel.load_state_dict(torch.load(ckpt, weights_only=True))
    tmodel.eval()
    # feature_norm=256: the reference normalises positions by a hard-coded
    # 256 at any size, so the shared weights need the port's
    # bug-compatible mode (identical at 256).
    pipe = RegionGraphPipeline(load_rg_model(ckpt, dev), n_segments=n_segments,
                               image_size=size, feature_norm=256)

    bases = [(base, mask_p) for base, _, mask_p, *_ in test_samples]
    port_heat, port_graphs = {}, {}
    for s in range(0, len(test_samples), BATCH):
        chunk = np.stack([load_image_rgb(img_p, size) for _, img_p, *_ in
                          test_samples[s:s + BATCH]])
        batch = torch.from_numpy((chunk * 255.0).round().astype(np.uint8)).to(dev)
        res = {k: v.cpu().numpy() for k, v in pipe(batch).items()}
        for j in range(len(chunk)):
            name = bases[s + j][0]
            port_heat[name] = res["heatmap"][j]
            port_graphs[name] = {k: res[k][j] for k in (
                "region_features", "node_mask", "segments", "mask_logits")}

    agree_v, agree_c, maes, model_agree, qual = [], [], [], [], {"ref": [], "jax": []}
    posfrac = {"ref": [], "jax": []}
    # Threshold sweep: where the shared model never crosses a threshold both
    # binary maps are all background and agreement is trivially 1; the gate
    # takes the minimum over the thresholds the reference side crosses.
    sweep_ts = (0.25, 0.35, 0.5)
    sweep = {t: {"agree": [], "ref_pos": []} for t in sweep_ts}
    per_image = []
    for base, mask_p in bases:
        g = _load_graph(base, size, out)
        h_ref_v = reference_heatmap(tmodel, g, mapping="verbatim")
        h_ref_c = reference_heatmap(tmodel, g, mapping="corrected")
        h_port = port_heat[base]

        bv, bc, bp = h_ref_v > 0.5, h_ref_c > 0.5, h_port > 0.5
        agree_v.append(float((bv == bp).mean()))
        agree_c.append(float((bc == bp).mean()))
        maes.append(float(np.abs(h_ref_c - h_port).mean()))
        posfrac["ref"].append(float(bc.mean()))
        posfrac["jax"].append(float(bp.mean()))
        for t in sweep_ts:
            sweep[t]["agree"].append(float(((h_ref_c > t) == (h_port > t)).mean()))
            sweep[t]["ref_pos"].append(float((h_ref_c > t).mean()))

        # Model-only fidelity: the torch model on the port's own graphs, the
        # dense adjacency and weights rebuilt as the pipeline's RAG does.
        pg = port_graphs[base]
        mask = pg["node_mask"]
        feats = torch.from_numpy(pg["region_features"]).to(dev)
        adj = region_adjacency(torch.from_numpy(pg["segments"])[None].to(dev), feats.shape[0])
        w = rag_edge_weights(feats[None], adj)[0].cpu().numpy()
        adj = adj[0].cpu().numpy()
        valid = np.where(mask)[0]
        with torch.no_grad():
            mo, _, _ = tmodel(torch.from_numpy(pg["region_features"][mask]),
                              torch.tensor(adj[np.ix_(valid, valid)]).float(),
                              torch.tensor(w[np.ix_(valid, valid)]))
        model_agree.append(float((mo.argmax(1).numpy() == pg["mask_logits"][mask].argmax(1))
                                 .mean()))

        gt = load_mask(mask_p, size) > 0.5
        if gt.sum() > 0:  # NonCAM GT is empty; IoU would be degenerate
            for tag, hm in (("ref", h_ref_c), ("jax", h_port)):
                pb = hm > 0.5
                inter = (pb & gt).sum()
                union = pb.sum() + gt.sum() - inter
                qual[tag].append(float(inter / (union + 1e-8)))

        per_image.append({"image": base,
                          "category": category_of(base),
                          "pixel_agreement_verbatim": agree_v[-1],
                          "pixel_agreement_corrected": agree_c[-1],
                          "heatmap_mae": maes[-1],
                          "model_node_agreement": model_agree[-1]})

    by_cat = defaultdict(list)
    for rec in per_image:
        by_cat[rec["category"]].append(rec)
    per_category = {
        c: {"n": len(v),
            "pixel_agreement_corrected": _mean([r["pixel_agreement_corrected"] for r in v]),
            "pixel_agreement_verbatim": _mean([r["pixel_agreement_verbatim"] for r in v]),
            "heatmap_mae": _mean([r["heatmap_mae"] for r in v])}
        for c, v in sorted(by_cat.items())
    }
    nontrivial = [v for v in sweep.values() if np.mean(v["ref_pos"]) >= 0.005]
    report = {
        "n_test_images": len(bases),
        "image_size": size,
        "pixel_agreement_vs_reference_verbatim_paintback": _mean(agree_v),
        "pixel_agreement_vs_reference_corrected_paintback": _mean(agree_c),
        "heatmap_mae_vs_reference": _mean(maes),
        "model_only_node_agreement": _mean(model_agree),
        # "jax" names the side under test, as in the JAX report: here the port.
        "iou_vs_gt_cam_only": {k: _mean(v) for k, v in qual.items()},
        "per_category": per_category,
        "binary_positive_fraction": {k: _mean(v) for k, v in posfrac.items()},
        "agreement_by_threshold": {
            str(t): {"pixel_agreement": _mean(v["agree"]),
                     "ref_positive_fraction": _mean(v["ref_pos"])}
            for t, v in sweep.items()},
        "gate": {"target": 0.95,
                 "degenerate_at_paintback_threshold": bool(np.mean(posfrac["ref"]) < 0.005),
                 "min_nontrivial_threshold_agreement": float(min(
                     [np.mean(v["agree"]) for v in nontrivial] or [float("nan")])),
                 "passed": bool(np.mean(agree_c) >= 0.95 and nontrivial
                                and all(np.mean(v["agree"]) >= 0.95 for v in nontrivial)),
                 "passed_every_category": bool(all(
                     v["pixel_agreement_corrected"] >= 0.95 for v in per_category.values()))},
        "notes": [
            "Reference side: the numpy/scipy/torch re-implementation of the "
            "reference stack in the repo's tools/reference_pipeline.py, run on "
            "the CPU.",
            "The reference's own paint-back indexes mask_probs[region_id] while "
            "node i is segment label i+1; the 'verbatim' row reproduces that "
            "off-by-one and the 'corrected' row applies the region_id_map.",
            f"Port side: RegionGraphPipeline(feature_norm=256) on {dev.type} with "
            "the torch weights loaded through core/torch_compat.py; the keys "
            "named 'jax' hold the port's side.",
        ],
        "per_image": per_image,
    }
    probe_cfg = ckpt + ".config.json"
    if os.path.exists(probe_cfg):
        with open(probe_cfg) as f:
            report["probe_training_config"] = json.load(f)
    if size != 256:
        report["notes"].append(
            f"Weights trained at {size}² (stage train --size {size}): the "
            "reference's /256 normalisation puts 256-trained weights off "
            "distribution at other sizes; both sides share the same weights.")
    os.makedirs(out, exist_ok=True)
    name = "fidelity_report.json" if size == 256 else f"fidelity_report_{size}.json"
    with open(os.path.join(out, name), "w") as f:
        json.dump(report, f, indent=2)
    print(json.dumps({k: v for k, v in report.items() if k != "per_image"}, indent=2))
    return report


def _kg_tensor_sorted():
    """The KG embeddings stacked in sorted category order (the reference's
    ``build_ordered_kg_tensor``)."""
    z = np.load(KG_EMBEDDINGS)
    cats = sorted(z.files)
    return np.stack([z[c] for c in cats]).astype(np.float32), cats


def _mask_label(mask: np.ndarray) -> tuple:
    """The reference's mask-label heuristic without its cv2 contour branch
    (both branches give label 1; only the confidence differs)."""
    mean_intensity = float(mask.mean())
    non_zero = float((mask > 10 / 255.0).mean())
    if mean_intensity > 0.1 and non_zero > 0.05:
        return 1, min(mean_intensity * 2, 1.0)
    return 0, 1.0 - mean_intensity


def _torch_rg(out: str):
    reference_side()
    from reference_impl import RefRegionGraphGNN

    model = RefRegionGraphGNN()
    model.load_state_dict(torch.load(weights("best_model.pth", out), weights_only=True))
    return model.eval()


def _graph_embeddings(model, g):
    with torch.no_grad():
        return model.extract_node_embeddings(torch.tensor(g["features"]).float(),
                                             torch.tensor(g["adjacency"]).float(),
                                             torch.tensor(g["weights"]).float())


class _Focal(torch.nn.Module):
    """The reference's AggressiveFocalLoss (it lives in its training script,
    not in ``fusion_model.py``)."""

    def __init__(self, alpha: float = 0.75, gamma: float = 3.0) -> None:
        super().__init__()
        self.alpha, self.gamma = alpha, gamma

    def forward(self, logits, target):
        ce = torch.nn.functional.cross_entropy(logits, target, reduction="none")
        pt = torch.exp(-ce)
        alpha_t = torch.where(target == 1, self.alpha, 1 - self.alpha)
        return (alpha_t * (1 - pt) ** self.gamma * ce).mean()


def stage_fusion_train(train_samples, epochs: int = 8, batch_size: int = 8, seed: int = 0,
                       out: str = OUT) -> None:
    """The reference's own fusion model trained by its recipe (focal 3.0 +
    CE 1.0 + BCE 0.5 + MSE 0.3, AdamW 1e-4, clip 1.0) on the torch RG
    model's node embeddings of the cached 256² graphs."""
    reference_side()
    from reference_impl import load_reference_fusion_module

    fm = load_reference_fusion_module()
    tmodel = _torch_rg(out)
    kg = torch.tensor(_kg_tensor_sorted()[0]).unsqueeze(0)

    samples = []
    for base, _, mask_p, *_ in train_samples:
        label, conf = _mask_label(load_mask(mask_p, 256))
        samples.append({"emb": _graph_embeddings(tmodel, _load_graph(base, 256, out)),
                        "label": label, "conf": conf})
    n1 = sum(s["label"] for s in samples)
    print(f"[fusion-train] {len(samples)} samples, class1={n1}", flush=True)

    torch.manual_seed(seed)
    model_cfg = {"rg_dim": 128, "kg_dim": 128, "hidden_dim": 256,
                 "num_heads": 8, "fusion_type": "cross_attention",
                 "num_classes": 2, "dropout": 0.3}
    fusion = fm.build_multimodal_model(model_cfg)
    opt = torch.optim.AdamW(fusion.parameters(), lr=1e-4, weight_decay=1e-4)
    focal_fn = fm.__dict__.get("AggressiveFocalLoss", _Focal)()
    bce = torch.nn.BCEWithLogitsLoss()
    mse = torch.nn.MSELoss()
    rng = np.random.default_rng(seed)

    for epoch in range(epochs):
        order = rng.permutation(len(samples))
        tot, correct = 0.0, 0
        fusion.train()
        for s in range(0, len(order), batch_size):
            opt.zero_grad()
            for i in order[s:s + batch_size]:
                sm = samples[i]
                y = torch.tensor([sm["label"]])
                mo, io, eo, so = fusion(sm["emb"].unsqueeze(0), kg)
                loss = (focal_fn(mo, y) * 3.0
                        + torch.nn.functional.cross_entropy(io, y) * 1.0
                        + bce(eo.squeeze(1), y.float()) * 0.5
                        + mse(so.squeeze(1), torch.tensor([sm["conf"]])) * 0.3)
                loss.backward()
                tot += float(loss.detach())
                correct += int(mo.argmax(1).item() == sm["label"])
            torch.nn.utils.clip_grad_norm_(fusion.parameters(), max_norm=1.0)
            opt.step()
        print(f"[fusion-train] epoch {epoch + 1}/{epochs} "
              f"loss {tot / len(order):.4f} acc {100 * correct / len(order):.1f}%", flush=True)

    os.makedirs(fidelity_dir(out), exist_ok=True)
    torch.save({"model_state_dict": fusion.state_dict(),
                "config": {"model": model_cfg},
                "epoch": epochs, "val_loss": tot / len(order),
                "val_f1_class_1": 0.0, "val_f1_avg": 0.0,
                "val_acc_0": 0.0, "val_acc_1": 0.0},
               os.path.join(fidelity_dir(out), "multimodal_best.pth"))


def stage_fusion_compare(test_samples, out: str = OUT,
                         device: str | torch.device = "cuda") -> dict:
    """Composed multimodal fidelity: the torch stack (reference graphs →
    torch RG embeddings → the reference's fusion model) against the port's
    ``MultimodalPredictor`` on the same ``.pth`` weights, plus the
    fusion-model-only split (the torch fusion model on the port pipeline's
    own node embeddings). Writes and returns the report."""
    from camouflage_multimodal_tpu_torch.api import MultimodalPredictor

    reference_side()
    from reference_impl import load_reference_fusion_module

    fm = load_reference_fusion_module()
    tmodel = _torch_rg(out)
    fusion_ckpt = weights("multimodal_best.pth", out)
    blob = torch.load(fusion_ckpt, weights_only=True)
    tfusion = fm.build_multimodal_model(blob["config"]["model"])
    tfusion.load_state_dict(blob["model_state_dict"])
    tfusion.eval()
    kg = torch.tensor(_kg_tensor_sorted()[0]).unsqueeze(0)

    pred = MultimodalPredictor(fusion_checkpoint=fusion_ckpt,
                               rg_checkpoint=weights("best_model.pth", out),
                               kg_embeddings_path=KG_EMBEDDINGS, device=device)

    per_image, agree_mask, agree_inst = [], [], []
    score_mae, edge_mae, prob_mae = [], [], []
    mo_agree, mo_score = [], []
    for base, img_p, *_ in test_samples:
        jp, _, _ = pred.predict_single_image(img_p)

        emb = _graph_embeddings(tmodel, _load_graph(base, 256, out))
        with torch.no_grad():
            mo, io, eo, so, _ = tfusion(emb.unsqueeze(0), kg, return_attention=True)
        t_prob = torch.softmax(mo, 1)[0].numpy()
        agree_mask.append(float(int(mo.argmax(1)) == jp["mask_pred"]))
        agree_inst.append(float(int(io.argmax(1)) == jp["instance_pred"]))
        score_mae.append(abs(float(so[0, 0]) - jp["score"]))
        edge_mae.append(abs(float(torch.sigmoid(eo)[0, 0]) - jp["edge_prob"]))
        prob_mae.append(float(np.abs(t_prob - np.asarray(jp["mask_prob"])).mean()))

        # Model-only split: the torch fusion on the port pipeline's embeddings.
        img_u8 = (load_image_rgb(img_p, 256) * 255).round().astype(np.uint8)
        rg_out = pred.rg_pipeline(torch.from_numpy(img_u8[None]).to(pred.device))
        valid = rg_out["node_mask"][0]
        p_emb = rg_out["node_embeddings"][0][valid].cpu()
        with torch.no_grad():
            mo2, _, _, so2, _ = tfusion(p_emb.unsqueeze(0), kg, return_attention=True)
        mo_agree.append(float(int(mo2.argmax(1)) == jp["mask_pred"]))
        mo_score.append(abs(float(so2[0, 0]) - jp["score"]))

        per_image.append({
            "image": base, "mask_pred_agree": agree_mask[-1],
            "instance_pred_agree": agree_inst[-1],
            "score_abs_diff": score_mae[-1], "edge_prob_abs_diff": edge_mae[-1],
            "mask_prob_mae": prob_mae[-1],
            "model_only_mask_agree": mo_agree[-1],
            "model_only_score_abs_diff": mo_score[-1]})

    report = {
        "n_test_images": len(test_samples),
        "composed": {
            "mask_pred_agreement": _mean(agree_mask),
            "instance_pred_agreement": _mean(agree_inst),
            "score_mae": _mean(score_mae),
            "edge_prob_mae": _mean(edge_mae),
            "mask_prob_mae": _mean(prob_mae),
        },
        "fusion_model_only": {
            "mask_pred_agreement": _mean(mo_agree),
            "score_mae": _mean(mo_score),
        },
        "gate": {"target": 0.95, "passed": bool(np.mean(agree_mask) >= 0.95)},
        "notes": [
            "torch side: the reference's own fusion_model.py trained by the "
            "reference recipe on the torch RG model's embeddings; port side: "
            f"MultimodalPredictor on {pred.device.type} with both checkpoints "
            "loaded through core/torch_compat.py.",
            "'composed' runs both full stacks from the image; "
            "'fusion_model_only' feeds the port pipeline's embeddings to the "
            "torch fusion model.",
        ],
        "per_image": per_image,
    }
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, "fidelity_fusion_report.json"), "w") as f:
        json.dump(report, f, indent=2)
    print(json.dumps({k: v for k, v in report.items() if k != "per_image"}, indent=2))
    return report


def main(argv=None, device: str | torch.device = "cuda") -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--stage", default="all",
                    choices=["all", "graphs", "train", "compare",
                             "fusion-train", "fusion-compare"])
    ap.add_argument("--n-train", type=int, default=120)
    ap.add_argument("--n-test", type=int, default=200)
    ap.add_argument("--epochs", type=int, default=30)
    ap.add_argument("--seed", type=int, default=0,
                    help="training seed; bump it if the trained model is degenerate "
                         "(compare reports binary_positive_fraction and fails the gate)")
    ap.add_argument("--pos-weight", type=float, default=5.0,
                    help="mask-loss positive class weight; 5.0 = the reference recipe")
    ap.add_argument("--split", default="stratified", choices=["stratified", "sorted"])
    ap.add_argument("--size", type=int, default=256,
                    help="image resolution of graphs, train and compare")
    ap.add_argument("--out", default=OUT, help="output root (default: %(default)s)")
    args = ap.parse_args(argv)

    train_s, test_s = quadruples(args.n_train, args.n_test, args.split)
    print(f"{len(train_s)} train / {len(test_s)} test images")
    if args.stage in ("all", "graphs"):
        stage_graphs(train_s + test_s, size=args.size, out=args.out)
    if args.stage in ("all", "train"):
        stage_train(train_s, epochs=args.epochs, size=args.size, seed=args.seed,
                    pos_weight=args.pos_weight, out=args.out)
    if args.stage in ("all", "compare"):
        stage_compare(test_s, size=args.size, out=args.out, device=device)
    # The fusion stages are a 256-only protocol: the reference's multimodal
    # stack hard-codes 256 end to end.
    if args.stage in ("fusion-train", "fusion-compare") and args.size != 256:
        ap.error("--stage fusion-* is a 256-only protocol (the reference "
                 "multimodal stack hard-codes 256); drop --size")
    for stage, run in (("fusion-train", lambda: stage_fusion_train(train_s, out=args.out)),
                       ("fusion-compare", lambda: stage_fusion_compare(test_s, out=args.out,
                                                                       device=device))):
        if args.stage in ("all", stage):
            if args.size != 256:
                print(f"[skip] {stage}: 256-only protocol, --size {args.size} requested",
                      flush=True)
            else:
                run()


if __name__ == "__main__":
    main()
