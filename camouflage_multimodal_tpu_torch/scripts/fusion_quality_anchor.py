"""Fusion quality anchor: the reference's own fusion recipe against the
committed FusionTrainer runs, on the same matched dataset and split.

Port of the JAX system's ``scripts/fusion_quality_anchor.py``.

torch side: the reference's ``fusion_model.py``
(``tools/reference_impl.load_reference_fusion_module``) trained by its own
recipe — AggressiveFocalLoss(0.75, 3.0)·3.0 + CE·1.0 + BCE·0.5 + MSE·0.3
summed per sample, one optimizer step per 4-sample batch, clip 1.0,
AdamW(5e-4, 1e-4), CosineAnnealingWarmRestarts(T_0=10, T_mult=2) per
epoch, 5× confidence-scaled minority oversampling, ±0.01 noise with
probability 0.5, best-F1-class-1 checkpoint with patience 15 — on the
port's ``FusionDataset`` of the port's ``EmbeddingMatcher`` records.

Trainer rows: the best epochs of the committed full-scale FusionTrainer
histories (``artifacts/checkpoints{,_balanced}/training_history_fixed.json``
of the repo), which used the same labels and the same seed-0 80/20 split.

Reads the RG and KG embedding stores (``RG_EMBEDDINGS``,
``KG_EMBEDDINGS``, the repo's ``artifacts/`` files) and the GT of
``fidelity_gate.REF_DATA``; adds a ``fusion`` section to
``quality_table.json`` and writes ``fusion_anchor_history.json`` under
``--out`` (default ``artifacts/torch_port/``).

    python -m camouflage_multimodal_tpu_torch.scripts.fusion_quality_anchor \\
        [--epochs 30] [--batch-size 4] [--out DIR]
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from camouflage_multimodal_tpu_torch.scripts import fidelity_gate as gate

RG_EMBEDDINGS = os.path.join(gate.COMMITTED, "rg_embeddings", "all_rg_embeddings.npz")
KG_EMBEDDINGS = gate.KG_EMBEDDINGS
HISTORIES = {
    "jax_trainer_default": os.path.join(gate.COMMITTED, "checkpoints",
                                        "training_history_fixed.json"),
    "jax_trainer_balanced": os.path.join(gate.COMMITTED, "checkpoints_balanced",
                                         "training_history_fixed.json"),
}


def build_dataset(rg_embeddings: str | None = None, kg_embeddings: str | None = None):
    from camouflage_multimodal_tpu_torch.data.matcher import EmbeddingMatcher
    from camouflage_multimodal_tpu_torch.train.train_fusion import FusionDataset

    matcher = EmbeddingMatcher(rg_embeddings or RG_EMBEDDINGS, kg_embeddings or KG_EMBEDDINGS)
    matched = matcher.create_matched_dataset(use_all_kg_categories=True)
    return FusionDataset(matched, *(os.path.join(gate.REF_DATA, d)
                                    for d in ("gt_object", "gt_instance", "gt_edge")),
                         augment=False)


def f1_metrics(preds, labels):
    from camouflage_multimodal_tpu_torch.train.train_fusion import calculate_f1_score

    return calculate_f1_score(np.asarray(preds), np.asarray(labels))


def train_reference_recipe(dataset, epochs: int = 30, batch_size: int = 4, seed: int = 0,
                           max_patience: int = 15, log=print):
    gate.reference_side()
    from reference_impl import load_reference_fusion_module

    fm = load_reference_fusion_module()

    # The same split as FusionTrainer (seed-0 permutation, 80/20).
    rng = np.random.default_rng(seed)
    n = len(dataset)
    perm = rng.permutation(n)
    n_train = int(0.8 * n)
    train_idx, val_idx = perm[:n_train], perm[n_train:]
    weights = np.asarray(dataset.get_aggressive_sample_weights())
    p = weights[train_idx] / weights[train_idx].sum()

    torch.manual_seed(seed)
    model_cfg = {"rg_dim": 128, "kg_dim": 128, "hidden_dim": 256,
                 "num_heads": 8, "fusion_type": "cross_attention",
                 "num_classes": 2, "dropout": 0.3}
    model = fm.build_multimodal_model(model_cfg)
    opt = torch.optim.AdamW(model.parameters(), lr=5e-4, weight_decay=1e-4)
    sched = torch.optim.lr_scheduler.CosineAnnealingWarmRestarts(opt, T_0=10, T_mult=2)
    focal = gate._Focal()
    bce = torch.nn.BCEWithLogitsLoss()
    mse = torch.nn.MSELoss()
    ce = torch.nn.CrossEntropyLoss()

    def tensors(i, augment):
        s = dataset.samples[i]
        rg = torch.tensor(np.asarray(s["rg_node_embeddings"], np.float32))
        kg = torch.tensor(np.asarray(s["kg_embeddings"], np.float32))
        if augment and torch.rand(1) > 0.5:
            rg = rg + torch.randn_like(rg) * 0.01
            kg = kg + torch.randn_like(kg) * 0.01
        return rg.unsqueeze(0), kg.unsqueeze(0), s

    history = {k: [] for k in ("train_loss", "val_loss", "train_f1_class_1",
                               "val_f1_class_0", "val_f1_class_1",
                               "val_f1_avg", "val_acc_0", "val_acc_1")}
    best = {"f1": 0.0}
    patience = 0
    t0 = time.time()
    for epoch in range(epochs):
        sampled = rng.choice(train_idx, size=len(train_idx), replace=True, p=p)
        model.train()
        tot, preds, labels = 0.0, [], []
        for s0 in range(0, len(sampled), batch_size):
            opt.zero_grad()
            for i in sampled[s0:s0 + batch_size]:
                rg, kg, s = tensors(int(i), augment=True)
                y = torch.tensor([s["label"]])
                mo, io, eo, so = model(rg, kg)
                loss = (focal(mo, y) * 3.0
                        + torch.nn.functional.cross_entropy(io, y) * 1.0
                        + bce(eo.squeeze(1), torch.tensor([s["edge_label"]])) * 0.5
                        + mse(so.squeeze(1), torch.tensor([s["score_label"]])) * 0.3)
                loss.backward()      # per-sample gradient accumulation
                tot += float(loss.detach())
                preds.append(int(mo.argmax(1)))
                labels.append(s["label"])
            torch.nn.utils.clip_grad_norm_(model.parameters(), max_norm=1.0)
            opt.step()
        sched.step()
        tr_f1 = f1_metrics(preds, labels)
        train_loss = tot / max(len(preds), 1)

        model.eval()
        vtot, vpreds, vlabels = 0.0, [], []
        with torch.no_grad():
            for i in val_idx:
                rg, kg, s = tensors(int(i), augment=False)
                y = torch.tensor([s["label"]])
                mo, _, _, _ = model(rg, kg)
                vtot += float(ce(mo, y))
                vpreds.append(int(mo.argmax(1)))
                vlabels.append(s["label"])
        va_f1 = f1_metrics(vpreds, vlabels)
        vp, vl = np.asarray(vpreds), np.asarray(vlabels)
        acc0 = 100.0 * ((vp == vl) & (vl == 0)).sum() / max((vl == 0).sum(), 1)
        acc1 = 100.0 * ((vp == vl) & (vl == 1)).sum() / max((vl == 1).sum(), 1)

        history["train_loss"].append(train_loss)
        history["val_loss"].append(vtot / max(len(vpreds), 1))
        history["train_f1_class_1"].append(tr_f1["f1_class_1"])
        history["val_f1_class_0"].append(va_f1["f1_class_0"])
        history["val_f1_class_1"].append(va_f1["f1_class_1"])
        history["val_f1_avg"].append(va_f1["f1_avg"])
        history["val_acc_0"].append(acc0)
        history["val_acc_1"].append(acc1)
        log(f"[ref-recipe] epoch {epoch + 1}/{epochs} loss {train_loss:.4f} "
            f"| val F1_C1 {va_f1['f1_class_1']:.3f} F1_avg {va_f1['f1_avg']:.3f} "
            f"Acc0 {acc0:.1f}% Acc1 {acc1:.1f}% ({time.time() - t0:.0f}s)")

        if va_f1["f1_class_1"] > best["f1"]:
            best = {"f1": va_f1["f1_class_1"], "epoch": epoch,
                    "val_f1_class_0": va_f1["f1_class_0"],
                    "val_f1_class_1": va_f1["f1_class_1"],
                    "val_f1_avg": va_f1["f1_avg"],
                    "val_acc_0": acc0, "val_acc_1": acc1}
            patience = 0
        else:
            patience += 1
            if patience >= max_patience:
                log(f"[ref-recipe] early stop after {patience} stale epochs")
                break
    return best, history


def jax_best_row(history_path):
    """Best-F1-class-1 epoch of a FusionTrainer history (None when absent)."""
    if not os.path.exists(history_path):
        return None
    with open(history_path) as f:
        h = json.load(f)
    i = int(np.argmax(h["val_f1_class_1"]))
    return {"epoch": i,
            "val_f1_class_0": h["val_f1_class_0"][i],
            "val_f1_class_1": h["val_f1_class_1"][i],
            "val_f1_avg": h["val_f1_avg"][i],
            "val_acc_0": h["val_acc_0"][i], "val_acc_1": h["val_acc_1"][i]}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--epochs", type=int, default=30)
    ap.add_argument("--batch-size", type=int, default=4)
    ap.add_argument("--out", default=gate.OUT, help="output root (default: %(default)s)")
    args = ap.parse_args(argv)

    dataset = build_dataset()
    labels = [s["label"] for s in dataset.samples]
    print(f"{len(dataset.samples)} samples, class1={sum(labels)}")

    best, history = train_reference_recipe(dataset, epochs=args.epochs,
                                           batch_size=args.batch_size)

    os.makedirs(args.out, exist_ok=True)
    table_path = os.path.join(args.out, "quality_table.json")
    table = {}
    if os.path.exists(table_path):
        with open(table_path) as f:
            table = json.load(f)
    table["fusion"] = {
        "protocol": ("identical FusionDataset samples/labels and seed-0 80/20 "
                     "permutation split; reference row = the reference's own "
                     "fusion_model.py + train_multimodal.py recipe run to "
                     "best-F1-class-1 with patience 15; jax rows = committed "
                     "full-scale FusionTrainer runs (training_history_fixed"
                     ".json), best epoch by the same criterion"),
        "rows": {"reference_recipe_torch": best,
                 **{k: jax_best_row(p) for k, p in HISTORIES.items()}},
    }
    with open(table_path, "w") as f:
        json.dump(table, f, indent=2)
    with open(os.path.join(args.out, "fusion_anchor_history.json"), "w") as f:
        json.dump(history, f, indent=2)
    print(json.dumps(table["fusion"]["rows"], indent=2))
    return table


if __name__ == "__main__":
    main()
