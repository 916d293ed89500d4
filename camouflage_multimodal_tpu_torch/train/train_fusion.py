"""Multimodal fusion trainer, port of
``camouflage_multimodal_tpu/train/train_fusion.py``.

* :class:`FusionDataset` (host-side numpy): matched RG/KG samples with
  image-level (label, confidence) from the mask heuristic, edge_label =
  mean(edge_mask) > 10, score_label = mean(mask)/255, padded to a fixed node
  bucket with a validity mask; ±0.01 Gaussian noise augmentation with
  probability 0.5; 5× minority oversampling weights (or the data-driven
  balanced ones).
* :class:`FusionTrainer`: loss = SUM over the batch's samples of
  3·focal(mask) + 1·CE(instance ← mask label) + 0.5·BCE(edge) +
  0.3·MSE(score) (the reference accumulates per-sample gradients); AdamW
  with cosine warm restarts (T_0 = 10, T_mult = 2) stepped per epoch,
  global-norm clip 1.0; best checkpoint on validation F1 of class 1, early
  stop after 15 epochs without a better one.

With ``use_pallas`` and ``dropout == 0`` in the model config, every train
step on the card runs forward through the fused attention kernel (B2) and
backward through its gradient kernel (B3); evaluation runs B2 whatever the
dropout. ``fit`` has two epoch forms: the host loop collates each batch
with numpy (the JAX ``_fit_loop``), the device-resident form keeps the
padded dataset on the device, gathers batches by index there and pulls
losses and predictions once per epoch (the JAX ``_fit_scan``).
``fit(mesh=)`` trains over the ranks of a :func:`parallel.sharding.make_mesh`
mesh: the batch over its ``data`` axis and, when its ``model`` axis is
larger than 1, the cross-attention heads and FFN columns over that axis
(:func:`parallel.sharding.shard_fusion_params`; checkpoints and the
returned model hold the whole weights).
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from camouflage_multimodal_tpu_torch.convert import fusion_params_from_state_dict
from camouflage_multimodal_tpu_torch.core.checkpoint import (
    load_resume_checkpoint, save_checkpoint, save_resume_checkpoint)
from camouflage_multimodal_tpu_torch.core.device import resolve_device
from camouflage_multimodal_tpu_torch.data import extract_label_from_mask
from camouflage_multimodal_tpu_torch.models.fusion import (
    MultimodalCamouflageDetector, build_multimodal_model)
from camouflage_multimodal_tpu_torch.models.layers import set_data_group
from camouflage_multimodal_tpu_torch.parallel.sharding import (
    all_reduce_grads_, all_reduce_sum, block, data_group, fusion_model_group,
    gather_fusion_moments, gather_fusion_state, gather_rows, replicate, set_model_group,
    shard_dims, shard_fusion_moments, shard_fusion_params, shard_fusion_state,
    unshard_fusion_params_)
from camouflage_multimodal_tpu_torch.train.losses import (
    bce_terms, cross_entropy_terms, focal_terms)
from camouflage_multimodal_tpu_torch.train.schedules import cosine_warm_restarts
from camouflage_multimodal_tpu_torch.train.state import (
    apply_updates, load_optimizer_arrays, make_adamw)

Batch = Dict[str, torch.Tensor]
_BATCH_KEYS = ("rg", "rg_mask", "kg", "y", "edge", "score")
_HISTORY_KEYS = ("train_loss", "val_loss", "train_f1_class_0", "train_f1_class_1",
                 "train_f1_avg", "val_f1_class_0", "val_f1_class_1", "val_f1_avg",
                 "val_acc_0", "val_acc_1")


def calculate_f1_score(predictions: np.ndarray, labels: np.ndarray) -> Dict[str, float]:
    """Per-class F1 (``train_multimodal.py:197-220``, same eps)."""
    predictions = np.asarray(predictions)
    labels = np.asarray(labels)
    tp = float(((predictions == 1) & (labels == 1)).sum())
    fp = float(((predictions == 1) & (labels == 0)).sum())
    fn = float(((predictions == 0) & (labels == 1)).sum())
    tn = float(((predictions == 0) & (labels == 0)).sum())
    precision_1 = tp / (tp + fp + 1e-8)
    recall_1 = tp / (tp + fn + 1e-8)
    f1_1 = 2 * precision_1 * recall_1 / (precision_1 + recall_1 + 1e-8)
    precision_0 = tn / (tn + fn + 1e-8)
    recall_0 = tn / (tn + fp + 1e-8)
    f1_0 = 2 * precision_0 * recall_0 / (precision_0 + recall_0 + 1e-8)
    return {
        "f1_class_0": f1_0, "f1_class_1": f1_1, "f1_avg": (f1_0 + f1_1) / 2,
        "precision_1": precision_1, "recall_1": recall_1,
    }


def _bucket_size(samples: List[Dict[str, Any]], max_rg_nodes: Optional[int]) -> int:
    """The node bucket: as given, or the widest sample rounded up to 64."""
    if max_rg_nodes is None:
        widest = max((int(np.asarray(s["rg_node_embeddings"]).shape[0])
                      for s in samples), default=64)
        max_rg_nodes = -(-widest // 64) * 64
    return int(max_rg_nodes)


class FusionDataset:
    """Matched RG/KG samples + GT-derived labels, padded to fixed buckets.

    ``max_rg_nodes`` sizes the padded node bucket (default 576 = 9 × 64,
    which covers extraction at n_segments = 500). ``None`` sizes it from the
    data. Nodes that still overflow the bucket are counted in
    ``truncated_nodes`` / ``truncated_samples`` and reported once instead of
    being dropped silently.
    """

    def __init__(self, matched_data: List[Dict[str, Any]], mask_dir: str,
                 instance_dir: str, edge_dir: str,
                 max_rg_nodes: Optional[int] = 576,
                 augment: bool = False, seed: int = 0,
                 log_fn=print) -> None:
        from PIL import Image

        samples: List[Dict[str, Any]] = []
        for sample in matched_data:
            base = os.path.splitext(sample["image_name"])[0]
            mask_path = os.path.join(mask_dir, base + ".png")
            instance_path = os.path.join(instance_dir, base + ".png")
            edge_path = os.path.join(edge_dir, base + ".png")
            if not all(os.path.exists(p) for p in (mask_path, instance_path, edge_path)):
                continue
            label, confidence = extract_label_from_mask(mask_path)
            mask = np.asarray(Image.open(mask_path).convert("L"))
            edge_mask = np.asarray(Image.open(edge_path).convert("L"))
            samples.append({
                **sample,
                "label": int(label),
                "confidence": float(confidence),
                "edge_label": float(edge_mask.mean() > 10),
                "score_label": float(mask.mean() / 255.0),
            })
        self._setup(samples, max_rg_nodes, augment, seed, log_fn)

    def _setup(self, samples, max_rg_nodes, augment, seed, log_fn) -> None:
        self.log_fn = log_fn
        self.truncated_nodes = 0
        self.truncated_samples = 0
        self._warned_truncation = False
        self.augment = augment
        self.rng = np.random.default_rng(seed)
        self.samples = samples
        self.max_rg_nodes = _bucket_size(samples, max_rg_nodes)

    @classmethod
    def from_samples(cls, samples: List[Dict[str, Any]],
                     max_rg_nodes: Optional[int] = 576,
                     augment: bool = False, seed: int = 0,
                     log_fn=print) -> "FusionDataset":
        """A dataset of already-labelled records (each holding
        rg_node_embeddings / kg_embeddings / label / confidence / edge_label
        / score_label), with no GT files read."""
        ds = cls.__new__(cls)
        ds._setup(list(samples), max_rg_nodes, augment, seed, log_fn)
        return ds

    def __len__(self) -> int:
        return len(self.samples)

    def get_labels(self) -> List[int]:
        return [s["label"] for s in self.samples]

    def _class_counts(self) -> Dict[int, int]:
        counts: Dict[int, int] = {}
        for l in self.get_labels():
            counts[l] = counts.get(l, 0) + 1
        return counts

    def get_aggressive_sample_weights(self) -> List[float]:
        """5× boost of class 1 × confidence (``train_multimodal.py:142-164``,
        which hard-codes class 1 as the minority)."""
        counts = self._class_counts()
        majority = max(counts.values())
        class_weights = {c: (majority / cnt) * 5.0 if c == 1 else 1.0
                         for c, cnt in counts.items()}
        return [class_weights[s["label"]] * s["confidence"] for s in self.samples]

    def get_balanced_sample_weights(self) -> List[float]:
        """Inverse-frequency weights × confidence: boosts whichever class is
        actually rarer (on COD10K-CAM class 1 is the majority, and the
        aggressive weights starve class 0)."""
        counts = self._class_counts()
        majority = max(counts.values())
        class_weights = {c: majority / cnt for c, cnt in counts.items()}
        return [class_weights[s["label"]] * s["confidence"] for s in self.samples]

    def collate(self, indices) -> Dict[str, np.ndarray]:
        """Pad a set of samples into one batch."""
        B = len(indices)
        K = self.max_rg_nodes
        n_kg = self.samples[indices[0]]["kg_embeddings"].shape[0]
        dim = self.samples[indices[0]]["rg_node_embeddings"].shape[1]
        rg = np.zeros((B, K, dim), np.float32)
        rg_mask = np.zeros((B, K), bool)
        kg = np.zeros((B, n_kg, dim), np.float32)
        y = np.zeros((B,), np.int64)
        edge = np.zeros((B,), np.float32)
        score = np.zeros((B,), np.float32)
        for i, idx in enumerate(indices):
            s = self.samples[idx]
            node = np.asarray(s["rg_node_embeddings"], np.float32)
            kge = np.asarray(s["kg_embeddings"], np.float32)
            if self.augment and self.rng.random() > 0.5:
                node = node + self.rng.standard_normal(node.shape).astype(np.float32) * 0.01
                kge = kge + self.rng.standard_normal(kge.shape).astype(np.float32) * 0.01
            n = min(node.shape[0], K)
            if node.shape[0] > K:
                self.truncated_nodes += node.shape[0] - K
                self.truncated_samples += 1
            rg[i, :n] = node[:n]
            rg_mask[i, :n] = True
            kg[i] = kge
            y[i] = s["label"]
            edge[i] = s["edge_label"]
            score[i] = s["score_label"]
        if self.truncated_nodes and not self._warned_truncation:
            self._warned_truncation = True
            self.log_fn(
                f"WARNING: FusionDataset bucket max_rg_nodes={K} is smaller than "
                f"some samples — {self.truncated_nodes} nodes dropped across "
                f"{self.truncated_samples} sample(s) so far. Pass max_rg_nodes=None "
                f"to size the bucket from the data.")
        return {"rg": rg, "rg_mask": rg_mask, "kg": kg, "y": y,
                "edge": edge, "score": score}


class FusionTrainer:
    """Trains the ``MultimodalCamouflageDetector`` it is given, or one built
    from ``model_config`` and initialised from ``fit``'s seed."""

    def __init__(self, model: Optional[MultimodalCamouflageDetector] = None,
                 model_config: Optional[Dict[str, Any]] = None,
                 learning_rate: float = 5e-4, weight_decay: float = 1e-4,
                 task_weights: Optional[Dict[str, float]] = None,
                 balanced: bool = False) -> None:
        self.model_config = dict(model_config or {})
        self._init_from_seed = model is None
        self.model = model if model is not None else build_multimodal_model(self.model_config)
        self.base_lr = learning_rate
        self.weight_decay = weight_decay
        # The reference hard-codes 3.0 / 1.0 / 0.5 / 0.3 (train_multimodal.py:257-266).
        self.w = task_weights or {"mask": 3.0, "instance": 1.0, "edge": 0.5, "score": 0.3}
        # balanced=True replaces the reference's class-1-boosting sampler and
        # focal alpha with inverse-frequency forms; off by default, so the
        # default run is the reference recipe.
        self.balanced = balanced
        self.focal_alpha = 0.75
        self.optimizer: Optional[torch.optim.Optimizer] = None

    # ------------------------------------------------------------------
    # Steps
    # ------------------------------------------------------------------

    def batch_loss(self, out: Dict[str, torch.Tensor], batch: Batch) -> torch.Tensor:
        """The training loss of one batch from the model's outputs."""
        per_sample = (
            self.w["mask"] * focal_terms(out["mask_logits"], batch["y"], self.focal_alpha)
            + self.w["instance"] * cross_entropy_terms(out["instance_logits"], batch["y"])
            + self.w["edge"] * bce_terms(out["edge_logits"][:, 0], batch["edge"])
            + self.w["score"] * (out["score"][:, 0] - batch["score"]) ** 2)
        # SUM over samples = the reference's per-sample gradient accumulation.
        return per_sample.sum()

    def _sample_weights(self, dataset: FusionDataset, train_idx: np.ndarray) -> np.ndarray:
        """Oversampling weights; in balanced mode also sets the focal alpha
        to the class-0 share of the train split."""
        if not self.balanced:
            return np.asarray(dataset.get_aggressive_sample_weights())
        labels = np.asarray(dataset.get_labels())
        self.focal_alpha = float(np.clip(1.0 - labels[train_idx].mean(), 0.05, 0.95))
        return np.asarray(dataset.get_balanced_sample_weights())

    def train_step(self, batch: Batch, lr: float, group=None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
        """One optimizer step; returns (summed loss, predictions), both on
        the batch's device. Under a data-parallel ``group`` ``batch`` is this
        rank's block: its summed loss is its share of the global batch's, and
        the gradients are summed over the ranks before the step. A model
        sharded over a ``model`` group needs no sum there: a sharded
        parameter holds its own share's gradient and a replicated one the
        same gradient on every rank; the clip takes the whole norm."""
        self.model.train()
        out = self.model(batch["rg"], batch["kg"], rg_mask=batch["rg_mask"])
        loss = self.batch_loss(out, batch)
        loss.backward()
        if group is not None:
            all_reduce_grads_(self.model.parameters(), group)
        model_group = fusion_model_group(self.model)
        dims = {} if model_group is None else shard_dims(self.model)
        sharded = [p for name, p in self.model.named_parameters() if name in dims]
        apply_updates(self.optimizer, lr, model_group=model_group, sharded_params=sharded)
        return loss.detach(), out["mask_logits"].detach().argmax(-1)

    @torch.no_grad()
    def eval_step(self, batch: Batch) -> Tuple[torch.Tensor, torch.Tensor]:
        """(summed plain CE of the mask head, predictions): validation uses
        plain CE (``train_multimodal.py:312, 323``)."""
        self.model.eval()
        out = self.model(batch["rg"], batch["kg"], rg_mask=batch["rg_mask"])
        ce = cross_entropy_terms(out["mask_logits"], batch["y"]).sum()
        return ce, out["mask_logits"].argmax(-1)

    # ------------------------------------------------------------------
    # Batches
    # ------------------------------------------------------------------

    @staticmethod
    def _host_batches(dataset: FusionDataset, indices, batch_size: int,
                      dev: torch.device) -> Iterator[Batch]:
        """Every batch collated on the host (numpy augmentation when the
        dataset has it on), the last one ragged."""
        for i in range(0, len(indices), batch_size):
            cols = dataset.collate(indices[i: i + batch_size])
            yield {k: torch.from_numpy(v).to(dev) for k, v in cols.items()}

    @staticmethod
    def _device_dataset(dataset: FusionDataset, dev: torch.device) -> Batch:
        """The whole padded dataset on the device, without host-side
        augmentation (a frozen noise realisation must not be baked in, and
        the dataset's RNG must not be consumed)."""
        saved = dataset.augment
        dataset.augment = False
        try:
            cols = dataset.collate(list(range(len(dataset))))
        finally:
            dataset.augment = saved
        return {k: torch.from_numpy(v).to(dev) for k, v in cols.items()}

    @staticmethod
    def _device_batches(data: Batch, indices, batch_size: int, augment: bool,
                        generator: torch.Generator, group=None) -> Iterator[Batch]:
        """Full batches gathered by index on the device (a ragged tail is
        dropped, at least one step is kept); augmentation noise is drawn
        there from ``generator``. Under a data-parallel ``group`` the noise
        is drawn for the whole batch and this rank's block is yielded."""
        dev = data["rg"].device
        steps = max(len(indices) // batch_size, 1)
        order = torch.from_numpy(np.asarray(indices[: steps * batch_size], np.int64)
                                 .reshape(steps, -1)).to(dev)
        for idx in order:
            batch = {k: data[k].index_select(0, idx) for k in _BATCH_KEYS}
            if augment:
                flips = (torch.rand(len(idx), generator=generator, device=dev) > 0.5)[:, None, None]
                for k in ("rg", "kg"):
                    noise = torch.randn(batch[k].shape, generator=generator, device=dev) * 0.01
                    batch[k] = batch[k] + noise * flips
            rows = block(len(idx), group)
            yield {k: v[rows] for k, v in batch.items()}

    def _run_epoch(self, batches: Iterator[Batch], lr: Optional[float], group=None):
        """Train (``lr`` given) or evaluate over ``batches``. Losses,
        predictions and labels stay on the device until the epoch ends and
        come to the host in one go: (mean loss per sample, preds, labels).
        Under a data-parallel ``group`` they are gathered over the ranks
        first, in the order of one rank's epoch."""
        losses, preds, ys = [], [], []
        for batch in batches:
            loss, pred = (self.train_step(batch, lr, group) if lr is not None
                          else self.eval_step(batch))
            losses.append(loss)
            preds.append(pred)
            ys.append(batch["y"])
        if group is None:
            preds_np, ys_np = (torch.cat(v).cpu().numpy() for v in (preds, ys))
        else:   # (steps, block) of every rank → (steps, batch), one rank's order
            preds_np, ys_np = (gather_rows(torch.stack(v).T.contiguous(), group).T.reshape(-1)
                               .cpu().numpy() for v in (preds, ys))
        total = float(all_reduce_sum(torch.stack(losses), group).double().sum().cpu())
        return total / max(len(preds_np), 1), preds_np, ys_np

    # ------------------------------------------------------------------
    # Checkpoints
    # ------------------------------------------------------------------

    def _whole_optimizer_arrays(self) -> Dict[str, Any]:
        """``optimizer_arrays`` with the moments of a sharded model gathered
        whole (every rank of its ``model`` group must call it)."""
        return {name: {k: v.detach().cpu().numpy() for k, v in st.items()}
                for name, st in gather_fusion_moments(self.model, self.optimizer).items()}

    def _best_payload(self, epoch: int, metrics: Dict[str, float],
                      config: Optional[Dict[str, Any]]) -> Dict[str, Any]:
        """The best-checkpoint payload in the JAX package's layout, so its
        ``load_multimodal_model`` reads it; the whole weights also when the
        model is sharded (every rank of its ``model`` group must call it)."""
        sd = gather_fusion_state(self.model)
        moments = self._whole_optimizer_arrays()
        opt_state = {"step": max((int(m["step"]) for m in moments.values()), default=0)}
        for key, name in (("exp_avg", "mu"), ("exp_avg_sq", "nu")):
            opt_state[name] = fusion_params_from_state_dict(
                {k: torch.from_numpy(m[key]) for k, m in moments.items()})
        return {"epoch": epoch, "params": fusion_params_from_state_dict(sd),
                "opt_state": opt_state, **metrics,
                "config": config if config is not None else {"model": self.model_config}}

    # ------------------------------------------------------------------
    # fit
    # ------------------------------------------------------------------

    def fit(self, dataset: FusionDataset, epochs: int = 30, batch_size: int = 4,
            train_split: float = 0.8, seed: int = 0,
            checkpoint_dir: Optional[str] = None, max_patience: int = 15,
            config: Optional[Dict[str, Any]] = None,
            device_resident: bool = False,
            resume_from: Optional[str] = None, resume_path: Optional[str] = None,
            mesh=None, device: str | torch.device = "cuda",
            log_fn=print) -> Tuple[MultimodalCamouflageDetector, Dict[str, List[float]]]:
        """Train on ``device`` (``"cuda"`` raises without a card; ``"cpu"``
        runs the kernels' plain versions). ``device_resident`` selects the
        epoch form (module docstring); it trains with on-device augmentation
        when ``dataset.augment`` is set. ``resume_path`` snapshots the run
        after every epoch and ``resume_from`` continues such a snapshot
        bit-exactly.

        ``mesh`` (a :func:`parallel.sharding.make_mesh` mesh, one process per
        rank) trains data-parallel and forces ``device_resident`` (as the
        JAX ``fit`` forces its scan epochs): every rank samples the same
        batches, runs its block of each, draws dropout and augmentation for
        the whole batch and keeps its rows, and the gradients are summed
        (the loss is a sum over samples). With a ``model`` axis larger than
        1 the model is also sharded over it (:func:`parallel.sharding.
        shard_fusion_params`) and gathered whole again at the end; the
        checkpoints hold the whole weights and moments, and a resumed run
        is sharded again; a fit that raises before that leaves a model that
        refuses to compute. Predictions are gathered before the F1 scores;
        every rank returns the same model and history, those of one rank on
        the whole batch up to float32 summation order; rank 0 alone writes
        files. Returns (the trained model, history)."""
        group = data_group(mesh)
        if group is not None:
            device_resident = True
            world = dist.get_world_size(group)
            if batch_size % world:
                raise ValueError(
                    f"batch_size {batch_size} not divisible by the mesh's "
                    f"data axis ({world})")
        dev = resolve_device(device)
        rng = np.random.default_rng(seed)
        n = len(dataset)
        perm = rng.permutation(n)
        n_train = int(train_split * n)
        train_idx, val_idx = perm[:n_train], perm[n_train:]
        if group is not None:
            for split in (train_idx, val_idx):   # a short batch is the split itself
                if len(split) < batch_size:
                    block(len(split), group)
        writer = group is None or dist.get_rank() == 0

        weights = self._sample_weights(dataset, train_idx)
        p = weights[train_idx] / weights[train_idx].sum()

        if self._init_from_seed:
            self.model.reset_parameters(torch.Generator().manual_seed(seed))
        self.model.to(dev)
        if group is not None:
            replicate(self.model, mesh)
            shard_fusion_params(self.model, mesh)
        sharded = fusion_model_group(self.model) is not None
        set_data_group(self.model, group)
        try:
            self.optimizer = make_adamw(self.model.parameters(), self.weight_decay)
            generator = torch.Generator(device=dev).manual_seed(seed + 1)
            self.model.set_generator(generator)
            data = self._device_dataset(dataset, dev) if device_resident else None

            def batches_of(indices, train: bool) -> Iterator[Batch]:
                if device_resident:
                    return self._device_batches(data, indices, batch_size,
                                                train and dataset.augment, generator, group)
                return self._host_batches(dataset, indices, batch_size, dev)

            history: Dict[str, List[float]] = {k: [] for k in _HISTORY_KEYS}
            best_f1 = 0.0
            patience = 0
            start_epoch = 0
            if resume_from:
                blob = load_resume_checkpoint(resume_from)
                self.model.load_state_dict(shard_fusion_state(
                    self.model,
                    {k: torch.from_numpy(np.array(v)) for k, v in blob["model_state"].items()}))
                load_optimizer_arrays(self.model, self.optimizer,
                                      shard_fusion_moments(self.model, blob["optimizer_state"]))
                rng.bit_generator.state = blob["numpy_rng_state"]
                dataset.rng.bit_generator.state = blob["dataset_rng_state"]
                generator.set_state(torch.from_numpy(np.array(blob["generator_state"])))
                history = blob["history"]
                best_f1 = blob["best_val"]
                patience = blob["patience"]
                start_epoch = blob["epoch"] + 1
                log_fn(f"resumed from {resume_from} at epoch {start_epoch}")

            for epoch in range(start_epoch, epochs):
                lr = cosine_warm_restarts(epoch, self.base_lr, T_0=10, T_mult=2)
                # WeightedRandomSampler(len(train), replacement=True)
                sampled = rng.choice(train_idx, size=len(train_idx), replace=True, p=p)
                train_loss, tr_preds, tr_ys = self._run_epoch(batches_of(sampled, True), lr, group)
                train_f1 = calculate_f1_score(tr_preds, tr_ys)
                val_loss, va_preds, va_ys = self._run_epoch(batches_of(val_idx, False), None, group)
                val_f1 = calculate_f1_score(va_preds, va_ys)
                acc_0 = float(100.0 * ((va_preds == va_ys) & (va_ys == 0)).sum()
                              / max((va_ys == 0).sum(), 1))
                acc_1 = float(100.0 * ((va_preds == va_ys) & (va_ys == 1)).sum()
                              / max((va_ys == 1).sum(), 1))

                history["train_loss"].append(train_loss)
                history["val_loss"].append(val_loss)
                for split, f1 in (("train", train_f1), ("val", val_f1)):
                    for key in ("f1_class_0", "f1_class_1", "f1_avg"):
                        history[f"{split}_{key}"].append(f1[key])
                history["val_acc_0"].append(acc_0)
                history["val_acc_1"].append(acc_1)
                log_fn(f"Epoch {epoch + 1}/{epochs} Train: Loss={train_loss:.4f} "
                       f"F1_C1={train_f1['f1_class_1']:.3f} | Val: Loss={val_loss:.4f} "
                       f"F1_C1={val_f1['f1_class_1']:.3f} Acc0={acc_0:.1f}% Acc1={acc_1:.1f}%")

                if val_f1["f1_class_1"] > best_f1:
                    best_f1 = val_f1["f1_class_1"]
                    patience = 0
                    if checkpoint_dir and (writer or sharded):
                        payload = self._best_payload(epoch, {
                            "val_loss": val_loss,
                            "val_f1_class_1": val_f1["f1_class_1"],
                            "val_f1_avg": val_f1["f1_avg"],
                            "val_acc_0": acc_0, "val_acc_1": acc_1}, config)
                        if writer:
                            save_checkpoint(os.path.join(checkpoint_dir,
                                                         "multimodal_best_fixed.ckpt"), payload)
                else:
                    patience += 1
                    if patience >= max_patience:
                        log_fn(f"Early stopping after {patience} epochs")
                        break
                if resume_path and (writer or sharded):
                    model_state = {k: v.detach().cpu().numpy()
                                   for k, v in gather_fusion_state(self.model).items()}
                    optimizer_state = self._whole_optimizer_arrays()
                    if writer:
                        save_resume_checkpoint(
                            resume_path, model_state=model_state,
                            optimizer_state=optimizer_state, epoch=epoch,
                            numpy_rng=rng, generator_state=generator.get_state().cpu().numpy(),
                            history=history, best_val=best_f1,
                            dataset_rng_state=dataset.rng.bit_generator.state,
                            patience=patience)

            unshard_fusion_params_(self.model, self.optimizer)
            if checkpoint_dir and writer:
                os.makedirs(checkpoint_dir, exist_ok=True)
                with open(os.path.join(checkpoint_dir, "training_history_fixed.json"), "w") as f:
                    json.dump(history, f, indent=2)
            return self.model, history
        finally:
            # The groups may not outlive the fit. A fit that raised before
            # gathering the weights leaves shares that refuse to compute.
            set_data_group(self.model, None)
            set_model_group(self.model, None)
