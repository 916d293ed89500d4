"""Region-graph multi-task trainer, port of
``camouflage_multimodal_tpu/train/train_rg.py``.

AdamW (lr 1e-3, wd 1e-4) with global-norm clip 1.0, cosine warm restarts
(T_0 = 10, T_mult = 2) stepped per epoch; class-weighted CE on the mask
([1, 5]) and instance ([1, 4]) heads and BCE with pos_weight 3 on the edge
head, task weights 2 / 1 / 0.5; an 80/20 random split and the best
checkpoint on validation loss, written in the JAX package's layout so that
both packages' ``load_rg_model`` read it.

The graphs are built once, on the device, by
:func:`pipeline.build_region_graphs_with_labels` (SLIC through kernel B1,
connectivity, Canny, features, RAG) in batches of ``max(batch_size, 16)``
and kept there; every epoch gathers its batches by index on the device and
pulls its metrics to the host once. As in the JAX trainer an epoch keeps
every sample: a ragged tail becomes one more batch of the last
``batch_size`` samples of the order (the tail window), and the numpy RNG is
consumed in the JAX ``fit``'s order (the split permutation, then one
permutation per train epoch), so both packages see the same batches.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from camouflage_multimodal_tpu_torch.convert import region_graph_params_from_state_dict
from camouflage_multimodal_tpu_torch.core.checkpoint import (
    load_resume_checkpoint, save_checkpoint, save_resume_checkpoint)
from camouflage_multimodal_tpu_torch.core.device import resolve_device
from camouflage_multimodal_tpu_torch.models.region_graph import RegionGraphGNN
from camouflage_multimodal_tpu_torch.pipeline import (
    build_region_graphs_with_labels, padded_nodes)
from camouflage_multimodal_tpu_torch.train.losses import bce_with_logits, weighted_cross_entropy
from camouflage_multimodal_tpu_torch.train.schedules import cosine_warm_restarts
from camouflage_multimodal_tpu_torch.train.state import (
    apply_updates, load_optimizer_arrays, make_adamw, optimizer_arrays)

Batch = Dict[str, torch.Tensor]
TASK_WEIGHTS = {"mask": 2.0, "instance": 1.0, "edge": 0.5}
MASK_CLASS_WEIGHTS = (1.0, 5.0)
INSTANCE_CLASS_WEIGHTS = (1.0, 4.0)
EDGE_POS_WEIGHT = 3.0
LABEL_KEYS = ("mask_labels", "instance_labels", "edge_labels")
DATA_KEYS = ("features", "edge_weights", "node_mask") + LABEL_KEYS


def rg_loss(outputs: Dict[str, torch.Tensor], labels: Dict[str, torch.Tensor],
            node_mask: torch.Tensor) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(loss, {loss, acc_mask, acc_instance}) of one batch, every entry a
    0-d tensor; padded nodes count nowhere."""
    loss_mask = weighted_cross_entropy(
        outputs["mask_logits"], labels["mask_labels"], MASK_CLASS_WEIGHTS, node_mask
    ) * TASK_WEIGHTS["mask"]
    loss_instance = weighted_cross_entropy(
        outputs["instance_logits"], labels["instance_labels"], INSTANCE_CLASS_WEIGHTS, node_mask
    ) * TASK_WEIGHTS["instance"]
    loss_edge = bce_with_logits(
        outputs["edge_logits"][..., 0], labels["edge_labels"], EDGE_POS_WEIGHT, node_mask
    ) * TASK_WEIGHTS["edge"]
    loss = loss_mask + loss_instance + loss_edge

    n = torch.clamp(node_mask.sum().float(), min=1.0)
    pred_mask = outputs["mask_logits"].argmax(-1)
    pred_inst = outputs["instance_logits"].argmax(-1)
    metrics = {
        "loss": loss,
        "acc_mask": ((pred_mask == labels["mask_labels"]) & node_mask).sum() / n,
        "acc_instance": ((pred_inst == labels["instance_labels"]) & node_mask).sum() / n,
    }
    return loss, metrics


def epoch_order(rng: np.random.Generator, indices, batch_size: int,
                shuffle: bool) -> np.ndarray:
    """(steps, batch) sample indices of one epoch: ``indices`` (permuted by
    ``rng`` when ``shuffle``) in batches, a ragged tail covered by one more
    batch of the last ``batch_size`` entries; fewer samples than a batch
    make one short batch."""
    order = rng.permutation(indices) if shuffle else np.asarray(indices)
    if len(order) < batch_size:
        return order[None, :].astype(np.int64)
    steps = len(order) // batch_size
    if len(order) - steps * batch_size:
        order = np.concatenate([order[: steps * batch_size], order[-batch_size:]])
        steps += 1
    return order[: steps * batch_size].reshape(steps, batch_size).astype(np.int64)


def mean_per_epoch(step_values: List[Dict[str, torch.Tensor]]) -> Dict[str, float]:
    """Per-step metric tensors → their means over the epoch, pulled to the
    host in one copy (float32 means, as ``np.mean`` of the JAX scan's
    outputs)."""
    keys = list(step_values[0])
    stacked = torch.stack([torch.stack([m[k].float() for k in keys]) for m in step_values])
    host = stacked.cpu().numpy()
    return {k: float(np.mean(host[:, i])) for i, k in enumerate(keys)}


class RGTrainer:
    """Trains the ``RegionGraphGNN`` it is given, or a default one
    initialised from ``fit``'s seed."""

    def __init__(self, model: Optional[RegionGraphGNN] = None,
                 n_segments: int = 500, max_nodes: Optional[int] = None,
                 learning_rate: float = 1e-3, weight_decay: float = 1e-4,
                 slic_iters: int = 10) -> None:
        self._init_from_seed = model is None
        self.model = model if model is not None else RegionGraphGNN()
        self.n_segments = n_segments
        # The SLIC grid of 256² images: 529 clusters at 500 segments → 640.
        self.max_nodes = max_nodes or padded_nodes(n_segments, 256)
        self.slic_iters = slic_iters
        self.base_lr = learning_rate
        self.weight_decay = weight_decay
        self.optimizer: Optional[torch.optim.Optimizer] = None
        # The device-resident dataset of the last fit.
        self.data: Optional[Batch] = None

    # ------------------------------------------------------------------
    # Graphs
    # ------------------------------------------------------------------

    def build_graphs(self, images: np.ndarray, masks: np.ndarray, instances: np.ndarray,
                     edges: np.ndarray, device: str | torch.device = "cuda"):
        """(graph batch, labels) of a batch of images and GT maps, built on
        ``device``. The inputs travel as uint8 (lossless for decoded images
        and masks, a quarter of the float32 bytes)."""
        dev = resolve_device(device)

        def u8(x):
            x = np.asarray(x)
            x = (x * 255.0).round().astype(np.uint8) if x.dtype != np.uint8 else x
            return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

        return build_region_graphs_with_labels(
            u8(images), u8(masks), u8(instances), u8(edges),
            self.n_segments, self.max_nodes, self.slic_iters)

    def build_cached_dataset(self, dataset, batch_size: int = 16,
                             weights_dtype: torch.dtype = torch.float32,
                             device: str | torch.device = "cuda") -> Batch:
        """The graphs and labels of the whole dataset, stacked on ``device``.
        Builds in batches of ``batch_size`` (the last one padded with its
        final sample, which is then dropped). The adjacency is not stored: it
        is exactly ``edge_weights > 0`` (the weights are strictly positive on
        RAG edges); ``weights_dtype=torch.bfloat16`` halves that buffer."""
        n = len(dataset)
        parts: Dict[str, List[torch.Tensor]] = {k: [] for k in DATA_KEYS}
        for j in range(0, n, batch_size):
            chunk = list(range(j, min(j + batch_size, n)))
            raw = dataset.load_batch(chunk + [chunk[-1]] * (batch_size - len(chunk)))
            batch, labels = self.build_graphs(raw["image"], raw["mask"], raw["instance"],
                                              raw["edge"], device)
            keep = len(chunk)
            parts["features"].append(batch.features[:keep])
            parts["edge_weights"].append(batch.edge_weights[:keep].to(weights_dtype))
            parts["node_mask"].append(batch.node_mask[:keep])
            for k in LABEL_KEYS:
                parts[k].append(labels[k][:keep])
        return {k: torch.cat(v) for k, v in parts.items()}

    # ------------------------------------------------------------------
    # Steps
    # ------------------------------------------------------------------

    @staticmethod
    def gather(data: Batch, idx: torch.Tensor) -> Batch:
        """One batch of the cached dataset, taken on its device."""
        batch = {k: data[k].index_select(0, idx) for k in DATA_KEYS}
        batch["edge_weights"] = batch["edge_weights"].float()
        return batch

    def _forward(self, batch: Batch):
        w = batch["edge_weights"]
        out = self.model(batch["features"], w > 0, w, batch["node_mask"])
        return rg_loss(out, batch, batch["node_mask"])

    def train_step(self, batch: Batch, lr: float) -> Dict[str, torch.Tensor]:
        """One optimizer step; the metrics stay on the batch's device."""
        self.model.train()
        loss, metrics = self._forward(batch)
        loss.backward()
        apply_updates(self.optimizer, lr)
        return {k: v.detach() for k, v in metrics.items()}

    @torch.no_grad()
    def eval_step(self, batch: Batch) -> Dict[str, torch.Tensor]:
        self.model.eval()
        return self._forward(batch)[1]

    def lr_at_epoch(self, epoch: int) -> float:
        return cosine_warm_restarts(epoch, self.base_lr, T_0=10, T_mult=2)

    def _run_epoch(self, data: Batch, order: np.ndarray, lr: Optional[float]):
        """Train (``lr`` given) or evaluate over the batches of ``order``;
        returns the epoch's mean metrics."""
        steps = []
        for idx in torch.from_numpy(order).to(data["features"].device):
            batch = self.gather(data, idx)
            steps.append(self.train_step(batch, lr) if lr is not None else self.eval_step(batch))
        return mean_per_epoch(steps)

    # ------------------------------------------------------------------
    # fit
    # ------------------------------------------------------------------

    def checkpoint_payload(self, epoch: int, val_loss: float) -> Dict:
        """The best checkpoint in the JAX package's layout."""
        params, batch_stats = region_graph_params_from_state_dict(self.model.state_dict())
        return {"params": params, "batch_stats": batch_stats, "epoch": epoch,
                "val_loss": val_loss,
                "model_config": {"in_channels": self.model.in_channels,
                                 "hidden_channels": self.model.hidden_channels,
                                 "num_classes": self.model.num_classes}}

    def fit(self, dataset, epochs: int = 30, batch_size: int = 4,
            train_split: float = 0.8, seed: int = 0,
            checkpoint_path: Optional[str] = "best_model.ckpt",
            weights_dtype: torch.dtype = torch.float32,
            resume_from: Optional[str] = None, resume_path: Optional[str] = None,
            mesh=None, device: str | torch.device = "cuda",
            log_fn=print) -> Tuple[RegionGraphGNN, Dict[str, List[float]]]:
        """Train on ``device`` (``"cuda"`` raises without a card; ``"cpu"``
        runs the plain versions) over a dataset with ``load_batch`` (a
        :class:`data.CODDataset`). ``resume_path`` snapshots the run after
        every epoch and ``resume_from`` continues one bit-exactly on the same
        cached graphs (on the card, ``index_add_``'s atomics may change the
        last bits of a rebuilt dataset's features). Returns (the trained
        model, history)."""
        if mesh is not None:
            raise NotImplementedError(
                "mesh= (data-parallel RG training) is not ported yet: "
                "ROADMAP Queue A, the parallel/ item")
        dev = resolve_device(device)
        rng = np.random.default_rng(seed)
        n = len(dataset)
        perm = rng.permutation(n)
        n_train = int(train_split * n)
        train_idx, val_idx = perm[:n_train], perm[n_train:]

        if self._init_from_seed:
            self.model.reset_parameters(torch.Generator().manual_seed(seed))
        self.model.to(dev)
        self.optimizer = make_adamw(self.model.parameters(), self.weight_decay)
        generator = torch.Generator(device=dev).manual_seed(seed + 1)
        self.model.set_generator(generator)
        self.data = data = self.build_cached_dataset(
            dataset, batch_size=max(batch_size, 16), weights_dtype=weights_dtype, device=dev)

        history: Dict[str, List[float]] = {"train_loss": [], "val_loss": [],
                                           "train_acc_mask": [], "val_acc_mask": []}
        best_val = float("inf")
        start_epoch = 0
        if resume_from:
            blob = load_resume_checkpoint(resume_from)
            self.model.load_state_dict(
                {k: torch.from_numpy(np.array(v)) for k, v in blob["model_state"].items()})
            load_optimizer_arrays(self.model, self.optimizer, blob["optimizer_state"])
            rng.bit_generator.state = blob["numpy_rng_state"]
            generator.set_state(torch.from_numpy(np.array(blob["generator_state"])))
            history = blob["history"]
            best_val = blob["best_val"]
            start_epoch = blob["epoch"] + 1
            log_fn(f"resumed from {resume_from} at epoch {start_epoch}")

        for epoch in range(start_epoch, epochs):
            lr = self.lr_at_epoch(epoch)
            tr = self._run_epoch(data, epoch_order(rng, train_idx, batch_size, True), lr)
            va = (self._run_epoch(data, epoch_order(rng, val_idx, batch_size, False), None)
                  if len(val_idx) else None)
            va_loss = va["loss"] if va else float("nan")
            history["train_loss"].append(tr["loss"])
            history["val_loss"].append(va_loss)
            history["train_acc_mask"].append(tr["acc_mask"])
            history["val_acc_mask"].append(va["acc_mask"] if va else float("nan"))
            log_fn(f"Epoch {epoch + 1}/{epochs} - Loss: {tr['loss']:.4f} - Val Loss: "
                   f"{va_loss:.4f} - Val Mask Acc: {history['val_acc_mask'][-1]:.4f} "
                   f"(lr={lr:.6f})")

            if checkpoint_path and va is not None and va_loss < best_val:
                best_val = va_loss
                save_checkpoint(checkpoint_path, self.checkpoint_payload(epoch, va_loss))
            if resume_path:
                save_resume_checkpoint(
                    resume_path,
                    model_state={k: v.detach().cpu().numpy()
                                 for k, v in self.model.state_dict().items()},
                    optimizer_state=optimizer_arrays(self.model, self.optimizer),
                    epoch=epoch, numpy_rng=rng,
                    generator_state=generator.get_state().cpu().numpy(),
                    history=history, best_val=best_val)
        return self.model, history
