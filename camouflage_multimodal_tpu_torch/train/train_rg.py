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
pulls its metrics to the host once. ``fit(mesh=)`` trains data-parallel
over the ranks of a :func:`parallel.sharding.make_mesh` mesh. As in the JAX
trainer an epoch keeps
every sample: a ragged tail becomes one more batch of the last
``batch_size`` samples of the order (the tail window), and the numpy RNG is
consumed in the JAX ``fit``'s order (the split permutation, then one
permutation per train epoch), so both packages see the same batches.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from camouflage_multimodal_tpu_torch.convert import region_graph_params_from_state_dict
from camouflage_multimodal_tpu_torch.core.checkpoint import (
    load_resume_checkpoint, save_checkpoint, save_resume_checkpoint)
from camouflage_multimodal_tpu_torch.core.device import resolve_device
from camouflage_multimodal_tpu_torch.models.layers import set_data_group
from camouflage_multimodal_tpu_torch.models.region_graph import RegionGraphGNN
from camouflage_multimodal_tpu_torch.parallel.sharding import (
    all_reduce_grads_, all_reduce_sum, block, data_group, replicate, scatter_rows)
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
            node_mask: torch.Tensor, group=None
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(loss, {loss, acc_mask, acc_instance}) of one batch, every entry a
    0-d tensor; padded nodes count nowhere. Under a data-parallel
    ``group`` the loss is this rank's share of the global batch's and the
    metrics are the global batch's."""
    loss_mask = weighted_cross_entropy(
        outputs["mask_logits"], labels["mask_labels"], MASK_CLASS_WEIGHTS, node_mask, group
    ) * TASK_WEIGHTS["mask"]
    loss_instance = weighted_cross_entropy(
        outputs["instance_logits"], labels["instance_labels"], INSTANCE_CLASS_WEIGHTS, node_mask,
        group) * TASK_WEIGHTS["instance"]
    loss_edge = bce_with_logits(
        outputs["edge_logits"][..., 0], labels["edge_labels"], EDGE_POS_WEIGHT, node_mask, group
    ) * TASK_WEIGHTS["edge"]
    loss = loss_mask + loss_instance + loss_edge

    pred_mask = outputs["mask_logits"].argmax(-1)
    pred_inst = outputs["instance_logits"].argmax(-1)
    counts = all_reduce_sum(torch.stack([
        ((pred_mask == labels["mask_labels"]) & node_mask).sum(),
        ((pred_inst == labels["instance_labels"]) & node_mask).sum(),
        node_mask.sum()]).float(), group)
    n = torch.clamp(counts[2], min=1.0)
    metrics = {
        "loss": all_reduce_sum(loss.detach(), group),
        "acc_mask": counts[0] / n,
        "acc_instance": counts[1] / n,
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
                             device: str | torch.device = "cuda", group=None) -> Batch:
        """The graphs and labels of the whole dataset, stacked on ``device``.
        Builds in batches of ``batch_size`` (the last one padded with its
        final sample, which is then dropped). The adjacency is not stored: it
        is exactly ``edge_weights > 0`` (the weights are strictly positive on
        RAG edges); ``weights_dtype=torch.bfloat16`` halves that buffer.
        Under a data-parallel ``group`` rank r builds every world-th batch
        from the r-th (the same batches and padding, so the same graphs) and
        the cache is then gathered whole onto every rank."""
        n = len(dataset)
        starts = list(range(0, n, batch_size))
        rows = []
        parts: Dict[str, List[torch.Tensor]] = {k: [] for k in DATA_KEYS}
        if group is not None:
            starts = starts[dist.get_rank(group)::dist.get_world_size(group)]
        for j in starts:
            chunk = list(range(j, min(j + batch_size, n)))
            rows.extend(chunk)
            raw = dataset.load_batch(chunk + [chunk[-1]] * (batch_size - len(chunk)))
            batch, labels = self.build_graphs(raw["image"], raw["mask"], raw["instance"],
                                              raw["edge"], device)
            keep = len(chunk)
            parts["features"].append(batch.features[:keep])
            parts["edge_weights"].append(batch.edge_weights[:keep].to(weights_dtype))
            parts["node_mask"].append(batch.node_mask[:keep])
            for k in LABEL_KEYS:
                parts[k].append(labels[k][:keep])
        if group is None:
            return {k: torch.cat(v) for k, v in parts.items()}
        dev = resolve_device(device)
        idx = torch.tensor(rows, dtype=torch.long, device=dev)
        like = self._empty_graphs(weights_dtype, dev)
        return {k: scatter_rows(torch.cat(parts[k]) if parts[k] else like[k], idx, n, group)
                for k in DATA_KEYS}

    def _empty_graphs(self, weights_dtype: torch.dtype, dev: torch.device) -> Batch:
        """Zero-row tensors of each cached key (a rank that builds nothing)."""
        K = self.max_nodes
        return {"features": torch.zeros((0, K, self.model.in_channels), device=dev),
                "edge_weights": torch.zeros((0, K, K), dtype=weights_dtype, device=dev),
                "node_mask": torch.zeros((0, K), dtype=torch.bool, device=dev),
                "mask_labels": torch.zeros((0, K), dtype=torch.long, device=dev),
                "instance_labels": torch.zeros((0, K), dtype=torch.long, device=dev),
                "edge_labels": torch.zeros((0, K), device=dev)}

    # ------------------------------------------------------------------
    # Steps
    # ------------------------------------------------------------------

    @staticmethod
    def gather(data: Batch, idx: torch.Tensor) -> Batch:
        """One batch of the cached dataset, taken on its device."""
        batch = {k: data[k].index_select(0, idx) for k in DATA_KEYS}
        batch["edge_weights"] = batch["edge_weights"].float()
        return batch

    def _forward(self, batch: Batch, group=None):
        w = batch["edge_weights"]
        out = self.model(batch["features"], w > 0, w, batch["node_mask"])
        return rg_loss(out, batch, batch["node_mask"], group)

    def train_step(self, batch: Batch, lr: float, group=None) -> Dict[str, torch.Tensor]:
        """One optimizer step; the metrics stay on the batch's device. Under
        a data-parallel ``group`` ``batch`` is this rank's block and the
        gradients are summed over the ranks before the step."""
        self.model.train()
        loss, metrics = self._forward(batch, group)
        loss.backward()
        if group is not None:
            all_reduce_grads_(self.model.parameters(), group)
        apply_updates(self.optimizer, lr)
        return {k: v.detach() for k, v in metrics.items()}

    @torch.no_grad()
    def eval_step(self, batch: Batch, group=None) -> Dict[str, torch.Tensor]:
        self.model.eval()
        return self._forward(batch, group)[1]

    def lr_at_epoch(self, epoch: int) -> float:
        return cosine_warm_restarts(epoch, self.base_lr, T_0=10, T_mult=2)

    def _run_epoch(self, data: Batch, order: np.ndarray, lr: Optional[float], group=None):
        """Train (``lr`` given) or evaluate over the batches of ``order``
        (each rank over its block of every batch under a data-parallel
        ``group``); returns the epoch's mean metrics."""
        steps = []
        for idx in torch.from_numpy(order).to(data["features"].device):
            batch = self.gather(data, idx[block(len(idx), group)])
            steps.append(self.train_step(batch, lr, group) if lr is not None
                         else self.eval_step(batch, group))
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
        every epoch and ``resume_from`` continues one bit-exactly, on the card
        too when it rebuilds its graphs: the build's segment sums run in a
        fixed order there (``ops.regions.index_sum``), so a rebuilt dataset
        has the same bits.

        ``mesh`` (a :func:`parallel.sharding.make_mesh` mesh, one process per
        rank) trains data-parallel: the graph build is split over the ranks
        by build batch and gathered, every step runs on this rank's block of
        the global batch with global loss normalizers, BatchNorm statistics
        and dropout draws, and the gradients are summed. Every rank returns
        the same model and history, those of one rank on the whole batch up
        to float32 summation order; rank 0 alone writes the checkpoints.
        Returns (the trained model, history)."""
        group = data_group(mesh)
        if group is not None:
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

        if self._init_from_seed:
            self.model.reset_parameters(torch.Generator().manual_seed(seed))
        self.model.to(dev)
        if group is not None:
            replicate(self.model, mesh)
        set_data_group(self.model, group)
        try:
            self.optimizer = make_adamw(self.model.parameters(), self.weight_decay)
            generator = torch.Generator(device=dev).manual_seed(seed + 1)
            self.model.set_generator(generator)
            self.data = data = self.build_cached_dataset(
                dataset, batch_size=max(batch_size, 16), weights_dtype=weights_dtype, device=dev,
                group=group)

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
                tr = self._run_epoch(data, epoch_order(rng, train_idx, batch_size, True), lr, group)
                va = (self._run_epoch(data, epoch_order(rng, val_idx, batch_size, False),
                                      None, group) if len(val_idx) else None)
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
                    if writer:
                        save_checkpoint(checkpoint_path, self.checkpoint_payload(epoch, va_loss))
                if resume_path and writer:
                    save_resume_checkpoint(
                        resume_path,
                        model_state={k: v.detach().cpu().numpy()
                                     for k, v in self.model.state_dict().items()},
                        optimizer_state=optimizer_arrays(self.model, self.optimizer),
                        epoch=epoch, numpy_rng=rng,
                        generator_state=generator.get_state().cpu().numpy(),
                        history=history, best_val=best_val)
            return self.model, history
        finally:
            set_data_group(self.model, None)   # the group may not outlive the fit
