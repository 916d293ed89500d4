"""Knowledge-graph GNN trainer and category-embedding factory, port of
``camouflage_multimodal_tpu/train/train_kg.py``.

Adam with L2 (lr 1e-3, wd 1e-5) after a global-norm clip of 1.0, MSE on
the camouflage score, the JAX package's own reduce-on-plateau rule (an
improvement is a validation loss below the best by more than 1e-8; after
more than 5 epochs without one the learning rate drops tenfold), an 80/20
split and the best checkpoint on validation loss in the JAX package's
layout. The padded subgraphs live on the device; every epoch gathers its
batches there by index, keeps every sample through the tail window of
:func:`train.train_rg.epoch_order` and pulls its losses once.

The embedding factory: per category, the mean ``embedding`` of at most
``limit`` subgraphs → one (1, 128) vector; the per-category MAE self-test
and the pairwise cosine-separation report.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from camouflage_multimodal_tpu_torch.convert import knowledge_graph_params_from_state_dict
from camouflage_multimodal_tpu_torch.core.checkpoint import (
    load_resume_checkpoint, save_checkpoint, save_resume_checkpoint)
from camouflage_multimodal_tpu_torch.core.device import resolve_device
from camouflage_multimodal_tpu_torch.kg.featurize import build_subgraph, pad_subgraphs
from camouflage_multimodal_tpu_torch.kg.store import CamouflageKnowledgeStore
from camouflage_multimodal_tpu_torch.models.knowledge_graph import KnowledgeGraphGNN
from camouflage_multimodal_tpu_torch.train.state import (
    apply_updates, load_optimizer_arrays, make_adam_l2, optimizer_arrays)
from camouflage_multimodal_tpu_torch.train.train_rg import epoch_order

Batch = Dict[str, torch.Tensor]
DATA_KEYS = ("x", "adj", "mask", "y")


def create_dataset_from_store(store: CamouflageKnowledgeStore,
                              limit_per_category: int = 50) -> List[dict]:
    """The subgraphs of every category, categories by descending count."""
    return [build_subgraph(rec)
            for category, _ in store.categories()
            for rec in store.extract_category_subgraphs(category, limit=limit_per_category)]


def plateau_step(val_loss: float, best_val: float, lr: float, plateau: int,
                 patience: int = 5, factor: float = 0.1) -> Tuple[float, int]:
    """(lr, plateau counter) after one epoch: an improvement (a loss below
    ``best_val − 1e-8``) resets the counter; the counter's ``patience + 1``-th
    epoch without one scales ``lr`` by ``factor`` and resets it. The JAX
    trainer's rule, not ``torch.optim.lr_scheduler.ReduceLROnPlateau``'s
    (whose default threshold is 1e-4 relative)."""
    if val_loss < best_val - 1e-8:
        return lr, 0
    plateau += 1
    if plateau > patience:
        return lr * factor, 0
    return lr, plateau


class KGTrainer:
    """Trains the ``KnowledgeGraphGNN`` it is given, or a default one
    initialised from ``fit``'s seed."""

    def __init__(self, model: Optional[KnowledgeGraphGNN] = None,
                 max_nodes: int = 64, learning_rate: float = 1e-3,
                 weight_decay: float = 1e-5) -> None:
        self._init_from_seed = model is None
        self.model = model if model is not None else KnowledgeGraphGNN()
        self.max_nodes = max_nodes
        self.base_lr = learning_rate
        self.weight_decay = weight_decay
        self.optimizer: Optional[torch.optim.Optimizer] = None

    # ------------------------------------------------------------------
    # Steps
    # ------------------------------------------------------------------

    def _loss(self, batch: Batch) -> torch.Tensor:
        out = self.model(batch["x"], batch["adj"], batch["mask"])
        return torch.mean((out["score"][:, 0] - batch["y"]) ** 2)

    def train_step(self, batch: Batch, lr: float) -> torch.Tensor:
        """One optimizer step; the loss stays on the batch's device."""
        self.model.train()
        loss = self._loss(batch)
        loss.backward()
        apply_updates(self.optimizer, lr)
        return loss.detach()

    @torch.no_grad()
    def eval_step(self, batch: Batch) -> torch.Tensor:
        self.model.eval()
        return self._loss(batch)

    def _run_epoch(self, data: Batch, order: np.ndarray, lr: Optional[float]) -> float:
        losses = []
        for idx in torch.from_numpy(order).to(data["x"].device):
            batch = {k: data[k].index_select(0, idx) for k in DATA_KEYS}
            losses.append(self.train_step(batch, lr) if lr is not None else self.eval_step(batch))
        return float(np.mean(torch.stack(losses).cpu().numpy()))

    @staticmethod
    def device_dataset(subgraphs: List[dict], max_nodes: int, dev: torch.device,
                       log_fn=print) -> Batch:
        """The padded subgraphs on ``dev``; truncations are reported."""
        x, adj, mask, y, truncated = pad_subgraphs(subgraphs, max_nodes)
        if truncated:
            log_fn(f"warning: {truncated} subgraphs truncated to {max_nodes} nodes")
        return {k: torch.from_numpy(v).to(dev) for k, v in zip(DATA_KEYS, (x, adj, mask, y))}

    # ------------------------------------------------------------------
    # fit
    # ------------------------------------------------------------------

    def checkpoint_payload(self, epoch: int, val_loss: float) -> Dict:
        """The best checkpoint in the JAX package's layout."""
        params, batch_stats = knowledge_graph_params_from_state_dict(self.model.state_dict())
        return {"params": params, "batch_stats": batch_stats,
                "embedding_dim": self.model.embedding_dim, "epoch": epoch,
                "val_loss": val_loss}

    def fit(self, subgraphs: List[dict], epochs: int = 50, batch_size: int = 32,
            train_split: float = 0.8, seed: int = 0,
            checkpoint_path: Optional[str] = "kg_gnn_model.ckpt",
            resume_from: Optional[str] = None, resume_path: Optional[str] = None,
            device: str | torch.device = "cuda",
            log_fn=print) -> Tuple[KnowledgeGraphGNN, Dict[str, List[float]]]:
        """Train on ``device`` (``"cuda"`` raises without a card). Resume as
        :meth:`train.train_rg.RGTrainer.fit`, with the learning rate and the
        plateau counter in the snapshot. Returns (the trained model,
        history)."""
        dev = resolve_device(device)
        rng = np.random.default_rng(seed)
        data = self.device_dataset(subgraphs, self.max_nodes, dev, log_fn)
        n = len(subgraphs)
        perm = rng.permutation(n)
        n_train = int(train_split * n)
        tr, va = perm[:n_train], perm[n_train:]

        if self._init_from_seed:
            self.model.reset_parameters(torch.Generator().manual_seed(seed))
        self.model.to(dev)
        self.optimizer = make_adam_l2(self.model.parameters(), self.weight_decay)
        generator = torch.Generator(device=dev).manual_seed(seed + 1)
        self.model.set_generator(generator)

        history: Dict[str, List[float]] = {"train_loss": [], "val_loss": []}
        best_val = float("inf")
        lr = self.base_lr
        plateau = 0
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
            lr = blob["lr"]
            plateau = blob["plateau"]
            start_epoch = blob["epoch"] + 1
            log_fn(f"resumed from {resume_from} at epoch {start_epoch}")

        for epoch in range(start_epoch, epochs):
            tr_loss = self._run_epoch(data, epoch_order(rng, tr, batch_size, True), lr)
            va_loss = (self._run_epoch(data, epoch_order(rng, va, batch_size, False), None)
                       if len(va) else tr_loss)
            history["train_loss"].append(tr_loss)
            history["val_loss"].append(va_loss)
            log_fn(f"Epoch {epoch + 1}/{epochs} | Train: {tr_loss:.4f} | Val: {va_loss:.4f}")

            lr, plateau = plateau_step(va_loss, best_val, lr, plateau)
            if va_loss < best_val:
                best_val = va_loss
                if checkpoint_path:
                    save_checkpoint(checkpoint_path, self.checkpoint_payload(epoch, va_loss))
            if resume_path:
                save_resume_checkpoint(
                    resume_path,
                    model_state={k: v.detach().cpu().numpy()
                                 for k, v in self.model.state_dict().items()},
                    optimizer_state=optimizer_arrays(self.model, self.optimizer),
                    epoch=epoch, numpy_rng=rng,
                    generator_state=generator.get_state().cpu().numpy(),
                    history=history, best_val=best_val, lr=lr, plateau=plateau)
        return self.model, history

    # ------------------------------------------------------------------
    # Embedding factory
    # ------------------------------------------------------------------

    def _padded(self, model: KnowledgeGraphGNN, store: CamouflageKnowledgeStore,
                category: str, limit: int):
        """(x, adj, mask on the model's device, y on the host) of a
        category's first ``limit`` subgraphs, or None without any."""
        records = store.extract_category_subgraphs(category, limit=limit)
        if not records:
            return None
        x, adj, mask, y, _ = pad_subgraphs([build_subgraph(r) for r in records],
                                           self.max_nodes)
        dev = next(model.parameters()).device
        return (*(torch.from_numpy(a).to(dev) for a in (x, adj, mask)), y)

    @torch.no_grad()
    def extract_category_embedding(self, model: KnowledgeGraphGNN,
                                   store: CamouflageKnowledgeStore, category: str,
                                   limit: int = 10) -> Optional[np.ndarray]:
        """(1, embedding_dim): the mean embedding of the category's first
        ``limit`` subgraphs, in eval mode; None for an empty category."""
        padded = self._padded(model, store, category, limit)
        if padded is None:
            return None
        emb = model.eval()(*padded[:3])["embedding"]
        return emb.mean(dim=0, keepdim=True).cpu().numpy()

    def batch_extract_embeddings(self, model: KnowledgeGraphGNN,
                                 store: CamouflageKnowledgeStore, limit: int = 10
                                 ) -> Tuple[Dict[str, np.ndarray], Dict[str, dict]]:
        """(category → embedding, category → statistics) over the store."""
        embeddings: Dict[str, np.ndarray] = {}
        stats: Dict[str, dict] = {}
        for category, count in store.categories():
            emb = self.extract_category_embedding(model, store, category, limit)
            if emb is None:
                continue
            embeddings[category] = emb
            stats[category] = {
                "organism_count": count,
                "embedding_norm": float(np.linalg.norm(emb)),
                "embedding_mean": float(emb.mean()),
                "embedding_std": float(emb.std()),
            }
        return embeddings, stats

    @torch.no_grad()
    def test_model_predictions(self, model: KnowledgeGraphGNN,
                               store: CamouflageKnowledgeStore,
                               num_categories: int = 5, limit: int = 5) -> Dict[str, float]:
        """Mean absolute error of the predicted score, per category."""
        maes = {}
        for category, _ in store.categories()[:num_categories]:
            padded = self._padded(model, store, category, limit)
            if padded is None:
                continue
            pred = model.eval()(*padded[:3])["score"][:, 0].cpu().numpy()
            maes[category] = float(np.mean(np.abs(pred - padded[3])))
        return maes


def compare_embeddings(embeddings: Dict[str, np.ndarray]) -> Dict[str, float]:
    """Pairwise cosine similarity of the category embeddings."""
    categories = list(embeddings.keys())
    sims = {}
    for i, c1 in enumerate(categories):
        for c2 in categories[i + 1:]:
            a = embeddings[c1].reshape(-1)
            b = embeddings[c2].reshape(-1)
            denom = np.linalg.norm(a) * np.linalg.norm(b)
            sims[f"{c1} vs {c2}"] = float(a @ b / denom) if denom > 0 else 0.0
    return sims
