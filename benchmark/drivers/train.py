"""Fusion training: ``FusionTrainer.train_step``, back to back, on the
batches ``FusionTrainer._device_batches`` gathers from a device-resident
seeded dataset, epoch after epoch with the loss pulled at each epoch's end
(``_run_epoch``'s loop), for ``--seconds``.

The records are seeded node embeddings (non-negative, as the RG GNN's
ReLU outputs are) of 492–525 real nodes padded to the trainer's bucket,
the seeded KG matrix and labels from seeded GT discs. The model is the
configuration's (dropout 0.3, ``use_pallas`` off, as the users'
``train-fusion`` builds it), the optimizer ``make_adamw`` as ``fit`` makes
it. ``train_step_ms`` is the window over the steps completed, the window
closing with the last epoch's pull.

``correct``: set-up drives the trainer through its first three steps on
the window's own feed; their losses, the first step's gradient as AdamW got
it (its first moment over 1 − β1) and each parameter's change over the
three steps are held, leaf by leaf, against the plain reference from the
same weights, batches and dropout draws.
"""

from __future__ import annotations

import time
from typing import Dict, List, Tuple

import numpy as np
import torch

import scenes
import weights
from harness import Check, Outcome
from reference.models import set_generator
from reference.train import run_steps

BETA1 = 0.9


def dataset(ctx, kg: torch.Tensor) -> Tuple[Dict[str, torch.Tensor], List[int]]:
    """The padded dataset on the device and each record's real node count."""
    tr, f = ctx.traffic, ctx.config["fusion"]
    g = ctx.generator(2)
    n, bucket = tr["records"], tr["node_bucket"]
    lo, hi = tr["node_range"]
    counts = scenes.node_counts(g, n, lo, hi)
    mask = torch.arange(bucket, device=ctx.device)[None, :] < counts[:, None]
    rg = torch.relu(torch.randn((n, bucket, f["rg_dim"]), generator=g, device=ctx.device))
    rg = torch.where(mask[..., None], rg, 0.0)
    y, edge, score = scenes.disc_labels(g, n, ctx.config["image_size"])
    data = {"rg": rg, "rg_mask": mask, "kg": kg[None].expand(n, *kg.shape).contiguous(),
            "y": y, "edge": edge, "score": score}
    return data, counts.tolist()


def program_steps(ctx, trainer, batches, lr) -> Dict:
    """The first steps through the program's ``train_step``: losses, the
    per-leaf norm of the first gradient (AdamW's first moment after one
    step over 1 − β1) and the parameters after the last step."""
    losses, grad_norms = [], None
    step = ctx.wrapped("step", trainer.train_step)
    for batch in batches:
        loss, _ = step(batch, lr)
        losses.append(loss)
        if grad_norms is None:
            state = trainer.optimizer.state
            grad_norms = {n: torch.linalg.vector_norm(state[p]["exp_avg"]) / (1 - BETA1)
                          if p in state else torch.zeros((), device=p.device)
                          for n, p in trainer.model.named_parameters()}
    params = {n: p.detach().clone() for n, p in trainer.model.named_parameters()}
    return {"losses": [float(x) for x in losses],
            "grad_norms": {n: float(v) for n, v in grad_norms.items()}, "params": params}


def run(ctx) -> Outcome:
    from camouflage_multimodal_tpu_torch.models.fusion import build_multimodal_model
    from camouflage_multimodal_tpu_torch.train.state import make_adamw
    from camouflage_multimodal_tpu_torch.train.train_fusion import FusionTrainer

    cfg, tr, dev = ctx.config, ctx.traffic, ctx.device
    f, t = cfg["fusion"], cfg["train"]
    _, ref_fusion, _, fusion_state, kg = weights.models(cfg, ctx.generator(1))
    data, counts = dataset(ctx, kg)
    ctx.phase("inputs")
    model = build_multimodal_model({**{k: f[k] for k in ("rg_dim", "kg_dim", "hidden_dim",
                                                         "num_heads", "num_classes", "dropout",
                                                         "fusion_type")}, "use_pallas": False})
    model.load_state_dict(fusion_state)
    model.to(dev)
    trainer = FusionTrainer(model=model, learning_rate=t["learning_rate"],
                            weight_decay=t["weight_decay"])
    trainer.optimizer = make_adamw(model.parameters(), t["weight_decay"])
    ctx.phase("models")
    dropout_seed = ctx.seed % (2 ** 62) + 7
    model.set_generator(torch.Generator(device=dev).manual_seed(dropout_seed))
    rng = np.random.default_rng(ctx.seed)
    lr, batch = t["learning_rate"], t["batch_size"]

    def epoch():
        order = rng.permutation(tr["records"])
        return order, FusionTrainer._device_batches(data, order, batch, False, None)

    order, batches = epoch()
    checked = [next(batches) for _ in range(tr["checked_steps"])]
    first = [order[i * batch:(i + 1) * batch] for i in range(tr["checked_steps"])]
    prog = ctx.wrapped("first_steps", lambda b: program_steps(ctx, trainer, b, lr))(checked)
    ctx.synchronize()
    ctx.setup_done()

    steps, nodes = 0, []
    with ctx.tracer.window():
        t0 = time.perf_counter()
        deadline = t0 + ctx.seconds
        position = tr["checked_steps"] * batch
        while True:
            losses = []
            for b in batches:
                loss, _ = trainer.train_step(b, lr)
                losses.append(loss)
                nodes.append([counts[j] for j in order[position:position + batch]])
                position += batch
                steps += 1
                if time.perf_counter() > deadline:
                    break
            total = float(torch.stack(losses).double().sum().cpu()) if losses else 0.0
            if time.perf_counter() > deadline:
                break
            order, batches = epoch()
            position = 0
        window_s = time.perf_counter() - t0
    memory = ctx.memory_peak()
    del trainer, model, data
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    checks = compare(ctx, prog, ref_fusion, fusion_state, kg, first, counts, dropout_seed)
    if not np.isfinite(total):
        checks.append(Check("window_loss_finite", 1.0, 0.0))
    return Outcome(attempted=steps, failed=0, end_to_end={"train_step_ms": 1000 * window_s / steps},
                   checks=checks, memory_peak_bytes=memory,
                   window={"steps": steps, "batches": nodes})


def compare(ctx, prog: Dict, ref_model, state, kg, first, counts, dropout_seed) -> List[Check]:
    """Losses, the first gradient and the change over the checked steps,
    leaf by leaf, against the reference from the same start."""
    tr, t = ctx.traffic, ctx.config["train"]
    limits = tr["limits"]
    data, _ = dataset(ctx, kg)
    batches = [{k: data[k].index_select(0, torch.as_tensor(idx, device=ctx.device))
                for k in ("rg", "rg_mask", "kg", "y", "edge", "score")} for idx in first]
    ref_model.load_state_dict(state)
    set_generator(ref_model, torch.Generator(device=ctx.device).manual_seed(dropout_seed))
    losses, grads, params = run_steps(ref_model, batches, t["learning_rate"], t["weight_decay"])
    loss_gap = max(abs(a - b) / max(abs(b), 1e-12) for a, b in zip(prog["losses"], losses))

    g_ref = {n: float(torch.linalg.vector_norm(g)) for n, g in grads.items()}
    d_ref = {n: float(torch.linalg.vector_norm(params[n] - state[n])) for n in params}
    d_prog = {n: float(torch.linalg.vector_norm(prog["params"][n] - state[n])) for n in params}
    g_med, d_med = float(np.median(list(g_ref.values()))), float(np.median(list(d_ref.values())))
    grad_gap = max(abs(prog["grad_norms"][n] - g_ref[n]) / max(g_ref[n], g_med) for n in g_ref)
    # Leaves whose reference gradient is nought to rounding (under a
    # thousandth of the median leaf's) move under AdamW by round-off alone.
    moved = [n for n in d_ref if g_ref[n] >= 1e-3 * g_med]
    change_gap = max(abs(d_prog[n] - d_ref[n]) / max(d_ref[n], d_med) for n in moved)
    return [Check("loss_gap", loss_gap, limits["loss_gap"]),
            Check("grad_gap", grad_gap, limits["grad_gap"]),
            Check("change_gap", change_gap, limits["change_gap"])]


# ---------------------------------------------------------------------------
# The control and the faults (readings.py, tests/test_benchmark_controls.py)
# ---------------------------------------------------------------------------

def control(ctx) -> None:
    """The reference's steps in the program's place, matrix products in
    TF32: the nearest precision below the configuration's float32."""
    def first_steps(_):
        def steps(batches):
            _, model, _, state, _ = weights.models(ctx.config, ctx.generator(1))
            model.load_state_dict(state)
            set_generator(model, torch.Generator(device=ctx.device)
                          .manual_seed(ctx.seed % (2 ** 62) + 7))
            t = ctx.config["train"]
            prev = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
            torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
            try:
                losses, grads, params = run_steps(model, batches, t["learning_rate"],
                                                  t["weight_decay"])
            finally:
                torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev
            return {"losses": losses, "params": params,
                    "grad_norms": {n: float(torch.linalg.vector_norm(g)) for n, g in grads.items()}}
        return steps

    ctx.wraps["first_steps"] = first_steps


def _half_batch(step):
    def half(batch, lr):
        n = batch["y"].shape[0] // 2
        sub = {k: v[:n] for k, v in batch.items()}
        loss, pred = step(sub, lr)
        return loss * 2, torch.cat([pred, pred])        # the mean over the half, scaled
    return half


def _state_unchanged(step):
    def frozen(batch, lr):
        trainer = step.__self__
        saved = {n: p.detach().clone() for n, p in trainer.model.named_parameters()}
        out = step(batch, lr)
        with torch.no_grad():
            for n, p in trainer.model.named_parameters():
                p.copy_(saved[n])
        return out
    return frozen


FAULTS = {
    "half_batch": lambda ctx: ctx.wraps.__setitem__("step", _half_batch),
    "state_unchanged": lambda ctx: ctx.wraps.__setitem__("step", _state_unchanged),
}
