"""The ``model`` axis of the PyTorch port (tensor-parallel fusion:
``parallel.sharding.shard_fusion_params``, B2 and B3 on a rank's heads) on
the CPU, and the two device defaults of ``parallel/`` that must not fall
back to the CPU.

* The kernels' plain versions on head subsets, from the model's own
  initialisation: the ranks' partial outputs plus ``bo`` equal the whole
  attention within 1e-6 of its largest entry, the probabilities within
  1e-7, the backward (the input gradients summed over the ranks, the
  parameter gradients each rank's slice) within 1e-5.
* One fusion train step at the full width (hidden 256, 8 heads; 64 nodes,
  13 KG categories, batch 2), dropout 0, on a (1, 2) mesh of two gloo ranks
  against the JAX package's ``FusionTrainer._train_step`` on a (1, 2) mesh
  of two forced CPU devices with its ``shard_fusion_params`` (the
  ``dryrun_multichip`` recipe), from the same weights: loss rtol 1e-4,
  every parameter within 1e-4 of its largest entry (plus 1e-3·lr: Adam's
  first step moves an entry by lr·g/(|g| + ε), which for |g| near ε turns
  a gradient that differs in its last bits into a step that differs by a
  fraction of lr); the key biases, whose gradient is exactly zero (a
  constant added to all of a row's logits leaves the softmax as it is),
  within 2·lr, as ``tests/test_torch_port_parallel.py`` holds the RG
  biases ahead of a BatchNorm.
* Fits at (1, 2) and (2, 2) (four ranks) against the fit without a mesh,
  with dropout and on-device augmentation, at the sizes of
  ``tests/test_torch_port_parallel.py`` (hidden 64, 4 heads, 32 records,
  batch 8, 3 epochs, lr 1e-3) and its bars: histories rtol 1e-5,
  parameters 3·lr; every rank ends with the same whole model; the best
  checkpoint is the file a fit without a mesh writes (within 3·lr), the
  gathered weights load into a model without a mesh that predicts within
  1e-5 of the sharded one, and a resumed (1, 2) run is bit-exact.
* A (1, 2) fit interrupted before it gathered the weights leaves a model
  that refuses to compute.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
for path in (REPO, HERE):
    if path not in sys.path:
        sys.path.insert(0, path)

import torch_port_ranks as ranks  # noqa: E402

from camouflage_multimodal_tpu_torch.core.checkpoint import load_checkpoint, save_checkpoint  # noqa: E402
from camouflage_multimodal_tpu_torch.models.fusion import MultimodalCamouflageDetector  # noqa: E402
from camouflage_multimodal_tpu_torch.ops import attention as A  # noqa: E402
from camouflage_multimodal_tpu_torch.parallel import distributed, sharding  # noqa: E402
from camouflage_multimodal_tpu_torch.train.state import make_adamw  # noqa: E402
from camouflage_multimodal_tpu_torch.train.train_fusion import FusionDataset, FusionTrainer  # noqa: E402

QUIET = dict(log_fn=lambda *_: None)
FUSION_CFG = {"hidden_dim": 64, "num_heads": 4}
FIT = dict(epochs=3, batch_size=8, train_split=0.75)
LR = 1e-3
STEP_LR = 1e-3
STEP_SHAPE = dict(batch=2, nodes=64, n_kg=13)
# Parameters with an exact gradient of zero (module docstring).
GRADIENT_FREE = ("fusion.cross_attn_rg2kg.bk", "fusion.cross_attn_kg2rg.bk")


# ---------------------------------------------------------------------------
# Inputs, made from seeds on every side
# ---------------------------------------------------------------------------

def records():
    """The records of the JAX fusion mesh test (``tests/test_train.py:422``)."""
    rng = np.random.default_rng(0)
    n, K, nkg = 32, 16, 4
    out = []
    for i in range(n):
        label = i % 2
        base = np.full((K, 128), 2.0 * label - 1.0, np.float32)
        out.append({
            "image_name": f"x{i}.jpg",
            "rg_node_embeddings": base + rng.standard_normal((K, 128)).astype(np.float32) * 0.1,
            "kg_embeddings": rng.standard_normal((nkg, 128)).astype(np.float32),
            "label": label, "confidence": 1.0,
            "edge_label": float(label), "score_label": float(label)})
    return out


def trainer():
    model = MultimodalCamouflageDetector(**FUSION_CFG)
    model.reset_parameters(torch.Generator().manual_seed(0))
    return FusionTrainer(model=model, learning_rate=LR)


def fit(mesh, **kw):
    ds = FusionDataset.from_samples(records(), max_rg_nodes=16, augment=True, **QUIET)
    return trainer().fit(ds, device_resident=True, mesh=mesh, device="cpu",
                         config={"model": FUSION_CFG}, **{**FIT, **kw}, **QUIET)


def step_batch():
    r = np.random.default_rng(5)
    B, K, nkg = STEP_SHAPE["batch"], STEP_SHAPE["nodes"], STEP_SHAPE["n_kg"]
    return {"rg": r.standard_normal((B, K, 128)).astype(np.float32),
            "rg_mask": np.arange(K)[None] < np.array([K, K - 9])[:, None],
            "kg": r.standard_normal((B, nkg, 128)).astype(np.float32),
            "y": np.array([0, 1]), "edge": np.array([1.0, 0.0], np.float32),
            "score": r.random(B).astype(np.float32)}


def probe_batch():
    return {k: torch.from_numpy(v) for k, v in FusionDataset.from_samples(
        records(), max_rg_nodes=16, **QUIET).collate(list(range(6))).items()}


def _state(model):
    return {k: v.detach().numpy().copy() for k, v in model.state_dict().items()}


def _predict(model, batch):
    model.eval()
    with torch.no_grad():
        out = model(batch["rg"], batch["kg"], rg_mask=batch["rg_mask"], return_attention=True)
    return {"mask_logits": out["mask_logits"], "score": out["score"],
            "rg2kg": out["attention"]["rg2kg"], "kg2rg": out["attention"]["kg2rg"]}


# ---------------------------------------------------------------------------
# The ranks
# ---------------------------------------------------------------------------

def task_step(mesh, work):
    """One train step of the full-width model at dropout 0 from the weights
    in ``step_init.npz``, sharded over ``model``: the loss and the whole
    weights after it."""
    model = MultimodalCamouflageDetector(dropout=0.0)
    with np.load(os.path.join(work, "step_init.npz")) as z:
        model.load_state_dict({k: torch.from_numpy(z[k]) for k in z.files})
    sharding.replicate(model, mesh)
    sharding.shard_fusion_params(model, mesh)
    tr = FusionTrainer(model=model, learning_rate=STEP_LR)
    tr.optimizer = make_adamw(model.parameters(), tr.weight_decay)
    batch = sharding.shard_batch({k: torch.from_numpy(v) for k, v in step_batch().items()}, mesh)
    loss, _ = tr.train_step(batch, STEP_LR, sharding.data_group(mesh))
    loss = sharding.all_reduce_sum(loss, sharding.data_group(mesh))
    return {"loss": loss.numpy(),
            **{f"param/{k}": v.numpy() for k, v in sharding.gather_fusion_state(model).items()}}


def task_fit(mesh, work):
    """The fit, its best checkpoint (rank 0), the sharded model's
    predictions on a probe batch and its gathered weights (rank 0)."""
    world = mesh.size()
    model, history = fit(mesh, checkpoint_dir=os.path.join(work, f"fit_w{world}"))
    released = all(getattr(m, "data_group", None) is None and
                   getattr(m, "model_group", None) is None for m in model.modules())
    shards = {k: tuple(v.shape) for k, v in _state(model).items()}
    sharding.shard_fusion_params(model, mesh)
    sharded = _predict(model, probe_batch())
    gathered = sharding.gather_fusion_params(model)   # a collective: every rank
    if torch.distributed.get_rank() == 0:
        save_checkpoint(os.path.join(work, f"gathered_w{world}.ckpt"),
                        {"params": gathered, "config": {"model": FUSION_CFG}})
    whole = sharding.unshard_fusion_params_(model)
    return {"history": np.array(json.dumps(history)), "released": released,
            "whole_shapes": np.array(json.dumps(shards)),
            **{f"probe/{k}": v.numpy() for k, v in sharded.items()},
            **{f"param/{k}": v for k, v in _state(whole).items()}}


def task_resume(mesh, work):
    """Two epochs with a snapshot after each, then a new trainer resumed
    from it to the third."""
    path = os.path.join(work, f"resume_w{mesh.size()}.ckpt")
    fit(mesh, epochs=2, resume_path=path)
    model, history = fit(mesh, resume_from=path)
    return {"history": np.array(json.dumps(history)),
            **{f"param/{k}": v for k, v in _state(model).items()}}


class Interrupted(Exception):
    """What stops :func:`task_interrupted`'s fit."""


def task_interrupted(mesh, work):
    """A fit whose second step raises, as a lost rank or an interrupt would:
    the message a forward pass of the returned model then raises (empty if
    it computed), and the shape of a sharded weight it was left with."""
    tr = trainer()
    steps = []

    def step_once(*args, **kw):
        steps.append(None)
        if len(steps) > 1:
            raise Interrupted
        return FusionTrainer.train_step(tr, *args, **kw)

    tr.train_step = step_once
    ds = FusionDataset.from_samples(records(), max_rg_nodes=16, **QUIET)
    with pytest.raises(Interrupted):
        tr.fit(ds, device_resident=True, mesh=mesh, device="cpu", **FIT, **QUIET)
    try:
        _predict(tr.model, probe_batch())
        refused = ""
    except RuntimeError as err:
        refused = str(err)
    return {"refused": np.array(refused),
            "wq_shape": np.array(tr.model.fusion.cross_attn_rg2kg.wq.shape)}


TASKS = {name[5:]: fn for name, fn in globals().items() if name.startswith("task_")}

JAX_STEP = f"""
import os
import numpy as np, jax, jax.numpy as jnp, torch
from camouflage_multimodal_tpu.models.fusion import MultimodalCamouflageDetector
from camouflage_multimodal_tpu.parallel.sharding import (
    make_mesh, replicate, shard_batch, shard_fusion_params)
from camouflage_multimodal_tpu.train.train_fusion import FusionTrainer
from camouflage_multimodal_tpu_torch.convert import fusion_params_from_state_dict, fusion_state_dict
work = os.environ["WORK"]
with np.load(os.path.join(work, "step_init.npz")) as z:
    params = fusion_params_from_state_dict({{k: torch.from_numpy(z[k]) for k in z.files}})
params = jax.tree_util.tree_map(jnp.asarray, params)
trainer = FusionTrainer(model=MultimodalCamouflageDetector(dropout=0.0))
state = trainer.init_state(jax.random.PRNGKey(0), rg_dim=128, n_kg={STEP_SHAPE["n_kg"]},
                           max_rg_nodes={STEP_SHAPE["nodes"]})
state = state.replace(params=params, opt_state=trainer.tx.init(params))
with np.load(os.path.join(work, "step_batch.npz")) as z:
    batch = {{k: jnp.asarray(z[k]) for k in z.files}}
mesh = make_mesh(jax.devices(), data_axis=1, model_axis=2)
with mesh:
    state = state.replace(params=shard_fusion_params(state.params, mesh),
                          opt_state=replicate(state.opt_state, mesh),
                          step=replicate(state.step, mesh))
    new_state, loss, _ = trainer._train_step(
        state, shard_batch(batch, mesh), replicate(jnp.asarray({STEP_LR}, jnp.float32), mesh),
        replicate(jax.random.PRNGKey(1), mesh), replicate(jnp.asarray(0.75, jnp.float32), mesh))
out = {{"param/" + k: v.numpy() for k, v in fusion_state_dict(
    jax.tree_util.tree_map(np.asarray, new_state.params)).items()}}
np.savez(os.path.join(work, "jax_step.npz"), loss=np.asarray(loss), **out)
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """A (1, 2) group takes the step, the fit and the resumed fit, a (2, 2)
    group the fit, while the test process runs the JAX step and the fit
    without a mesh."""
    work = str(tmp_path_factory.mktemp("model_axis"))
    init = MultimodalCamouflageDetector(dropout=0.0)
    init.reset_parameters(torch.Generator().manual_seed(7))
    np.savez(os.path.join(work, "step_init.npz"), **_state(init))
    np.savez(os.path.join(work, "step_batch.npz"), **step_batch())
    jax_proc = ranks.start_jax(JAX_STEP, 2, work)
    groups = {2: ranks.spawn(__file__, 2, 2, work, ["step", "fit", "resume", "interrupted"]),
              4: ranks.spawn(__file__, 4, 2, work, ["fit"])}
    model, history = fit(None, checkpoint_dir=os.path.join(work, "fit_alone"))
    alone = {"history": history, "params": _state(model),
             "ckpt": os.path.join(work, "fit_alone", "multimodal_best_fixed.ckpt")}
    logs = {world: ranks.wait(procs) for world, procs in groups.items()}
    ranks.finish_jax(jax_proc)

    def result(task, world, rank=0):
        return ranks.result(work, world, 2, task, rank, logs[world])

    return {"result": result, "alone": alone, "work": work,
            "jax": ranks.load(os.path.join(work, "jax_step.npz"))}


def _params(out):
    return {k[6:]: v for k, v in out.items() if k.startswith("param/")}


def _history(out):
    return json.loads(str(out["history"]))


# ---------------------------------------------------------------------------
# The plain versions on head subsets
# ---------------------------------------------------------------------------

def _rank_params(params, rank, world):
    E = params["wq"].shape[1]
    cols = slice(rank * E // world, (rank + 1) * E // world)
    return {n: (t[:, cols] if n in ("wq", "wk", "wv") else t[cols] if n != "bo" else None)
            for n, t in params.items()}


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("nq,nk", [(24, 5), (5, 24)])
def test_plain_attention_on_head_subsets(world, nq, nk):
    """``multihead_attention`` and ``multihead_attention_backward`` on each
    rank's heads (``total_heads`` = 8 of hidden 64), weights drawn by the
    model's initialiser with seeded biases: outputs summed with ``bo``
    within 1e-6 of the whole attention's largest entry (a few float32 ulps
    of it: the sum runs in another order), probabilities summed within
    1e-7, input gradients summed and parameter-gradient slices within 1e-5."""
    from camouflage_multimodal_tpu_torch.models.fusion import MultiheadAttention

    r = np.random.default_rng(nq * 10 + world)
    E, H, B = 64, 8, 3
    t = lambda *s, scale=1.0: torch.from_numpy(  # noqa: E731
        (r.standard_normal(s) * scale).astype(np.float32))
    mha = MultiheadAttention(E, H)
    mha.reset_parameters(torch.Generator().manual_seed(world))
    params = {n: getattr(mha, n).detach() if n[0] == "w" else t(E, scale=0.1)
              for n in A.PARAM_NAMES}
    q, k = t(B, nq, E), t(B, nk, E)
    mask = torch.from_numpy(np.arange(nk)[None] < np.array([nk, nk - 2, 1])[:, None])
    d_out, d_probs = t(B, nq, E), t(B, nq, nk)
    out, probs = A.multihead_attention(params, q, k, k, H, mask)
    d_params, *d_in = A.multihead_attention_backward(params, q, k, k, H, mask, d_out, d_probs)
    out_sum, probs_sum = params["bo"].clone(), torch.zeros_like(probs)
    d_in_sum = [torch.zeros_like(x) for x in d_in]
    for rank in range(world):
        part = _rank_params(params, rank, world)
        o, p = A.multihead_attention(part, q, k, k, H // world, mask, total_heads=H)
        out_sum, probs_sum = out_sum + o, probs_sum + p
        dp, *di = A.multihead_attention_backward(part, q, k, k, H // world, mask, d_out,
                                                 d_probs, total_heads=H)
        d_in_sum = [a + b for a, b in zip(d_in_sum, di)]
        whole = _rank_params(d_params, rank, world)
        for n in A.PARAM_NAMES[:-1]:
            torch.testing.assert_close(dp[n], whole[n], rtol=0, atol=1e-5, msg=n)
        torch.testing.assert_close(dp["bo"], d_params["bo"], rtol=0, atol=1e-5)
    torch.testing.assert_close(out_sum, out, rtol=0, atol=1e-6 * float(out.abs().max()))
    torch.testing.assert_close(probs_sum, probs, rtol=0, atol=1e-7)
    for a, b in zip(d_in_sum, d_in):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-5)


def test_fused_mha_autograd_on_a_ranks_heads():
    """``fused_mha`` on a rank's heads with no ``bo`` (the CPU route of
    ``FusedMHA``): the output has the out-projection's width, ``bo`` gets no
    gradient, the others get the plain backward's."""
    r = np.random.default_rng(1)
    params = {n: torch.from_numpy((r.standard_normal((32, 32) if n[0] == "w" else (32,)) * 0.2)
                                  .astype(np.float32)) for n in A.PARAM_NAMES}
    part = {n: (None if v is None else v.clone().requires_grad_())
            for n, v in _rank_params(params, 1, 2).items()}
    q = torch.from_numpy(r.standard_normal((2, 6, 32)).astype(np.float32))
    out, probs = A.fused_mha(part, q, q, q, 2, total_heads=4)
    assert out.shape == (2, 6, 32) and probs.shape == (2, 6, 6)
    (out.sum() + probs.square().sum()).backward()
    d_params, *_ = A.multihead_attention_backward(
        {n: None if v is None else v.detach() for n, v in part.items()}, q, q, q, 2, None,
        torch.ones_like(out), 2 * probs.detach(), total_heads=4)
    for n, v in part.items():
        if v is not None:
            torch.testing.assert_close(v.grad, d_params[n], rtol=1e-5, atol=1e-6, msg=n)


# ---------------------------------------------------------------------------
# One train step against the JAX package's sharded step
# ---------------------------------------------------------------------------

def test_train_step_matches_jax_sharded_step(runs):
    """The loss of one full-width train step at (1, 2) within rtol 1e-4 of
    JAX's on its (1, 2) mesh, and every parameter after it within 1e-4 of
    the largest entry of the JAX one plus 1e-3·lr (the key biases 2·lr;
    module docstring); both ranks hold the same weights."""
    got = [runs["result"]("step", 2, r) for r in (0, 1)]
    want = runs["jax"]
    np.testing.assert_allclose(got[0]["loss"], want["loss"], rtol=1e-4)
    pg, pw = _params(got[0]), _params(want)
    assert set(pg) == set(pw)
    for key, w in pw.items():
        bar = 2 * STEP_LR if key in GRADIENT_FREE else 1e-4 * np.abs(w).max() + 1e-3 * STEP_LR
        np.testing.assert_allclose(pg[key], w, rtol=0, atol=bar, err_msg=key)
        np.testing.assert_array_equal(_params(got[1])[key], pg[key], err_msg=key)


# ---------------------------------------------------------------------------
# Fits against the fit without a mesh
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("world", [2, 4])
def test_fit_over_the_model_axis_matches_no_mesh(runs, world):
    """(1, 2) and (2, 2) against no mesh, with dropout and augmentation:
    histories rtol 1e-5, parameters 3·lr; every rank returns the same whole
    model (the model's own shapes) and holds no process group."""
    outs = [runs["result"]("fit", world, r) for r in range(world)]
    hist, want = _history(outs[0]), runs["alone"]["history"]
    assert set(hist) == set(want)
    for key in want:
        np.testing.assert_allclose(hist[key], want[key], rtol=1e-5, atol=0, err_msg=key)
    for key, w in runs["alone"]["params"].items():
        np.testing.assert_allclose(_params(outs[0])[key], w, rtol=0, atol=3 * LR, err_msg=key)
        for out in outs[1:]:
            np.testing.assert_array_equal(_params(out)[key], _params(outs[0])[key], err_msg=key)
    for out in outs:
        assert bool(out["released"])
        assert json.loads(str(out["whole_shapes"])) == {
            k: list(v.shape) for k, v in runs["alone"]["params"].items()}


@pytest.mark.parametrize("world", [2, 4])
def test_best_checkpoint_is_the_one_rank_file(runs, world):
    """The best checkpoint a sharded fit writes has the keys and shapes of
    the one a fit without a mesh writes, its weights and Adam moments within
    3·lr (moments 1e-4) of them."""
    got = load_checkpoint(os.path.join(runs["work"], f"fit_w{world}",
                                       "multimodal_best_fixed.ckpt"))
    want = load_checkpoint(runs["alone"]["ckpt"])
    flat = lambda tree, pre="": {  # noqa: E731
        f"{pre}{k}": v for key, node in tree.items()
        for k, v in (flat(node, f"{key}/").items() if isinstance(node, dict)
                     else [(key, node)])}
    assert got["epoch"] == want["epoch"]
    for part, bar in (("params", 3 * LR), ("opt_state", 1e-4)):
        g, w = flat(got[part]), flat(want[part])
        assert set(g) == set(w)
        for key in w:
            np.testing.assert_allclose(np.asarray(g[key]), np.asarray(w[key]), rtol=0,
                                       atol=bar, err_msg=key)


@pytest.mark.parametrize("world", [2, 4])
def test_gathered_weights_predict_like_the_sharded_model(runs, world):
    """``gather_fusion_params`` of the sharded model, saved and loaded by
    ``api.load_multimodal_model`` into a model without a mesh, predicts the
    probe batch (logits, score, both attention maps) within 1e-5 of the
    sharded model."""
    from camouflage_multimodal_tpu_torch.api import load_multimodal_model

    model, _ = load_multimodal_model(os.path.join(runs["work"], f"gathered_w{world}.ckpt"),
                                     device="cpu")
    got = _predict(model, probe_batch())
    out = runs["result"]("fit", world)
    for key, v in got.items():
        np.testing.assert_allclose(v.numpy(), out[f"probe/{key}"], rtol=0, atol=1e-5,
                                   err_msg=key)


def test_resumed_fit_over_the_model_axis_is_bit_exact(runs):
    """Two epochs at (1, 2) with a snapshot (whole weights and moments),
    resumed into a new sharded model to the third: history and weights
    equal to the bit to the straight (1, 2) fit's."""
    got, want = runs["result"]("resume", 2), runs["result"]("fit", 2)
    assert _history(got) == _history(want)
    for key, v in _params(want).items():
        np.testing.assert_array_equal(_params(got)[key], v, err_msg=key)


def test_interrupted_sharded_fit_leaves_a_model_that_refuses(runs):
    """A (1, 2) fit stopped by an exception after its first step, before it
    gathered the weights: on both ranks the model keeps its share (half of
    wq's columns) and no group, and a forward pass raises instead of
    computing another function with a share read as whole weights."""
    for rank in (0, 1):
        out = runs["result"]("interrupted", 2, rank)
        assert tuple(out["wq_shape"]) == (FUSION_CFG["hidden_dim"], FUSION_CFG["hidden_dim"] // 2)
        assert "holds 1/2 of its weights and no model group" in str(out["refused"])


# ---------------------------------------------------------------------------
# No fallback to the CPU
# ---------------------------------------------------------------------------

@pytest.mark.skipif(torch.cuda.is_available(), reason="checks a machine without a card")
def test_make_mesh_without_devices_raises_without_a_card():
    """``make_mesh()`` means the card, as every entry point's default does:
    without one it raises instead of laying a CPU mesh."""
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        sharding.make_mesh()


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks a machine without a card")
def test_initialize_without_device_raises_without_a_card(monkeypatch):
    """``distributed.initialize()`` means ranks on cards: without one it
    raises before joining any group, instead of choosing gloo on the CPU."""
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        distributed.initialize("127.0.0.1:1", 2, 1)
    assert not torch.distributed.is_initialized()


if __name__ == "__main__":
    ranks.rank_main(TASKS, sys.argv[1:])
