"""Data parallelism of the PyTorch port (``camouflage_multimodal_tpu_torch/
parallel/``) on the CPU: two ``gloo`` ranks against one rank, a world of
one against no mesh, and the port against the JAX package's ``fit(mesh=)``.

The ranks are subprocesses of this file's own ``__main__`` block, joined
over localhost on a free port. Every rank has a time limit of its own on
the rendezvous and the collectives (60 s) and the test kills a group that
has not finished within ``RANK_TIMEOUT`` seconds, so a failed rendezvous
fails the tests instead of hanging them. One group of two ranks and one of
one run side by side while the test process computes the JAX references.

Sizes are those of the JAX package's mesh tests (``tests/test_train.py``):
RG, 16 images of 48², 16 segments, a 32-node bucket, batch 8, 2 epochs;
fusion, 32 records of 16 nodes and 4 KG categories, hidden 64, 4 heads,
batch 8, 3 epochs. Tolerances: two ranks against one, loss and accuracy
histories rtol 1e-5 and parameters 3·lr (two partial float32 sums differ
from one sum in the last bits, and Adam turns that into steps of up to lr
on entries whose gradient is near zero; RG's BatchNorm-fed biases, whose
gradient is exactly zero, are held as in the RG training tests, see
``RG_GRADIENT_FREE``); a world of one against no mesh,
equal to the bit; the port against JAX, loss histories rtol 1e-4 (JAX's
own bar between a sharded and a single-device fit; RG's validation loss
1e-3); BatchNorm statistics,
their gradient and directory evaluation 1e-6.
"""

import contextlib
import json
import os
import socket
import subprocess
import sys
import traceback

import numpy as np
import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from camouflage_multimodal_tpu_torch.convert import (  # noqa: E402
    fusion_state_dict, region_graph_state_dict)
from camouflage_multimodal_tpu_torch.models.fusion import MultimodalCamouflageDetector  # noqa: E402
from camouflage_multimodal_tpu_torch.models.region_graph import RegionGraphGNN  # noqa: E402
from camouflage_multimodal_tpu_torch.ops.graph import masked_batch_stats  # noqa: E402
from camouflage_multimodal_tpu_torch.parallel import distributed, sharding  # noqa: E402
from camouflage_multimodal_tpu_torch.pipeline import RegionGraphPipeline  # noqa: E402
from camouflage_multimodal_tpu_torch.train.train_fusion import (  # noqa: E402
    FusionDataset, FusionTrainer)
from camouflage_multimodal_tpu_torch.train.train_rg import RGTrainer  # noqa: E402

RANK_TIMEOUT = 150
QUIET = dict(log_fn=lambda *_: None)
RG_KW = dict(n_segments=16, max_nodes=32, slic_iters=2)
RG_FIT = dict(epochs=2, batch_size=8, checkpoint_path=None)
RG_LR = 1e-3
FUSION_CFG = {"hidden_dim": 64, "num_heads": 4}
# 24 train and 8 validation records: a short validation batch must divide.
FUSION_FIT = dict(epochs=3, batch_size=8, train_split=0.75)
FUSION_LR = 1e-3
RG_CKPT = os.path.join(REPO, "artifacts", "rg_model.ckpt")
EVAL_SIZE = 64
EVAL_SEGMENTS = 60
EVAL_THRESHOLD = 0.02        # the committed model's heatmaps are faint on these images
EVAL_IMAGES = 7              # one without a GT file: 6 evaluated, batches of 4 and 2
BN_COUNTS = (6, 2, 0, 5)     # valid nodes of the 4 graphs: rank 0 holds 8, rank 1 holds 5


# ---------------------------------------------------------------------------
# Inputs, made from seeds on both sides
# ---------------------------------------------------------------------------

class TinyDataset:
    """The dataset of the JAX RG mesh test (``tests/test_train.py:464``)."""

    def __init__(self, n=16, size=48):
        r = np.random.default_rng(5)
        self.images = r.random((n, size, size, 3)).astype(np.float32)
        self.masks = (r.random((n, size, size)) > 0.6).astype(np.float32)
        self.instances = self.masks
        self.edges = (r.random((n, size, size)) > 0.9).astype(np.float32)

    def __len__(self):
        return len(self.images)

    def load_batch(self, idx):
        return {"image": self.images[idx], "mask": self.masks[idx],
                "instance": self.instances[idx], "edge": self.edges[idx]}


def fusion_records():
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


def bn_case():
    """(x (4, 6, 3), mask (4, 6), cotangent (4, 6, 3)) with BN_COUNTS."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((4, 6, 3)).astype(np.float32) * 2 + 1
    mask = np.arange(6)[None] < np.array(BN_COUNTS)[:, None]
    c = rng.standard_normal((4, 6, 3)).astype(np.float32)
    return x, mask, c


def bn_forward(x, mask, c, group=None):
    """Statistics, and the gradient of Σ c·BN(x) with respect to x."""
    x = torch.from_numpy(x).requires_grad_(True)
    mean, var, n = masked_batch_stats(x, torch.from_numpy(mask), group)
    y = (x - mean) * torch.rsqrt(var + 1e-5)
    (y * torch.from_numpy(c)).sum().backward()
    return {"mean": mean.detach().numpy(), "var": var.detach().numpy(),
            "n": n.detach().numpy(), "grad": x.grad.numpy()}


def rg_trainer(dropout, init=None):
    model = RegionGraphGNN(**({} if dropout else {"dropout": 0.0, "head_dropout": 0.0}))
    if init is None:
        model.reset_parameters(torch.Generator().manual_seed(0))
    else:
        model.load_state_dict({k: torch.from_numpy(v) for k, v in init.items()})
    return RGTrainer(model=model, learning_rate=RG_LR, **RG_KW)


def fusion_trainer(dropout, init=None):
    model = MultimodalCamouflageDetector(**FUSION_CFG, **({} if dropout else {"dropout": 0.0}))
    if init is None:
        model.reset_parameters(torch.Generator().manual_seed(0))
    else:
        model.load_state_dict({k: torch.from_numpy(v) for k, v in init.items()})
    return FusionTrainer(model=model, learning_rate=FUSION_LR)


def write_eval_dir(root):
    """EVAL_IMAGES seeded PNGs (smooth colour blobs, a sine texture and
    noise, with a brighter disc) and the discs as GT; the last image has no
    GT."""
    from PIL import Image

    img_dir, gt_dir = os.path.join(root, "images"), os.path.join(root, "gt")
    os.makedirs(img_dir)
    os.makedirs(gt_dir)
    rng = np.random.default_rng(9)
    yy, xx = np.mgrid[:EVAL_SIZE, :EVAL_SIZE] / EVAL_SIZE
    for i in range(EVAL_IMAGES):
        img = np.zeros((EVAL_SIZE, EVAL_SIZE, 3)) + 0.5 * rng.random(3)
        for _ in range(4):
            cy, cx, r = rng.random(3) * (1, 1, 0.2) + (0, 0, 0.05)
            img += np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * r * r))[..., None] * (
                rng.random(3) - 0.3)
        img += 0.08 * np.sin(2 * np.pi * 9 * (yy + xx))[..., None] + 0.04 * rng.standard_normal(
            img.shape)
        cy, cx = rng.uniform(0.3, 0.7, 2)
        disc = (yy - cy) ** 2 + (xx - cx) ** 2 < rng.uniform(0.01, 0.04)
        img[disc] = 0.5 * img[disc] + 0.4
        img = (np.clip(img, 0, 1) * 255).round().astype(np.uint8)
        Image.fromarray(img).save(os.path.join(img_dir, f"im{i}.png"))
        if i < EVAL_IMAGES - 1:
            Image.fromarray((disc * 255).astype(np.uint8)).save(os.path.join(gt_dir, f"im{i}.png"))
    return img_dir, gt_dir


def evaluate(img_dir, gt_dir, data_parallel):
    from camouflage_multimodal_tpu_torch.api import evaluate_directory

    return evaluate_directory(RG_CKPT, img_dir, gt_dir, n_segments=EVAL_SEGMENTS, batch_size=4,
                              threshold=EVAL_THRESHOLD, image_size=EVAL_SIZE,
                              data_parallel=data_parallel, device="cpu")


@contextlib.contextmanager
def fake_mesh(world, model_axis=1):
    """A (data, model) mesh over ``world`` ranks of torch's fake backend in
    this process (its collectives do nothing), as rank 0: enough to reach
    the checks and the cuts that run before any collective. The group is
    torn down after."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    torch.distributed.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)
    try:
        yield sharding.make_mesh("cpu", model_axis=model_axis)
    finally:
        distributed.shutdown()


# ---------------------------------------------------------------------------
# The ranks: what each task computes and writes
# ---------------------------------------------------------------------------

def _state(model):
    return {k: v.detach().numpy().copy() for k, v in model.state_dict().items()}


def task_basics(mesh, work):
    group = sharding.data_group(mesh)
    rank = torch.distributed.get_rank()
    out = {"indices": distributed.global_batch_indices(16),
           "shuffled": distributed.global_batch_indices(16, shuffle_seed=3),
           "shape": json.dumps(sharding.mesh_shape(mesh))}
    tree = {"x": torch.arange(24.0).reshape(8, 3), "flags": torch.arange(8) % 3 == 0,
            "ids": torch.arange(8, dtype=torch.int64) * 7, "scalar": torch.tensor(2.0)}
    part = sharding.shard_batch(tree, mesh)
    out["block"] = part["x"].numpy()
    back = sharding.gather_batch(part, mesh)
    out["gathered_equal"] = all(torch.equal(back[k], tree[k]) for k in tree)
    try:
        sharding.shard_batch(torch.arange(5), mesh)
        out["indivisible_raises"] = False
    except ValueError:
        out["indivisible_raises"] = True
    if torch.distributed.get_world_size() > 1:
        try:
            rg_trainer(False).fit(TinyDataset(4), epochs=1, batch_size=3, checkpoint_path=None,
                                  mesh=mesh, device="cpu", **QUIET)
            out["fit_indivisible_raises"] = False
        except ValueError as e:
            out["fit_indivisible_raises"] = "not divisible by the mesh's data axis" in str(e)
    x = torch.full((3,), rank + 1.0, requires_grad=True)
    w = torch.tensor([1.0, 2.0, 3.0]) * (rank + 1)
    (sharding.all_reduce_sum(x * x, group) * w).sum().backward()
    out["x_grad"] = x.grad.numpy()
    params = [torch.nn.Parameter(torch.zeros(3)), torch.nn.Parameter(torch.zeros(2, 2))]
    for i, p in enumerate(params):
        p.grad = torch.full(p.shape, (rank + 1.0) * (i + 1))
    sharding.all_reduce_grads_(params, group)
    out["grads_summed"] = np.concatenate([p.grad.numpy().ravel() for p in params])
    x, mask, c = bn_case()
    rows = sharding.block(4, group)
    for k, v in bn_forward(x[rows], mask[rows], c[rows], group).items():
        out[f"bn_{k}"] = v
    return out


def _released(model):
    """No module of ``model`` keeps a process group after its fit."""
    return all(getattr(m, "data_group", None) is None for m in model.modules())


def _rg_run(mesh, dropout, init=None):
    trainer = rg_trainer(dropout, init)
    model, history = trainer.fit(TinyDataset(), mesh=mesh, device="cpu", **RG_FIT, **QUIET)
    return {"history": json.dumps(history), "released": _released(model),
            **{f"param/{k}": v for k, v in _state(model).items()}}


def _fusion_run(mesh, dropout, init=None):
    ds = FusionDataset.from_samples(fusion_records(), max_rg_nodes=16, augment=dropout, **QUIET)
    model, history = fusion_trainer(dropout, init).fit(
        ds, device_resident=True, mesh=mesh, device="cpu", **FUSION_FIT, **QUIET)
    return {"history": json.dumps(history), "released": _released(model),
            **{f"param/{k}": v for k, v in _state(model).items()}}


def _load(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def task_rg(mesh, work):
    return _rg_run(mesh, True)


def task_rg_no_mesh(mesh, work):
    return _rg_run(None, True)


def task_rg_jax(mesh, work):
    return _rg_run(mesh, False, _load(os.path.join(work, "rg_init.npz")))


def task_fusion(mesh, work):
    return _fusion_run(mesh, True)


def task_fusion_no_mesh(mesh, work):
    return _fusion_run(None, True)


def task_fusion_jax(mesh, work):
    return _fusion_run(mesh, False, _load(os.path.join(work, "fusion_init.npz")))


def task_eval(mesh, work):
    from camouflage_multimodal_tpu_torch.api import load_rg_model
    from camouflage_multimodal_tpu_torch.extract import load_image_u8

    report = evaluate(os.path.join(work, "eval", "images"), os.path.join(work, "eval", "gt"),
                      True)
    files = sorted(os.listdir(os.path.join(work, "eval", "images")))[:4]
    images = torch.from_numpy(np.stack([load_image_u8(os.path.join(work, "eval", "images", f),
                                                      EVAL_SIZE) for f in files]))
    model = load_rg_model(RG_CKPT, "cpu")
    whole = RegionGraphPipeline(model, n_segments=EVAL_SEGMENTS, image_size=EVAL_SIZE)(images)
    split = RegionGraphPipeline(model, n_segments=EVAL_SEGMENTS, image_size=EVAL_SIZE,
                                mesh=mesh)(images)
    diff = max(float((whole[k].double() - split[k].double()).abs().max()) for k in whole)
    return {"report": json.dumps(report), "pipeline_max_abs_diff": diff,
            "pipeline_shape": np.array(split["heatmap"].shape)}


TASKS = {name[5:]: fn for name, fn in globals().items() if name.startswith("task_")}


def rank_main(work, names):
    """One rank: join the group from the launcher's variables, run the
    tasks in order, write ``w<world>/<task>_rank<r>.npz`` (or ``.err``),
    stop at the first failure (the other ranks would wait on a
    collective)."""
    torch.set_num_threads(1)
    distributed.initialize(backend="gloo", timeout_s=60, device="cpu")
    rank = distributed.process_index()
    out_dir = os.path.join(work, f"w{distributed.process_count()}")
    os.makedirs(out_dir, exist_ok=True)
    try:
        mesh = sharding.make_mesh("cpu")
        for name in names:
            try:
                out = TASKS[name](mesh, work)
            except Exception:
                with open(os.path.join(out_dir, f"{name}_rank{rank}.err"), "w") as f:
                    f.write(traceback.format_exc())
                raise
            np.savez(os.path.join(out_dir, f"{name}_rank{rank}.npz"), **out)
    finally:
        distributed.shutdown()


# ---------------------------------------------------------------------------
# The test side
# ---------------------------------------------------------------------------

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn(world, work, names):
    env = {k: v for k, v in os.environ.items() if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK")}
    env.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_free_port()),
               WORLD_SIZE=str(world), OMP_NUM_THREADS="1", PYTHONPATH=REPO)
    return [subprocess.Popen([sys.executable, __file__, work, *names],
                             env={**env, "RANK": str(r)}, cwd=REPO,
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(world)]


def _wait(procs):
    logs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=RANK_TIMEOUT)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            out = p.communicate()[0] + f"\n[killed after {RANK_TIMEOUT} s]"
        logs.append(out)
    return logs


def _jax():
    import jax

    jax.config.update("jax_platforms", "cpu")
    return jax


def _jax_references(work, monkeypatch):
    """The JAX package's ``fit(mesh=make_mesh())`` on the one CPU device,
    from the initial weights written for the ranks: RG on the port's graphs
    (SLIC's agreement between the packages is tested elsewhere), fusion
    with its augmentation noise zeroed (JAX's scan epochs always add it,
    from draws the port cannot repeat)."""
    jax = _jax()
    import jax.numpy as jnp

    from camouflage_multimodal_tpu.models.region_graph import RegionGraphGNN as JRG
    from camouflage_multimodal_tpu.parallel.sharding import make_mesh
    from camouflage_multimodal_tpu.train.train_fusion import (
        FusionDataset as JDataset, FusionTrainer as JFusionTrainer)
    from camouflage_multimodal_tpu.train.train_rg import RGTrainer as JRGTrainer

    port_graphs = rg_trainer(False).build_cached_dataset(TinyDataset(), batch_size=16,
                                                         device="cpu")
    jtrainer = JRGTrainer(model=JRG(dropout=0.0, head_dropout=0.0), learning_rate=RG_LR,
                          **RG_KW)
    init = jtrainer.init_state(jax.random.PRNGKey(0))
    np.savez(os.path.join(work, "rg_init.npz"), **{
        k: np.asarray(v) for k, v in region_graph_state_dict(init.params,
                                                             init.batch_stats).items()})
    jtrainer.build_cached_dataset = lambda *a, **k: {
        key: jnp.asarray(v.numpy()) for key, v in port_graphs.items()}
    _, rg_history = jtrainer.fit(TinyDataset(), mesh=make_mesh(model_axis=1), **RG_FIT, **QUIET)

    jfusion = JFusionTrainer(model_config={**FUSION_CFG, "dropout": 0.0},
                             learning_rate=FUSION_LR)
    finit = jfusion.init_state(jax.random.PRNGKey(0), rg_dim=128, n_kg=4, max_rg_nodes=16)
    np.savez(os.path.join(work, "fusion_init.npz"),
             **{k: np.asarray(v) for k, v in fusion_state_dict(finit.params).items()})
    monkeypatch.setattr(jax.random, "normal", lambda key, shape, *a, **k: jnp.zeros(shape))
    _, fusion_history = jfusion.fit(
        JDataset.from_samples(fusion_records(), max_rg_nodes=16, augment=False, **QUIET),
        mesh=make_mesh(model_axis=1), **FUSION_FIT, **QUIET)
    return {"rg": rg_history, "fusion": fusion_history}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Two ranks and one rank run every task; the test process meanwhile
    builds the JAX references and evaluates the directory alone."""
    work = str(tmp_path_factory.mktemp("parallel"))
    img_dir, gt_dir = write_eval_dir(os.path.join(work, "eval"))
    with pytest.MonkeyPatch.context() as mp:
        jax_ref = _jax_references(work, mp)
    two = _spawn(2, work, ["basics", "rg", "rg_jax", "fusion", "fusion_jax", "eval"])
    one = _spawn(1, work, ["basics", "rg", "rg_no_mesh", "fusion", "fusion_no_mesh"])
    alone = evaluate(img_dir, gt_dir, None)
    logs = {"two": _wait(two), "one": _wait(one)}

    def result(task, world, rank=0):
        path = os.path.join(work, f"w{world}", f"{task}_rank{rank}")
        if not os.path.exists(path + ".npz"):
            err = open(path + ".err").read() if os.path.exists(path + ".err") else ""
            pytest.fail(f"{task} at world {world} rank {rank} left no result:\n{err}\n"
                        + "\n".join(logs["two" if world == 2 else "one"]))
        return _load(path + ".npz")

    return {"result": result, "jax": jax_ref, "alone": alone, "work": work}


def _history(out):
    return json.loads(str(out["history"]))


def _params(out):
    return {k[6:]: v for k, v in out.items() if k.startswith("param/")}


def _assert_runs_close(got, want, lr, loose=(), steps=0):
    """Histories within rtol 1e-5 and parameters within 3·lr, but for the
    ``loose`` entries (RG's BatchNorm-fed biases and running means), held
    to 2·lr·steps, and the validation loss, which those move (1e-3)."""
    hg, hw = _history(got), _history(want)
    assert set(hg) == set(hw)
    for key in hw:
        rtol = 1e-3 if loose and key == "val_loss" else 1e-5
        np.testing.assert_allclose(hg[key], hw[key], rtol=rtol, atol=0, err_msg=key)
    pg, pw = _params(got), _params(want)
    assert set(pg) == set(pw)
    for key in pw:
        bar = 2 * lr * steps if key in loose or key.endswith("running_mean") and loose else 3 * lr
        np.testing.assert_allclose(pg[key], pw[key], rtol=0, atol=bar, err_msg=key)


def _assert_runs_equal(got, want):
    assert _history(got) == _history(want)
    pg, pw = _params(got), _params(want)
    assert set(pg) == set(pw)
    for key in pw:
        assert pg[key].tobytes() == pw[key].tobytes(), key


def test_global_batch_indices_match_jax():
    """A single process owns the whole index range, with and without the
    shuffle, in the JAX function's order (``tests/test_misc.py:146``)."""
    _jax()
    from camouflage_multimodal_tpu.parallel.distributed import global_batch_indices as j_gbi

    for seed in (None, 1, 3):
        np.testing.assert_array_equal(distributed.global_batch_indices(10, shuffle_seed=seed),
                                      j_gbi(10, shuffle_seed=seed))
    assert distributed.process_index() == 0 and distributed.process_count() == 1


def test_initialize_pins_a_card_only_for_ranks_on_cards(monkeypatch):
    """With a card visible, ranks are pinned to ``cuda:LOCAL_RANK`` (the
    rank without one) when they compute on cards — by default, NCCL or
    gloo, or with ``device="cuda"`` — and never when they compute on the
    CPU."""
    calls = []
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "set_device", lambda i: calls.append(("pin", i)))
    monkeypatch.setattr(torch.distributed, "init_process_group",
                        lambda backend, **kw: calls.append((backend, kw["rank"])))

    def joined(local_rank=None, **kw):
        calls.clear()
        if local_rank is not None:
            monkeypatch.setenv("LOCAL_RANK", str(local_rank))
        distributed.initialize("127.0.0.1:1", 2, 1, **kw)
        monkeypatch.delenv("LOCAL_RANK", raising=False)
        return list(calls)

    assert joined() == [("pin", 1), ("nccl", 1)]
    assert joined(backend="gloo") == [("pin", 1), ("gloo", 1)]
    assert joined(device="cpu") == [("gloo", 1)]
    assert joined(local_rank=0, backend="gloo", device="cuda") == [("pin", 0), ("gloo", 1)]


def test_global_batch_indices_tile_over_two_ranks(runs):
    """Two ranks' shards tile [0, n) disjointly, strided as in
    ``tests/distributed_worker.py``."""
    shards = [runs["result"]("basics", 2, r) for r in (0, 1)]
    for r, out in enumerate(shards):
        np.testing.assert_array_equal(out["indices"], np.arange(r, 16, 2))
    shuffled = np.concatenate([out["shuffled"] for out in shards])
    assert sorted(shuffled.tolist()) == list(range(16))
    np.testing.assert_array_equal(shards[1]["shuffled"],
                                  np.random.default_rng(3).permutation(16)[1::2])


def test_mesh_shapes_and_unported_axes(runs):
    """``make_mesh`` lays (data, model) over the group, at world 1 and 2,
    with no model group for a model axis of 1; anything but such a mesh is
    refused. (The model axis and spatial sharding are ported now: the
    tests below and ``tests/test_torch_port_model_axis.py`` /
    ``tests/test_torch_port_spatial.py`` hold them.)"""
    assert json.loads(str(runs["result"]("basics", 1)["shape"])) == {"data": 1, "model": 1}
    assert json.loads(str(runs["result"]("basics", 2)["shape"])) == {"data": 2, "model": 1}
    with fake_mesh(2) as mesh:
        assert sharding.model_group(mesh) is None
    with pytest.raises(TypeError, match="DeviceMesh"):
        RegionGraphPipeline(RegionGraphGNN(), mesh=object())


def test_make_mesh_lays_a_model_axis():
    """``make_mesh(model_axis=2)`` over two ranks lays (1, 2), with a model
    group of both ranks; an axis that does not divide the world raises."""
    with fake_mesh(2, model_axis=2) as mesh:
        assert sharding.mesh_shape(mesh) == {"data": 1, "model": 2}
        assert torch.distributed.get_world_size(sharding.model_group(mesh)) == 2
        assert torch.distributed.get_world_size(sharding.data_group(mesh)) == 1
        with pytest.raises(ValueError, match="does not cover"):
            sharding.make_mesh("cpu", model_axis=3)


def test_shard_fusion_params_keeps_a_ranks_heads():
    """``shard_fusion_params`` keeps rank 0's columns of wq, wk, wv and its
    biases, its rows of wo, its fc1 rows and fc2 columns; bo, fc2's bias
    and every other parameter stay whole; heads that do not divide
    raise."""
    model = MultimodalCamouflageDetector(**FUSION_CFG)
    whole = _state(model)
    with fake_mesh(2, model_axis=2) as mesh:
        sharding.shard_fusion_params(model, mesh)
        got = _state(model)
        assert sharding.fusion_model_group(model) is sharding.model_group(mesh)
        with pytest.raises(ValueError, match="heads do not divide"):
            sharding.shard_fusion_params(MultimodalCamouflageDetector(hidden_dim=48,
                                                                      num_heads=3), mesh)
        sharding.set_model_group(model, None)
    attn, ffn = "fusion.cross_attn_rg2kg.", "fusion.ffn_kg."
    np.testing.assert_array_equal(got[attn + "wq"], whole[attn + "wq"][:, :32])
    np.testing.assert_array_equal(got[attn + "bv"], whole[attn + "bv"][:32])
    np.testing.assert_array_equal(got[attn + "wo"], whole[attn + "wo"][:32])
    np.testing.assert_array_equal(got[ffn + "fc1.weight"], whole[ffn + "fc1.weight"][:64])
    np.testing.assert_array_equal(got[ffn + "fc2.weight"], whole[ffn + "fc2.weight"][:, :64])
    for key in (attn + "bo", ffn + "fc2.bias", "fusion.ln_rg.weight", "mask_head.fc1.weight"):
        np.testing.assert_array_equal(got[key], whole[key])


def test_shard_spatial_keeps_a_ranks_rows():
    """``shard_spatial`` on a (1, 2) mesh gives rank 0 the top half of
    every image's rows and the whole batch."""
    images = torch.arange(2 * 8 * 6 * 3, dtype=torch.float32).reshape(2, 8, 6, 3)
    with fake_mesh(2, model_axis=2) as mesh:
        assert torch.equal(sharding.shard_spatial(images, mesh), images[:, :4])


def test_spatial_pipeline_without_a_model_axis_is_the_plain_one():
    """``RegionGraphPipeline(spatial=True)`` builds, and without a mesh
    (nothing to split) answers as the pipeline without it, to the bit."""
    model = RegionGraphGNN()
    model.reset_parameters(torch.Generator().manual_seed(0))
    images = torch.from_numpy(TinyDataset(2).images)
    kw = dict(n_segments=16, image_size=48, max_nodes=32, slic_iters=2)
    got = RegionGraphPipeline(model, spatial=True, **kw)(images)
    want = RegionGraphPipeline(model, **kw)(images)
    for key in want:
        assert torch.equal(got[key], want[key]), key


def test_shard_and_gather_batch_over_two_ranks(runs):
    """Each rank holds a contiguous block (``P("data")``); gathering gives
    every leaf back bit for bit (float, bool, int64; a 0-d leaf stays
    whole); an axis or a fit batch that does not divide raises."""
    for r in (0, 1):
        out = runs["result"]("basics", 2, r)
        np.testing.assert_array_equal(out["block"], np.arange(24.0).reshape(8, 3)[4 * r: 4 * r + 4])
        assert out["gathered_equal"]
        assert out["indivisible_raises"]
        assert out["fit_indivisible_raises"]


def test_all_reduce_sum_gradient_over_two_ranks(runs):
    """y = Σ_r x_r² on every rank and rank r's loss Σ y·w_r: the gradient
    of the global loss, 2·x_r·Σ_r w_r, on each rank (exact in float32)."""
    w_total = np.array([1.0, 2.0, 3.0]) * 3
    for r in (0, 1):
        np.testing.assert_array_equal(runs["result"]("basics", 2, r)["x_grad"],
                                      2 * (r + 1.0) * w_total)


def test_all_reduce_grads_sums_over_two_ranks(runs):
    """The trainers' gradient all-reduce is a sum over the ranks, never
    DDP's mean (each rank's loss is its share of the global loss), for
    every parameter of the flat buffer (exact in float32)."""
    want = np.array([3.0] * 3 + [6.0] * 4)
    for r in (0, 1):
        np.testing.assert_array_equal(runs["result"]("basics", 2, r)["grads_summed"], want)
    np.testing.assert_array_equal(runs["result"]("basics", 1)["grads_summed"], want / 3)


def test_masked_batch_stats_over_two_ranks(runs):
    """BatchNorm statistics over two ranks with uneven valid counts (8 and
    5 nodes) equal one rank's over the whole batch, and so does the
    gradient of the normalised output, at 1e-6."""
    x, mask, c = bn_case()
    whole = bn_forward(x, mask, c)
    for r in (0, 1):
        out = runs["result"]("basics", 2, r)
        for key in ("mean", "var", "n"):
            np.testing.assert_allclose(out[f"bn_{key}"], whole[key], rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(out["bn_grad"], whole["grad"][2 * r: 2 * r + 2],
                                   rtol=1e-6, atol=1e-6)


# The biases ahead of a BatchNorm have an exact gradient of zero in train
# mode: each run's float32 rounding leaves ~1e-9 there, which Adam turns
# into steps of up to about lr in unrelated directions (ROADMAP Queue C
# item 6). They and the running means that follow them are held to
# 2·lr·steps, as in tests/test_torch_port_train_rg.py; in eval mode they
# shift the logits, so the validation loss is held to 1e-3.
RG_GRADIENT_FREE = ("conv1.bias", "convs.0.bias", "convs.1.bias", "convs.2.bias")
RG_STEPS = 4                 # 12 train samples: one batch of 8 and the tail window, 2 epochs


def test_rg_fit_two_ranks_match_one_rank(runs):
    """RG training with dropout on: two ranks against a world of one —
    train losses and both accuracies rtol 1e-5, parameters and running
    variances 3·lr (the BatchNorm-fed biases, the running means and the
    validation loss as above) — and both ranks end with the same model."""
    two = [runs["result"]("rg", 2, r) for r in (0, 1)]
    _assert_runs_equal(two[1], two[0])
    _assert_runs_close(two[0], runs["result"]("rg", 1), RG_LR, RG_GRADIENT_FREE, RG_STEPS)


def test_rg_fit_world_one_equals_no_mesh(runs):
    """A world-1 mesh changes no bit of an RG fit with dropout on."""
    _assert_runs_equal(runs["result"]("rg", 1), runs["result"]("rg_no_mesh", 1))


def test_rg_fit_two_ranks_match_jax_mesh(runs):
    """The port at world 2 against the JAX ``RGTrainer.fit(mesh=)`` from the
    same weights at dropout 0: train losses rtol 1e-4 (what the JAX mesh
    test holds), validation losses 1e-3 (moved by the BatchNorm-fed
    biases, as above)."""
    got = _history(runs["result"]("rg_jax", 2))
    for key, rtol in (("train_loss", 1e-4), ("val_loss", 1e-3)):
        np.testing.assert_allclose(got[key], runs["jax"]["rg"][key], rtol=rtol, err_msg=key)


def test_fits_release_the_data_group(runs):
    """A fit over a mesh leaves no module of the returned model holding the
    process group, which its caller may tear down."""
    for task in ("rg", "fusion"):
        for world, ranks in ((1, (0,)), (2, (0, 1))):
            for r in ranks:
                assert bool(runs["result"](task, world, r)["released"]), (task, world, r)


def test_fusion_fit_two_ranks_match_one_rank(runs):
    """Fusion training with dropout and on-device augmentation: two ranks
    against a world of one — histories rtol 1e-5, parameters 3·lr — and
    both ranks end with the same model."""
    two = [runs["result"]("fusion", 2, r) for r in (0, 1)]
    _assert_runs_equal(two[1], two[0])
    _assert_runs_close(two[0], runs["result"]("fusion", 1), FUSION_LR)


def test_fusion_fit_world_one_equals_no_mesh(runs):
    """A world-1 mesh changes no bit of a fusion fit with dropout and
    augmentation on."""
    _assert_runs_equal(runs["result"]("fusion", 1), runs["result"]("fusion_no_mesh", 1))


def test_fusion_fit_two_ranks_match_jax_mesh(runs):
    """The port at world 2 against the JAX ``FusionTrainer.fit(mesh=)``
    (its scan epochs) from the same weights at dropout 0 without
    augmentation noise: loss histories rtol 1e-4."""
    got = _history(runs["result"]("fusion_jax", 2))
    for key in ("train_loss", "val_loss"):
        np.testing.assert_allclose(got[key], runs["jax"]["fusion"][key], rtol=1e-4, err_msg=key)


def test_evaluate_directory_over_two_ranks(runs):
    """``evaluate_directory(data_parallel=True)`` on two ranks (rank 1's
    block of the last batch is empty) returns on each rank the report of
    one process, at 1e-6."""
    for r in (0, 1):
        report = json.loads(str(runs["result"]("eval", 2, r)["report"]))
        assert set(report) == set(runs["alone"])
        for key, want in runs["alone"].items():
            assert report[key] == pytest.approx(want, abs=1e-6), key


def test_region_graph_pipeline_mesh_over_two_ranks(runs):
    """``RegionGraphPipeline(mesh=)`` returns the whole batch on each rank,
    equal to the pipeline without a mesh within 1e-6."""
    for r in (0, 1):
        out = runs["result"]("eval", 2, r)
        assert out["pipeline_shape"].tolist() == [4, EVAL_SIZE, EVAL_SIZE]
        assert float(out["pipeline_max_abs_diff"]) <= 1e-6


if __name__ == "__main__":
    rank_main(sys.argv[1], sys.argv[2:])
