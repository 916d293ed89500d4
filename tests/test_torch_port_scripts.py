"""The port's counterparts of the JAX system's last runnable entry points
against the JAX code, on the CPU: checkpoint migration, the serve latency
A/B, the connectivity profile, and the graft entry with its multichip dry
run.

The JAX scripts run their work at module level against COD10K (absent
here), except ``scripts/migrate_checkpoints.py``, whose ``migrate`` is
imported by path. The others are held through the JAX functions they call:
the connectivity profile's sweep counter is copied from its script, and
``__graft_entry__.entry`` gives the weights, images and KG matrix that the
port's entry step is fed.

Bars: migration leaves equal leaves under both packages' readers; served
heatmaps and scores within 1e-5 of ``predict_batch`` on the image alone;
connectivity labels and per-image sweep counts equal to the JAX ones; the
entry step by ``_compare_slice`` of ``tests/test_torch_port_pipeline.py``
(segments ≥ 99 % equal, heatmap MAE ≤ 1e-2, and on images with identical
segment maps the outputs at 1e-4 and the attention maps at 1e-3 / 2e-3);
the dry run's fusion loss, on every rank and in one process, within 1e-5
of the JAX dry run's step at dropout 0 on the same weights and batch.
"""

import importlib
import importlib.util
import json
import os
import pickle
import shutil
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

jax.config.update("jax_platforms", "cpu")

from test_torch_port_pipeline import _compare_slice, few_threads  # noqa: E402,F401

from camouflage_multimodal_tpu.core import checkpoint as J_ckpt  # noqa: E402
from camouflage_multimodal_tpu import pipeline as J_pipeline  # noqa: E402
from camouflage_multimodal_tpu_torch import graft_entry  # noqa: E402
from camouflage_multimodal_tpu_torch.api import MultimodalPredictor  # noqa: E402
from camouflage_multimodal_tpu_torch.bench import load_images  # noqa: E402
from camouflage_multimodal_tpu_torch.convert import (  # noqa: E402
    fusion_params_from_state_dict, fusion_state_dict, region_graph_state_dict)
from camouflage_multimodal_tpu_torch.core import checkpoint as T_ckpt  # noqa: E402
from camouflage_multimodal_tpu_torch.ops.connectivity import (  # noqa: E402
    connected_components, enforce_label_connectivity)
from camouflage_multimodal_tpu_torch.parallel.distributed import run_ranks  # noqa: E402
from camouflage_multimodal_tpu_torch.pipeline import padded_nodes  # noqa: E402
from camouflage_multimodal_tpu_torch.scripts import (  # noqa: E402
    migrate_checkpoints, profile_connectivity, serve_latency_ab)

pytestmark = pytest.mark.usefixtures("few_threads")

J_conn = importlib.import_module("camouflage_multimodal_tpu.ops.connectivity")
T_slic = importlib.import_module("camouflage_multimodal_tpu_torch.ops.slic")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARTIFACTS = serve_latency_ab.ARTIFACTS
SERVED_BAR = 1e-5


def _by_path(name, path):
    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, path))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


# ---------------------------------------------------------------------------
# Checkpoint migration
# ---------------------------------------------------------------------------

class _RunsCode:
    """Unpickles into a call of ``os.system``: what the port refuses."""

    def __reduce__(self):
        return os.system, ("true",)


def _legacy_payload():
    """Nested dicts, lists and tuples of numpy arrays of several dtypes and
    layouts and of Python and numpy scalars and strings."""
    rng = np.random.default_rng(12)
    return {
        "epoch": 3,
        "params": {"conv1": {"kernel": rng.standard_normal((15, 128)).astype(np.float32),
                             "bias": np.zeros(128, np.float32)},
                   "layers": [rng.standard_normal((4, 4)),
                              np.asfortranarray(rng.standard_normal((3, 5)).astype(np.float32))]},
        "batch_stats": ({"mean": rng.standard_normal(8).astype(np.float32)[::2],
                         "count": np.array(7, np.int64)},),
        "config": {"hidden_dim": 256, "dropout": 0.3, "name": "fusion", "flag": True,
                   "heads": (8, 4)},
        "metrics": {"val_loss": np.float64(0.25), "step": np.int32(12), "nan": float("nan")},
        "labels": np.array([0, 1, 1], np.uint8),
    }


def _leaves(tree):
    return dict(migrate_checkpoints._leaves(tree))


def _assert_same_leaves(got, want, what):
    assert set(got) == set(want), what
    for p, w in want.items():
        a, b = np.asarray(got[p]), np.asarray(w)
        if b.dtype.kind in "OUS":
            assert str(a) == str(b), (what, p)
        else:
            np.testing.assert_array_equal(a, b, err_msg=f"{what} {p}")


@pytest.mark.parametrize("protocol", [2, 4, 5])
def test_migrate_like_the_jax_script(tmp_path, protocol):
    """A legacy pickle, copied twice, migrated once by the JAX script's
    ``migrate`` and once by the port's: both files are npz and read back
    by both packages' loaders with the pickle's leaves."""
    j_script = _by_path("jax_migrate_checkpoints", "scripts/migrate_checkpoints.py")
    payload = _legacy_payload()
    src = tmp_path / "legacy.ckpt"
    with open(src, "wb") as f:
        pickle.dump(payload, f, protocol=protocol)
    j_path, t_path = str(tmp_path / "jax.ckpt"), str(tmp_path / "port.ckpt")
    shutil.copy(src, j_path)
    shutil.copy(src, t_path)
    assert j_script.migrate(j_path) is True
    assert migrate_checkpoints.migrate(t_path) is True
    want = _leaves(payload)
    for path in (j_path, t_path):
        assert T_ckpt.checkpoint_format(path) == J_ckpt.checkpoint_format(path) == "npz"
        _assert_same_leaves(_leaves(T_ckpt.load_checkpoint(path)), want, f"port reads {path}")
        _assert_same_leaves(_leaves(J_ckpt.load_checkpoint(path)), want, f"JAX reads {path}")
    assert migrate_checkpoints.migrate(t_path) is False        # already npz
    assert j_script.migrate(t_path) is False


def test_migrate_main_skips_npz_and_reports_refused(tmp_path, capsys):
    """``main`` over a directory with one legacy pickle, one npz file and
    one pickle naming ``os.system``: 1 migrated, 1 skipped, 1 refused and
    left byte-identical, exit code 1; no ``.new`` file left behind."""
    root = tmp_path / "ckpts"
    (root / "sub").mkdir(parents=True)
    with open(root / "old.ckpt", "wb") as f:
        pickle.dump(_legacy_payload(), f, protocol=4)
    T_ckpt.save_checkpoint(str(root / "sub" / "new.ckpt"), {"epoch": 1})
    with open(root / "sub" / "bad.ckpt", "wb") as f:
        pickle.dump({"params": {}, "hook": _RunsCode()}, f)
    bad = (root / "sub" / "bad.ckpt").read_bytes()
    npz = (root / "sub" / "new.ckpt").read_bytes()

    assert migrate_checkpoints.main([str(root)]) == 1
    out = capsys.readouterr().out.splitlines()
    assert f"migrated {root / 'old.ckpt'}" in out
    assert f"already npz {root / 'sub' / 'new.ckpt'}" in out
    refused = [ln for ln in out if ln.startswith(f"refused {root / 'sub' / 'bad.ckpt'}: ")]
    assert len(refused) == 1 and ".system, which this reader does not build" in refused[0]
    assert "1 checkpoint(s) migrated" in out
    assert (root / "sub" / "bad.ckpt").read_bytes() == bad
    assert (root / "sub" / "new.ckpt").read_bytes() == npz
    _assert_same_leaves(_leaves(T_ckpt.load_checkpoint(str(root / "old.ckpt"))),
                        _leaves(_legacy_payload()), "migrated file")
    assert sorted(p.name for p in root.rglob("*")) == ["bad.ckpt", "new.ckpt", "old.ckpt", "sub"]


# ---------------------------------------------------------------------------
# Serve latency A/B
# ---------------------------------------------------------------------------

def test_serve_latency_ab_against_predict_batch():
    """Both modes at 64², batch 2, 4 sequential requests on the committed
    artifacts: the JAX record's keys under each mode, its buckets, full
    occupancy, the forwards each mode ran, and every served heatmap and
    score within 1e-5 of ``predict_batch`` on that image alone."""
    with open(os.path.join(REPO, "artifacts/serve_latency_ab.json")) as f:
        record = json.load(f)
    pred = MultimodalPredictor(*ARTIFACTS, device="cpu")
    out, responses, images = serve_latency_ab.run(size=64, batch=2, n_requests=4,
                                                  device="cpu", predictor=pred)
    assert set(record) <= set(out) and out["device_name"] == "cpu"
    assert (out["image_size"], out["batch_size"], out["n_sequential_requests"]) == (64, 2, 4)
    for mode, buckets in (("bucketed", [1, 2]), ("fixed_batch", [2])):
        got = out["modes"][mode]
        assert set(record["modes"][mode]) <= set(got), mode
        assert got["buckets"] == buckets
        assert got["mean_batch_occupancy"] == 1.0
        assert got["forwards"] == len(buckets) + 1 + 4      # warm-up, first submit, requests
        assert 0 < got["p50_ms"] <= got["p95_ms"]
    alone = [pred.predict_batch(images[i:i + 1]) for i in range(len(images))]
    for mode, served in responses.items():
        assert len(served) == 4
        for i, res in enumerate(served):
            want = alone[i % len(images)]
            for key in ("heatmap", "score"):
                np.testing.assert_allclose(res[key], want[key][0], rtol=0, atol=SERVED_BAR,
                                           err_msg=f"{mode} request {i} {key}")


def test_serve_latency_ab_main_writes_out(tmp_path, monkeypatch, capsys):
    """The command line: the JAX knobs from the environment, ``--out``
    holding the printed record."""
    monkeypatch.setenv("SERVE_IMAGE_SIZE", "32")
    monkeypatch.setenv("SERVE_BATCH", "2")
    path = str(tmp_path / "ab.json")
    out = serve_latency_ab.main(["--device", "cpu", "--n-requests", "2", "--out", path])
    with open(path) as f:
        assert json.load(f) == json.loads(json.dumps(out))
    assert json.loads(capsys.readouterr().out) == json.loads(json.dumps(out))
    assert (out["image_size"], out["batch_size"]) == (32, 2)


# ---------------------------------------------------------------------------
# Connectivity profile
# ---------------------------------------------------------------------------

def _jax_cc_sweeps(labels):
    """The JAX script's instrumented copy of the ``connected_components``
    fixed-point loop (``scripts/profile_connectivity.py:77-92``)."""
    hh, ww = labels.shape
    idx = jnp.arange(hh * ww, dtype=jnp.int32).reshape(hh, ww)
    s_cols = J_conn._run_ids(labels, 1)
    s_rows = J_conn._run_ids(labels, 0)

    def body(st):
        comp, _, n = st
        new = J_conn._seg_min_scan(comp, labels, axis=1, run_ids=s_cols)
        new = J_conn._seg_min_scan(new, labels, axis=0, run_ids=s_rows)
        return new, jnp.array_equal(new, comp), n + 1

    _, _, n = jax.lax.while_loop(lambda st: ~st[1], body,
                                 (idx, jnp.asarray(False), jnp.int32(0)))
    return n


def test_profile_connectivity_against_jax(capsys, monkeypatch):
    """4 × 64², 16 segments, the bench's seeded images: the profile's
    per-image sweep counts equal the JAX loop's on the same raw labels;
    ``connected_components`` and the full pass equal the JAX functions'
    labels; the JAX script's three lines are printed."""
    B, H, N = 4, 64, 16
    monkeypatch.setattr(profile_connectivity, "ITERS", 2)
    out = profile_connectivity.profile(batch=B, image_size=H, n_segments=N, device="cpu")
    printed = capsys.readouterr().out
    for name in ("connected_components", "enforce_label_connectivity", "merge+relabel (diff)"):
        assert any(ln.startswith(name) and ln.endswith("ms/img") for ln in printed.splitlines())
    assert "CC sweeps per image:" in printed

    imgs = torch.from_numpy(load_images([], B, H))
    raw = T_slic.slic(imgs, n_segments=N, backend="exact", enforce_connectivity=False)
    raw_j = jnp.asarray(raw.numpy().astype(np.int32))
    want_sweeps = np.asarray(jax.jit(jax.vmap(_jax_cc_sweeps))(raw_j))
    assert out["cc_sweeps_per_image"] == [int(s) for s in want_sweeps]
    assert max(want_sweeps) > min(want_sweeps)          # images converge at their own pace
    np.testing.assert_array_equal(connected_components(raw).numpy(),
                                  np.asarray(jax.vmap(J_conn.connected_components)(raw_j)))
    K = padded_nodes(N, H)
    assert out["_config"]["max_labels"] == K == J_pipeline.padded_nodes(N, H)
    want_full = jax.vmap(lambda l: J_conn.enforce_label_connectivity(l, N, max_labels=K))(raw_j)
    np.testing.assert_array_equal(enforce_label_connectivity(raw, N, max_labels=K).numpy(),
                                  np.asarray(want_full))
    assert out["merge_relabel_ms"] == pytest.approx(out["full_ms"] - out["cc_ms"], abs=1e-3)
    assert out["device"] == "not measured"


# ---------------------------------------------------------------------------
# Graft entry and multichip dry run
# ---------------------------------------------------------------------------

def test_entry_against_jax_entry():
    """JAX ``entry()``'s seeded variables carried into the port's entry
    models, its images and KG matrix fed to both pipelines: the slice's
    bars; the port's step returns the pipeline's three outputs."""
    J_entry = _by_path("jax_graft_entry", "__graft_entry__.py")
    _, (rg_vars, fusion_vars, images, kg) = J_entry.entry()
    j_rg, j_fusion = J_entry._models()
    j_pipe = J_pipeline.MultimodalPipeline(J_pipeline.RegionGraphPipeline(
        j_rg, n_segments=128, image_size=128, max_nodes=256, slic_iters=4), j_fusion)
    want = jax.tree_util.tree_map(np.asarray, j_pipe(rg_vars, fusion_vars, images, kg))

    fn, (rg_model, fusion_model, t_images, t_kg) = graft_entry.entry("cpu")
    assert t_images.shape == images.shape and t_kg.shape == kg.shape
    rg_model.load_state_dict(region_graph_state_dict(rg_vars["params"],
                                                     rg_vars["batch_stats"]))
    fusion_model.load_state_dict(fusion_state_dict(fusion_vars["params"]))
    x, k = torch.from_numpy(np.array(images)), torch.from_numpy(np.array(kg))
    out = graft_entry.entry_pipeline(rg_model, fusion_model)(x, k)
    got = {key: ({a: b.numpy() for a, b in v.items()} if isinstance(v, dict) else v.numpy())
           for key, v in out.items()}
    _compare_slice(want, got)
    mask_logits, score, heatmap = fn(rg_model, fusion_model, x, k)
    np.testing.assert_array_equal(mask_logits.numpy(), got["mask_logits"])
    np.testing.assert_array_equal(score.numpy(), got["score"])
    np.testing.assert_array_equal(heatmap.numpy(), got["heatmap"])


def test_entry_seeded_outputs_finite():
    """The port's own seeded example: finite outputs of the JAX shapes."""
    fn, args = graft_entry.entry("cpu")
    mask_logits, score, heatmap = fn(*args)
    assert mask_logits.shape == (2, 2) and score.shape == (2, 1)
    assert heatmap.shape == (2, 128, 128)
    assert all(torch.isfinite(t).all() for t in (mask_logits, score, heatmap))


DRY_LOSS_BAR = 1e-5


@pytest.fixture(scope="module")
def jax_dry_loss():
    """The JAX dry run's fusion step (``__graft_entry__.py:119-145``) at
    dropout 0, on the port's seed-0 fusion weights carried over by
    ``convert.fusion_params_from_state_dict`` and on the JAX recipe's
    ``default_rng(0)`` batch at data axis 2 (K = 64, 13 KG rows): its loss.
    The batch is checked equal to the port's ``dry_batch``."""
    from camouflage_multimodal_tpu.models.fusion import MultimodalCamouflageDetector as JDet
    from camouflage_multimodal_tpu.train.train_fusion import FusionTrainer as JTrainer

    B, K, NKG = 2 * 2, 64, 13
    rng = np.random.default_rng(0)
    batch = {
        "rg": rng.standard_normal((B, K, 128)).astype(np.float32),
        "rg_mask": np.ones((B, K), bool),
        "kg": rng.standard_normal((B, NKG, 128)).astype(np.float32),
        "y": rng.integers(0, 2, B),
        "edge": rng.integers(0, 2, B).astype(np.float32),
        "score": rng.random(B).astype(np.float32),
    }
    port_batch, _ = graft_entry.dry_batch(2)
    assert port_batch.keys() == batch.keys()
    for key, want in batch.items():
        np.testing.assert_array_equal(port_batch[key], want, err_msg=key)

    seeded = graft_entry.dry_fusion_model()
    params = jax.tree_util.tree_map(jnp.asarray,
                                    fusion_params_from_state_dict(seeded.state_dict()))
    trainer = JTrainer(model=JDet(dropout=0.0))
    state = trainer.init_state(jax.random.PRNGKey(0), rg_dim=128, n_kg=NKG, max_rg_nodes=K)
    state = state.replace(params=params, opt_state=trainer.tx.init(params))
    _, loss, _ = trainer._train_step(state, {k: jnp.asarray(v) for k, v in batch.items()},
                                     jnp.asarray(1e-3, jnp.float32), jax.random.PRNGKey(1),
                                     jnp.asarray(0.75, jnp.float32))
    return float(loss)


def test_fusion_step_against_jax(jax_dry_loss):
    """One process's dry-run step: the JAX step's loss within 1e-5."""
    alone = graft_entry.fusion_step(2, None, "cpu")
    assert abs(alone - jax_dry_loss) <= DRY_LOSS_BAR, (alone, jax_dry_loss)


@pytest.mark.parametrize("n_devices,mesh", [(2, (2, 1)), (4, (2, 2))])
def test_dryrun_multichip_cpu_ranks(n_devices, mesh, capsys, jax_dry_loss):
    """Gloo ranks on the CPU: rank 0's ``ok`` line with the JAX dry run's
    mesh and heatmap shape; every rank's fusion loss within 1e-5 of the JAX
    dry run's step at dropout 0 on the same weights and batch; the spatial
    variant only at model 2."""
    res = graft_entry.dryrun_multichip(n_devices, device="cpu")
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("dryrun_multichip ok")]
    assert len(lines) == 1
    assert f"mesh=({mesh[0]},{mesh[1]})" in lines[0]
    assert "heatmap_shape=(2, 32, 32)" in lines[0]
    assert tuple(res["mesh"]) == mesh and len(res["ranks"]) == n_devices
    for rank in res["ranks"]:
        assert abs(rank["fusion_loss"] - jax_dry_loss) <= DRY_LOSS_BAR, (rank, jax_dry_loss)
        assert rank["backend"] == "gloo" and rank["data_parallel"]["finite"]
        assert ("spatial" in rank) == (mesh[1] > 1)


def test_run_ranks_reports_and_kills(tmp_path):
    """``run_ranks``: each rank's output in order; a rank that exits
    non-zero raises with its log's tail; a rank past the time limit is
    killed with the others and raises."""
    env = dict(os.environ)
    ok = [[sys.executable, "-c", f"print('rank {r}')"] for r in range(2)]
    assert run_ranks(ok, [env] * 2, 60) == ["rank 0\n", "rank 1\n"]
    bad = ok[:1] + [[sys.executable, "-c", "import sys; print('boom'); sys.exit(3)"]]
    with pytest.raises(RuntimeError, match=r"(?s)rank 1 \(exit 3\).*boom"):
        run_ranks(bad, [env] * 2, 60)
    marker = tmp_path / "late"
    slow = [[sys.executable, "-c", f"import time; time.sleep(30); open({str(marker)!r}, 'w')"]
            ] * 2
    with pytest.raises(RuntimeError, match=r"killed after 1 s"):
        run_ranks(slow, [env] * 2, 1)
    assert not marker.exists()
