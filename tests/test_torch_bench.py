"""The port's bench, bench sweep, stage profile and host ceiling on the CPU.

The bench line carries every key of the JAX bench's line
(``BENCH_r05.json``'s ``parsed``); its fallback images are the JAX bench's
to the bit; one bench batch on the JAX bench's flax-initialised weights,
carried over by ``convert.py``, matches the JAX ``MultimodalPipeline`` at
the slice's bars (segments ≥ 99 % equal, heatmap MAE ≤ 1e-2) and the
fusion outputs within 1e-4; the sweep's rows are the JAX sweep's; the
stage profile names the JAX stages; the draft decode matches the JAX
package's native loader to the bit where both take the same libjpeg scale,
and within a mean of 2 levels (of 255) where the native loader takes an
M/8 scale that PIL's ``Image.draft`` (1/2, 1/4, 1/8) does not offer.
Everything runs at 64², batch 2, 16 segments.
"""

import ast
import importlib.util
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

jax.config.update("jax_platforms", "cpu")

from camouflage_multimodal_tpu import native  # noqa: E402
from camouflage_multimodal_tpu import pipeline as J_pipeline  # noqa: E402
from camouflage_multimodal_tpu.models.fusion import (  # noqa: E402
    MultimodalCamouflageDetector as JDetector)
from camouflage_multimodal_tpu.models.region_graph import RegionGraphGNN as JGNN  # noqa: E402
from camouflage_multimodal_tpu_torch import bench as T_bench  # noqa: E402
from camouflage_multimodal_tpu_torch.convert import (  # noqa: E402
    fusion_state_dict, region_graph_state_dict)
from camouflage_multimodal_tpu_torch.core.profiling import busy_us  # noqa: E402
from camouflage_multimodal_tpu_torch.data.cod10k import load_image_u8  # noqa: E402
from camouflage_multimodal_tpu_torch.scripts import bench_sweep, host_ceiling  # noqa: E402
from camouflage_multimodal_tpu_torch.scripts import profile_stages  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE, BATCH, SEGMENTS = 64, 2, 16
TINY_ENV = {"BENCH_IMAGE_SIZE": str(SIZE), "BENCH_BATCH": str(BATCH),
            "BENCH_N_SEGMENTS": str(SEGMENTS), "BENCH_ITERS": "2",
            "BENCH_E2E_ITERS": "2", "BENCH_E2E_PASSES": "1"}
E2E_KEYS = {"e2e_median_imgs_per_sec", "e2e_median_vs_baseline",
            "draft_decode_imgs_per_sec", "draft_decode_vs_baseline"}
OUT_TOL = dict(rtol=1e-4, atol=1e-4)
DRAFT_MEAN_LEVELS = 2.0


def bench_keys():
    with open(os.path.join(REPO, "BENCH_r05.json")) as f:
        return set(json.load(f)["parsed"])


def jax_script_tree(name):
    with open(os.path.join(REPO, "scripts", name)) as f:
        return ast.parse(f.read())


def dict_keys_assigned(tree, target):
    """The string keys of the dict literal assigned to ``target``."""
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
                and any(isinstance(t, ast.Name) and t.id == target for t in node.targets)):
            return [k.value for k in node.value.keys]
    raise AssertionError(f"no dict assigned to {target}")


def seeded_image(seed, width, height):
    """A smooth seeded RGB scene (blobs and a sine texture) at width × height."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:height, 0:width] / max(width, height)
    img = np.zeros((height, width, 3)) + 0.5 * rng.random(3)
    for _ in range(6):
        cy, cx = rng.random(2)
        r = 0.05 + 0.2 * rng.random()
        blob = np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * r * r))
        img += blob[..., None] * (rng.random(3) - 0.3)
    f = rng.uniform(4, 20, 2)
    img += 0.08 * np.sin(2 * np.pi * (f[0] * yy + f[1] * xx))[..., None] * rng.random(3)
    img += 0.04 * rng.standard_normal(img.shape)
    return (np.clip(img, 0, 1) * 255).round().astype(np.uint8)


def write_jpegs(directory, n, width, height, seed=0):
    from PIL import Image

    os.makedirs(directory, exist_ok=True)
    paths = []
    for i in range(n):
        path = os.path.join(directory, f"img_{i:02d}.jpg")
        Image.fromarray(seeded_image(seed + i, width, height)).save(path, quality=90)
        paths.append(path)
    return paths


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two intra-op threads while this module runs: the suite runs a file
    per worker, and 8 threads in each of 6 workers on 8 cores wait on each
    other (tests/test_torch_port_pipeline.py's fixture); the bench's decode
    and upload workers share the same cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def jpeg_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("jpegs"))
    write_jpegs(d, 3, 400, 300)
    return d


@pytest.mark.parametrize("with_images", [True, False, None])
def test_bench_line_has_every_jax_key(with_images, jpeg_dir, tmp_path, monkeypatch, capsys):
    """``--device cpu`` at 64², batch 2, 16 segments, 2 iterations: with a
    directory of seeded JPEGs every key of the JAX bench's line; with an
    empty directory (False), and with no ``--image-dir`` (None: the bench
    then reads no file), the end-to-end keys are left out and ``value`` is
    the device-only rate."""
    for key, value in TINY_ENV.items():
        monkeypatch.setenv(key, value)
    argv = ["--device", "cpu"]
    if with_images is None:
        monkeypatch.setattr(T_bench, "load_image_rgb", None)     # no file is read
    else:
        argv += ["--image-dir", jpeg_dir if with_images else str(tmp_path)]
    result = T_bench.main(argv)
    printed = [ln for ln in capsys.readouterr().out.splitlines() if ln.strip()]
    assert len(printed) == 1 and json.loads(printed[0]) == result
    want = bench_keys() if with_images else bench_keys() - E2E_KEYS
    assert want <= set(result)
    assert result["backend"] == "cpu" and result["device_name"] == "cpu"
    assert result["batch"] == BATCH and f"{SIZE}x{SIZE}" in result["metric"]
    assert all(v == 0 for v in result["kernel_launches"].values())   # plain versions
    # device only: 1 + 5 warm-up + 2; batch 1: 5 + 2; per e2e pass 1 + 2
    assert result["forwards"] == 8 + 7 + (6 if with_images else 0)
    if with_images:
        assert "host decode" in result["metric"]
        assert result["value"] > 0 and result["draft_decode_imgs_per_sec"] > 0
    else:
        assert not E2E_KEYS & set(result)
        assert result["value"] == result["device_only_imgs_per_sec"]


def test_bench_device_cuda_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the bench runs there")
    with pytest.raises(RuntimeError, match="cuda"):
        T_bench.run(T_bench.BenchConfig(batch=BATCH, image_size=SIZE), device="cuda",
                    image_dir=None)


def test_fallback_images_equal_jax_bench():
    """The device-only images without files: the JAX bench's
    ``_load_images`` fallback, bit for bit."""
    spec = importlib.util.spec_from_file_location("jax_bench", os.path.join(REPO, "bench.py"))
    jax_bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_bench)
    jax_bench.IMAGE_SIZE = SIZE
    jax_bench._image_paths = lambda n: []
    want = jax_bench._load_images(2 * BATCH)
    got = T_bench.load_images(T_bench.image_paths(None, 2 * BATCH), 2 * BATCH, SIZE)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_bench_env_knobs_and_defaults():
    assert T_bench.BenchConfig.from_env({}) == T_bench.BenchConfig(
        batch=16, iters=30, e2e_iters=8, e2e_passes=4, image_size=352, n_segments=500,
        window_radius=3)
    assert T_bench.BenchConfig.from_env(TINY_ENV) == T_bench.BenchConfig(
        batch=2, iters=2, e2e_iters=2, e2e_passes=1, image_size=64, n_segments=16)


def test_bench_batch_matches_jax_pipeline():
    """One bench batch (the seeded fallback images) through both
    ``MultimodalPipeline``s, the JAX bench's flax initialisation
    (``bench.py:88-101``) carried into the port's bench models."""
    raw = T_bench.fallback_images(2 * BATCH, SIZE)[:BATCH]
    rng = jax.random.PRNGKey(0)
    rg_model, fusion_model = JGNN(), JDetector()
    K = J_pipeline.padded_nodes(SEGMENTS, SIZE)
    rg_vars = rg_model.init(rng, jnp.zeros((1, K, 15)), jnp.zeros((1, K, K), bool),
                            jnp.zeros((1, K, K)), jnp.ones((1, K), bool))
    fusion_vars = fusion_model.init(rng, jnp.zeros((1, K, 128)), jnp.zeros((1, 13, 128)))
    kg = np.array(jax.random.normal(rng, (13, 128)))
    jpipe = J_pipeline.MultimodalPipeline(
        J_pipeline.RegionGraphPipeline(rg_model, n_segments=SEGMENTS, image_size=SIZE,
                                       max_nodes=K, window_radius=3), fusion_model)
    want = {k: np.asarray(v) for k, v in
            jpipe(rg_vars, fusion_vars, jnp.asarray(raw), jnp.asarray(kg)).items()
            if v is not None}

    cfg = T_bench.BenchConfig(batch=BATCH, image_size=SIZE, n_segments=SEGMENTS)
    pipe, _ = T_bench.build_models(cfg, torch.device("cpu"))
    assert pipe.rg.max_nodes == K and pipe.fusion_model.fusion.cross_attn_rg2kg.use_pallas
    pipe.rg.model.load_state_dict(region_graph_state_dict(rg_vars["params"],
                                                          rg_vars["batch_stats"]))
    pipe.fusion_model.load_state_dict(fusion_state_dict(fusion_vars["params"]))
    out = pipe(torch.from_numpy(raw), torch.from_numpy(kg))
    got = {k: v.numpy() for k, v in out.items() if isinstance(v, torch.Tensor)}

    assert (got["segments"] == want["segments"]).mean() >= 0.99
    assert np.abs(got["heatmap"] - want["heatmap"]).mean() <= 1e-2
    for key in ("mask_logits", "instance_logits", "edge_logits", "score",
                "mask_prob", "instance_prob", "edge_prob"):
        np.testing.assert_allclose(got[key], want[key], **OUT_TOL, err_msg=key)


def test_sweep_rows_are_the_jax_sweep_rows():
    tree = jax_script_tree("bench_sweep.py")
    rows = next(ast.literal_eval(n.value) for n in ast.walk(tree)
                if isinstance(n, ast.Assign)
                and any(isinstance(t, ast.Name) and t.id == "ROWS" for t in n.targets))
    assert bench_sweep.ROWS == rows


def test_sweep_row_in_a_subprocess(tmp_path):
    """One tiny row through a fresh process of the bench: the JAX sweep's
    row keys, no end-to-end fields without files."""
    env = dict(os.environ, **TINY_ENV, OMP_NUM_THREADS="2")
    line = bench_sweep.bench_line(SIZE, BATCH, device="cpu", image_dir=str(tmp_path),
                                  env=env, timeout=300)
    row = bench_sweep.row_of(SIZE, BATCH, line)
    assert list(row) == dict_keys_assigned(jax_script_tree("bench_sweep.py"), "row")
    assert row["image_size"] == SIZE and row["batch"] == BATCH
    assert row["e2e_imgs_per_sec"] == row["device_only_imgs_per_sec"] > 0
    assert row["draft_decode_imgs_per_sec"] is None and line["backend"] == "cpu"


def test_profile_stages_reports_every_jax_stage():
    out = profile_stages.profile(SIZE, BATCH, SEGMENTS, iters=1, device="cpu")
    jax_stages = dict_keys_assigned(jax_script_tree("profile_stages.py"), "stages")
    assert set(jax_stages) - {"connectivity_runs"} | {"fusion", "paint"} == set(
        profile_stages.STAGES)
    for name in profile_stages.STAGES:
        assert out[name] > 0, name
    assert out["_total_ms_per_img"] == pytest.approx(
        sum(out[n] for n in profile_stages.STAGES), abs=1e-3)
    assert out["_dispatch_floor_ms_per_img"] > 0
    assert out["_device_busy_ms_per_img"] == "not measured"
    assert out["_config"]["max_nodes"] == J_pipeline.padded_nodes(SEGMENTS, SIZE)


def test_host_ceiling_stages(jpeg_dir, tmp_path):
    cfg = T_bench.BenchConfig(batch=BATCH, image_size=SIZE, n_segments=SEGMENTS)
    out = host_ceiling.measure(cfg, "cpu", jpeg_dir)
    jax_keys = set(dict_keys_assigned(jax_script_tree("host_ceiling.py"), "out")) - {"notes"}
    assert jax_keys <= set(out)
    stages = [out[k] for k in ("decode_full_ms_per_img", "transfer_ms_per_img",
                               "compute_ms_per_img")]
    assert out["max_stage_ms_per_img"] == pytest.approx(max(stages), abs=2e-3)
    # The JAX script's sum: decode and the transfer's host CPU, not compute.
    assert out["cpu_sum_ms_per_img"] == pytest.approx(
        out["decode_full_ms_per_img"] + out["transfer_host_cpu_ms_per_img"], abs=2e-3)
    assert out["compute_host_cpu_ms_per_img"] > 0
    with pytest.raises(FileNotFoundError):
        host_ceiling.measure(cfg, "cpu", str(tmp_path))
    with pytest.raises(SystemExit):             # no default directory
        host_ceiling.main(["--device", "cpu"])


def test_device_only_loop_pulls_every_batch(monkeypatch):
    """The two-deep loop: warm-up plus timed dispatches, each batch pulled
    once, the last in the drain."""
    dispatched, pulled = [], []
    real_pull = T_bench.pull

    def dispatch(i):
        dispatched.append(i)
        return {"score": torch.full((1, 1), float(len(dispatched) - 1))}

    def counting_pull(out):
        pulled.append(int(out["score"][0, 0]))
        return real_pull(out)

    monkeypatch.setattr(T_bench, "pull", counting_pull)
    times, cpu_s = T_bench.device_only_times(dispatch, warmup=2, iters=3)
    assert len(times) == 3 and all(t >= 0 for t in times) and cpu_s >= 0
    assert dispatched == [0, 1, 2, 0, 1, 2]
    assert pulled == list(range(6))


@pytest.mark.parametrize("spans,lo,hi,want", [
    ([(0, 2), (1, 3), (5, 6)], float("-inf"), float("inf"), 4.0),   # overlap counts once
    ([(0, 2), (2, 4)], float("-inf"), float("inf"), 4.0),           # touching
    ([(0, 10)], 2.0, 5.0, 3.0),                                     # clipped
    ([(0, 1), (3, 4)], 1.5, 2.5, 0.0),                              # nothing inside
    ([], float("-inf"), float("inf"), 0.0),
])
def test_busy_us_is_the_union_of_spans(spans, lo, hi, want):
    assert busy_us(spans, lo, hi) == want


@pytest.mark.parametrize("width,height,size,same_scale", [
    (400, 300, 64, True),       # both decode at 1/4
    (1024, 768, 352, True),     # both at 1/2
    (1024, 768, 256, False),    # native 3/8, PIL 1/2
    (400, 300, 256, False),     # native 7/8, PIL full
])
def test_draft_decode_against_native_loader(width, height, size, same_scale, tmp_path):
    if not native.available():
        pytest.skip("native/libcmtdataio.so does not load here")
    paths = write_jpegs(str(tmp_path), 2, width, height, seed=7)
    want_full, ok = native.load_batch_u8(paths, size)
    assert ok.all()
    got_full = np.stack([load_image_u8(p, size) for p in paths])
    np.testing.assert_array_equal(got_full, want_full)
    want, ok = native.load_batch_u8(paths, size, draft=True)
    assert ok.all()
    got = T_bench.decode_batch_u8(paths, size, draft=True)
    assert got.shape == want.shape == (2, size, size, 3) and got.dtype == np.uint8
    if same_scale:
        np.testing.assert_array_equal(got, want)
    else:
        assert np.abs(got.astype(int) - want.astype(int)).mean() <= DRAFT_MEAN_LEVELS
