"""Spatial sharding of the region-graph build in the PyTorch port
(``parallel.sharding.shard_spatial``, ``RegionGraphPipeline(spatial=True)``,
the ``row_group`` of ``ops/``) on the CPU: gloo ranks against the port
without a mesh and against the JAX package's ``RegionGraphPipeline(
spatial=True)``.

Sizes are the JAX spatial test's (``tests/test_pipeline_e2e.py``): 128²,
64 segments (a 128-node bucket), 3 SLIC iterations, the committed RG
weights, on seeded images. The ranks split the rows over a (1, 2) mesh (64
rows each) and over a (2, 2) mesh (two images, one per data rank). Bars:
against the port without a mesh, the JAX test's own — segment maps ≥ 99.5 %
equal, heatmaps within 1e-4 where the segments agree, equal live-node
counts — and the multimodal outputs within 1e-5; against JAX's spatial run
on a (1, 2) mesh of two forced CPU devices, segments ≥ 99 % equal and
heatmap MAE ≤ 1e-2. Canny with a step edge on or next to the rank boundary
row equals the unsharded map exactly (the halo rows carry the stencils
across; only the global top and bottom reflect).
"""

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

from camouflage_multimodal_tpu_torch.api import load_rg_model  # noqa: E402
from camouflage_multimodal_tpu_torch.models.fusion import MultimodalCamouflageDetector  # noqa: E402
from camouflage_multimodal_tpu_torch.ops.canny import canny  # noqa: E402
from camouflage_multimodal_tpu_torch.parallel.sharding import model_group, shard_spatial  # noqa: E402
from camouflage_multimodal_tpu_torch.pipeline import (  # noqa: E402
    MultimodalPipeline, RegionGraphPipeline, padded_nodes)

SIZE = 128
SEGMENTS = 64
ITERS = 3
K = padded_nodes(SEGMENTS, SIZE)
RG_CKPT = os.path.join(REPO, "artifacts", "rg_model.ckpt")
N_KG = 13
# Rows of a step edge, counted from the rank boundary of a (1, 2) mesh.
EDGE_OFFSETS = (-2, -1, 0, 1, 3)
OUT_KEYS = ("heatmap", "segments", "node_mask", "region_features")
FUSION_KEYS = ("mask_prob", "instance_prob", "edge_prob", "score", "mask_logits")


# ---------------------------------------------------------------------------
# Inputs, made from seeds on every side
# ---------------------------------------------------------------------------

def images(n: int) -> np.ndarray:
    """(n, SIZE, SIZE, 3) float32 in [0, 1]: smooth colour blobs, a sine
    texture and noise."""
    rng = np.random.default_rng(21)
    yy, xx = np.mgrid[:SIZE, :SIZE] / SIZE
    out = []
    for _ in range(n):
        img = np.zeros((SIZE, SIZE, 3)) + 0.5 * rng.random(3)
        for _ in range(5):
            cy, cx = rng.random(2)
            r = 0.05 + 0.2 * rng.random()
            img += np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * r * r))[..., None] * (
                rng.random(3) - 0.3)
        img += 0.08 * np.sin(2 * np.pi * 7 * (yy + 2 * xx))[..., None]
        img += 0.04 * rng.standard_normal(img.shape)
        out.append(np.clip(img, 0, 1))
    return np.stack(out).astype(np.float32)


def step_edge(offset: int) -> np.ndarray:
    """(1, SIZE, SIZE) gray image: 0.2 above row SIZE / 2 + offset, 0.8 from
    there on; the only edge Canny can find."""
    gray = np.full((1, SIZE, SIZE), 0.2, np.float32)
    gray[:, SIZE // 2 + offset:] = 0.8
    return gray


def kg_tensor() -> torch.Tensor:
    return torch.from_numpy(np.random.default_rng(8).standard_normal((N_KG, 128))
                            .astype(np.float32))


def fusion_model() -> MultimodalCamouflageDetector:
    model = MultimodalCamouflageDetector(dropout=0.0, use_pallas=True)
    model.reset_parameters(torch.Generator().manual_seed(3))
    return model.eval()


def pipelines(mesh):
    rg = RegionGraphPipeline(load_rg_model(RG_CKPT, "cpu"), n_segments=SEGMENTS,
                             image_size=SIZE, max_nodes=K, slic_iters=ITERS, mesh=mesh,
                             spatial=True)
    return rg, MultimodalPipeline(rg, fusion_model())


def run(mesh, imgs):
    """The RG pipeline's and the multimodal pipeline's outputs as numpy."""
    rg, mm = pipelines(mesh)
    x = torch.from_numpy(imgs)
    out = {k: v.numpy() for k, v in rg(x).items() if k in OUT_KEYS}
    mm_out = mm(x, kg_tensor())
    out.update({f"mm/{k}": mm_out[k].numpy() for k in FUSION_KEYS + ("heatmap", "segments")})
    return out


# ---------------------------------------------------------------------------
# The ranks
# ---------------------------------------------------------------------------

def task_pipeline(mesh, work):
    """The spatial run, and the RG pipeline on the same mesh without
    ``spatial`` (the model ranks repeat their data rank's build)."""
    imgs = np.load(os.path.join(work, f"images{mesh.size()}.npy"))
    out = run(mesh, imgs)
    rg = RegionGraphPipeline(load_rg_model(RG_CKPT, "cpu"), n_segments=SEGMENTS,
                             image_size=SIZE, max_nodes=K, slic_iters=ITERS, mesh=mesh)
    out.update({f"replicated/{k}": v.numpy() for k, v in rg(torch.from_numpy(imgs)).items()
                if k in OUT_KEYS})
    return out


def task_canny(mesh, work):
    """Canny on each step-edge image, this rank's rows, gathered by the test."""
    group = model_group(mesh)
    out = {}
    for off in EDGE_OFFSETS:
        local = shard_spatial(torch.from_numpy(step_edge(off))[..., None], mesh)[..., 0]
        out[f"edge{off}"] = canny(local, 2.0, row_group=group).numpy()
    try:
        shard_spatial(torch.zeros(1, SIZE - 1, 8, 3), mesh)
        out["indivisible_raises"] = False
    except ValueError:
        out["indivisible_raises"] = True
    return out


TASKS = {name[5:]: fn for name, fn in globals().items() if name.startswith("task_")}

JAX_SPATIAL = f"""
import os
import numpy as np, jax, jax.numpy as jnp
from camouflage_multimodal_tpu.api import load_rg_model
from camouflage_multimodal_tpu.parallel.sharding import make_mesh, replicate
from camouflage_multimodal_tpu.pipeline import RegionGraphPipeline
work = os.environ["WORK"]
model, variables = load_rg_model({RG_CKPT!r})
mesh = make_mesh(jax.devices(), data_axis=1, model_axis=2)
pipe = RegionGraphPipeline(model, n_segments={SEGMENTS}, image_size={SIZE}, max_nodes={K},
                           slic_iters={ITERS}, mesh=mesh, spatial=True)
with mesh:
    out = pipe(replicate(variables, mesh), jnp.asarray(np.load(os.path.join(work, "images2.npy"))))
np.savez(os.path.join(work, "jax_spatial.npz"),
         **{{k: np.asarray(out[k]) for k in ("segments", "heatmap", "node_mask")}})
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """A (1, 2) and a (2, 2) group run the tasks while the test process runs
    the JAX reference and the port without a mesh."""
    work = str(tmp_path_factory.mktemp("spatial"))
    np.save(os.path.join(work, "images2.npy"), images(1))
    np.save(os.path.join(work, "images4.npy"), images(2))
    jax_proc = ranks.start_jax(JAX_SPATIAL, 2, work)
    groups = {(2, 2): ranks.spawn(__file__, 2, 2, work, ["pipeline", "canny"]),
              (4, 2): ranks.spawn(__file__, 4, 2, work, ["pipeline"])}
    alone = {world: run(None, np.load(os.path.join(work, f"images{world}.npy")))
             for world in (2, 4)}
    logs = {key: ranks.wait(procs) for key, procs in groups.items()}
    ranks.finish_jax(jax_proc)

    def result(task, world, rank=0):
        return ranks.result(work, world, 2, task, rank, logs[(world, 2)])

    return {"result": result, "alone": alone,
            "jax": ranks.load(os.path.join(work, "jax_spatial.npz"))}


def _assert_matches_unsharded(got, want):
    """The JAX spatial test's bars, and the multimodal outputs within 1e-5."""
    same = got["segments"] == want["segments"]
    assert same.mean() >= 0.995, same.mean()
    np.testing.assert_allclose(got["heatmap"][same], want["heatmap"][same], rtol=0, atol=1e-4)
    np.testing.assert_array_equal(got["node_mask"].sum(-1), want["node_mask"].sum(-1))
    for key in FUSION_KEYS:
        np.testing.assert_allclose(got[f"mm/{key}"], want[f"mm/{key}"], rtol=0, atol=1e-5,
                                   err_msg=key)
    np.testing.assert_array_equal(got["mm/segments"], got["segments"])
    np.testing.assert_array_equal(got["mm/heatmap"], got["heatmap"])


@pytest.mark.parametrize("world", [2, 4])
def test_spatial_pipeline_matches_unsharded(runs, world):
    """Rows over two model ranks ((1, 2), one image; (2, 2), two images over
    two data ranks): every rank returns the whole maps, equal across the
    ranks, within the JAX spatial test's bars of the port without a mesh."""
    outs = [runs["result"]("pipeline", world, r) for r in range(world)]
    for out in outs[1:]:
        for key in outs[0]:
            np.testing.assert_array_equal(out[key], outs[0][key], err_msg=key)
    assert outs[0]["heatmap"].shape == (world // 2, SIZE, SIZE)
    _assert_matches_unsharded(outs[0], runs["alone"][world])


@pytest.mark.parametrize("world", [2, 4])
def test_model_axis_without_spatial_replicates_the_build(runs, world):
    """On the same meshes without ``spatial`` each model rank builds its
    data rank's images whole (JAX's ``P("data")`` layout): the outputs
    equal the pipeline without a mesh within 1e-6."""
    out = runs["result"]("pipeline", world, world - 1)
    for key in OUT_KEYS:
        np.testing.assert_allclose(out[f"replicated/{key}"], runs["alone"][world][key],
                                   rtol=0, atol=1e-6, err_msg=key)


def test_spatial_pipeline_matches_jax_spatial(runs):
    """The port's (1, 2) spatial run against the JAX package's on a (1, 2)
    mesh: segments ≥ 99 % equal, heatmap MAE ≤ 1e-2, live nodes within 1."""
    got, want = runs["result"]("pipeline", 2), runs["jax"]
    same = got["segments"] == want["segments"]
    assert same.mean() >= 0.99, same.mean()
    assert np.abs(got["heatmap"] - want["heatmap"]).mean() <= 1e-2
    assert abs(int(got["node_mask"].sum()) - int(want["node_mask"].sum())) <= 1


@pytest.mark.parametrize("offset", EDGE_OFFSETS)
def test_canny_across_the_rank_boundary_is_exact(runs, offset):
    """A step edge on the rank boundary row (offset 0) or a few rows from
    it: the two ranks' rows of the sharded Canny map, stacked, equal the
    unsharded map exactly, and that map holds the edge."""
    want = canny(torch.from_numpy(step_edge(offset)), 2.0).numpy()
    got = np.concatenate([runs["result"]("canny", 2, r)[f"edge{offset}"] for r in (0, 1)],
                         axis=1)
    assert want.any()
    np.testing.assert_array_equal(got, want)


def test_shard_spatial_rejects_an_indivisible_height(runs):
    """``shard_spatial`` raises ``ValueError`` when the height does not
    divide over the model axis."""
    assert bool(runs["result"]("canny", 2, 0)["indivisible_raises"])


if __name__ == "__main__":
    ranks.rank_main(TASKS, sys.argv[1:])
