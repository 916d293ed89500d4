"""Parity of the PyTorch port's region-graph training with the JAX package,
on the CPU: masked BatchNorm statistics, ``RegionGraphGNN`` in train mode
and its gradients, dropout, the GT label means and the labelled graph
build, ``rg_loss``, the COD10K dataset reader, ``RGTrainer`` as a whole,
resume and the checkpoint exchange.

Inputs come from numpy with a seed at a small size (48² images, 16
segments, a 32-node bucket, 2 SLIC iterations, width 32) and go through
both packages. Tolerances: batch statistics and BatchNorm 1e-6 (the same
float32 sums in another order); model outputs 1e-5 and gradients 1e-5
relative to the largest gradient entry; the loss and its metrics 1e-6;
label means 1e-6; a whole training run 1e-3 (losses relative, parameters
absolute: two epochs of float32 steps from shared weights); a checkpoint
read by the other package 1e-5. Dataset arrays are numpy on both sides and
must be bit-equal.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

jax.config.update("jax_platforms", "cpu")

from camouflage_multimodal_tpu.api import load_rg_model as j_load_rg_model  # noqa: E402
from camouflage_multimodal_tpu.data import cod10k as j_cod10k  # noqa: E402
from camouflage_multimodal_tpu.models.layers import MaskedBatchNorm as JBN  # noqa: E402
from camouflage_multimodal_tpu.models.region_graph import RegionGraphGNN as JRG  # noqa: E402
from camouflage_multimodal_tpu.ops.graph import masked_batch_stats as j_stats  # noqa: E402
from camouflage_multimodal_tpu.ops.regions import (  # noqa: E402
    region_label_means as j_label_means)
from camouflage_multimodal_tpu.pipeline import (  # noqa: E402
    build_region_graphs_with_labels as j_build)
from camouflage_multimodal_tpu.train.train_rg import (  # noqa: E402
    RGTrainer as JRGTrainer, rg_loss as j_rg_loss)
from camouflage_multimodal_tpu_torch import data as T_data  # noqa: E402
from camouflage_multimodal_tpu_torch.api import load_rg_model  # noqa: E402
from camouflage_multimodal_tpu_torch.convert import (  # noqa: E402
    region_graph_params_from_state_dict, region_graph_state_dict)
from camouflage_multimodal_tpu_torch.models.layers import Dropout, MaskedBatchNorm  # noqa: E402
from camouflage_multimodal_tpu_torch.models.region_graph import RegionGraphGNN  # noqa: E402
from camouflage_multimodal_tpu_torch.ops.graph import masked_batch_stats  # noqa: E402
from camouflage_multimodal_tpu_torch.ops.regions import region_label_means  # noqa: E402
from camouflage_multimodal_tpu_torch.pipeline import build_region_graphs_with_labels  # noqa: E402
from camouflage_multimodal_tpu_torch.train.train_rg import (  # noqa: E402
    DATA_KEYS, RGTrainer, epoch_order, rg_loss)

QUIET = dict(log_fn=lambda *_: None)
SMALL = dict(n_segments=16, max_nodes=32, slic_iters=2)
H = 32


def t(x):
    return torch.from_numpy(np.array(x))


def _leaves(tree, prefix=""):
    if isinstance(tree, dict) or hasattr(tree, "items"):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    else:
        yield prefix, np.asarray(tree)


def _assert_trees_close(got, want, **tol):
    got, want = dict(_leaves(got)), dict(_leaves(want))
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], err_msg=key, **tol)


class TinyDataset:
    """Seeded stand-in for ``CODDataset``: blobs on noise, the instance map
    equal to the mask and an edge ring around it, float32 in [0, 1]."""

    def __init__(self, n=8, size=48, seed=7):
        g = np.random.default_rng(seed)
        yy, xx = np.mgrid[:size, :size]
        self.items = []
        for _ in range(n):
            img = g.random((size, size, 3)).astype(np.float32)
            cy, cx = g.integers(size // 4, size - size // 4, 2)
            r2 = (yy - cy) ** 2 + (xx - cx) ** 2
            mask = (r2 < (size / 5) ** 2).astype(np.float32)
            img[mask > 0] = 0.5 * img[mask > 0] + 0.4
            edge = ((r2 >= (size / 5 - 1.5) ** 2) & (r2 < (size / 5 + 1.5) ** 2)).astype(np.float32)
            self.items.append((img, mask, edge))

    def __len__(self):
        return len(self.items)

    def load_batch(self, idx):
        return {"image": np.stack([self.items[i][0] for i in idx]),
                "mask": np.stack([self.items[i][1] for i in idx]),
                "instance": np.stack([self.items[i][1] for i in idx]),
                "edge": np.stack([self.items[i][2] for i in idx])}


def _graph_case(seed=0, B=3, K=32, counts=(20, 32, 7)):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, K, 15)).astype(np.float32)
    mask = np.arange(K)[None] < np.array(counts)[:, None]
    adj = rng.random((B, K, K)) < 0.15
    adj = (adj | adj.transpose(0, 2, 1)) & mask[:, None, :] & mask[:, :, None]
    np.einsum("bii->bi", adj)[:] = False
    w = np.where(adj, rng.random((B, K, K)) * 0.9 + 0.1, 0.0).astype(np.float32)
    w = np.maximum(w, w.transpose(0, 2, 1))
    labels = {"mask_labels": rng.integers(0, 2, (B, K)),
              "instance_labels": rng.integers(0, 2, (B, K)),
              "edge_labels": rng.integers(0, 2, (B, K)).astype(np.float32)}
    return x, adj, w, mask, labels


def _jax_model_and_port(x, adj, w, mask, dropout=0.0, head_dropout=0.0):
    jmodel = JRG(hidden_channels=H, dropout=dropout, head_dropout=head_dropout)
    variables = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(adj),
                            jnp.asarray(w), jnp.asarray(mask))
    tmodel = RegionGraphGNN(hidden_channels=H, dropout=dropout, head_dropout=head_dropout)
    tmodel.load_state_dict(region_graph_state_dict(variables["params"], variables["batch_stats"]))
    return jmodel, variables, tmodel


# ---------------------------------------------------------------------------
# Masked batch statistics and BatchNorm in train mode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("counts", [(20, 32, 7), (0, 0, 1), (0, 0, 0)])
def test_masked_batch_stats_matches_jax(counts):
    """Over every valid node of the batch, not per graph; padded rows hold
    large values that must not count. An empty mask gives n = 1."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 32, 16)).astype(np.float32) + 3.0
    mask = np.arange(32)[None] < np.array(counts)[:, None]
    x[~mask] = 1e3
    got = masked_batch_stats(t(x), t(mask))
    want = j_stats(jnp.asarray(x), jnp.asarray(mask))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-6)
    assert float(got[2]) == max(sum(counts), 1)


def test_masked_batchnorm_train_mode_matches_flax():
    """Output and the updated running statistics (momentum 0.1, unbiased
    variance with the global count) against flax ``mutable=["batch_stats"]``,
    three steps in a row, then eval mode on the running statistics."""
    rng = np.random.default_rng(2)
    jbn = JBN(16)
    mask = np.arange(32)[None] < np.array([[20], [32], [5]])
    x0 = rng.standard_normal((3, 32, 16)).astype(np.float32)
    variables = jbn.init(jax.random.PRNGKey(0), jnp.asarray(x0), jnp.asarray(mask), False)
    params = {"scale": rng.random(16).astype(np.float32) + 0.5,
              "bias": rng.standard_normal(16).astype(np.float32)}
    stats = variables["batch_stats"]
    tbn = MaskedBatchNorm(16)
    tbn.load_state_dict({"weight": t(params["scale"]), "bias": t(params["bias"]),
                         "running_mean": t(stats["mean"]), "running_var": t(stats["var"])})
    tbn.train()
    for step in range(3):
        x = (rng.standard_normal((3, 32, 16)) * (step + 1) + step).astype(np.float32)
        want, mutated = jbn.apply({"params": params, "batch_stats": stats}, jnp.asarray(x),
                                  jnp.asarray(mask), False, mutable=["batch_stats"])
        stats = mutated["batch_stats"]
        got = tbn(t(x), t(mask))
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(tbn.running_mean.numpy(), np.asarray(stats["mean"]),
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(tbn.running_var.numpy(), np.asarray(stats["var"]),
                                   rtol=1e-6, atol=1e-6)
        assert float(got.detach()[~t(mask)].abs().max()) == 0.0
    want = jbn.apply({"params": params, "batch_stats": stats}, jnp.asarray(x), jnp.asarray(mask), True)
    with torch.no_grad():
        got = tbn.eval()(t(x), t(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# The model in train mode, its gradients, dropout
# ---------------------------------------------------------------------------

def test_region_graph_train_mode_and_gradients_match_jax():
    """Train mode at dropout 0: outputs at 1e-5, the updated batch
    statistics at 1e-6, and the gradients of ``rg_loss`` against
    ``jax.grad`` at 1e-5 relative and 1e-5 of the largest gradient entry
    absolute (the biases before a BatchNorm have an exact gradient of zero:
    both sides give float32 noise of ~1e-7 there). Padded nodes
    (whose GAT rows are all masked) get a finite, zero input gradient."""
    x, adj, w, mask, labels = _graph_case()
    jmodel, variables, tmodel = _jax_model_and_port(x, adj, w, mask)

    def loss_fn(params):
        out, mutated = jmodel.apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            jnp.asarray(x), jnp.asarray(adj), jnp.asarray(w), jnp.asarray(mask), train=True,
            rngs={"dropout": jax.random.PRNGKey(1)}, mutable=["batch_stats"])
        loss, _ = j_rg_loss(out, {k: jnp.asarray(v) for k, v in labels.items()}, jnp.asarray(mask))
        return loss, (out, mutated["batch_stats"])

    (jloss, (jout, jstats)), jgrads = jax.value_and_grad(loss_fn, has_aux=True)(variables["params"])

    tx = t(x).requires_grad_()
    out = tmodel.train()(tx, t(adj), t(w), t(mask))
    loss, _ = rg_loss(out, {k: t(v) for k, v in labels.items()}, t(mask))
    loss.backward()
    assert float(loss.detach()) == pytest.approx(float(jloss), rel=1e-6)
    for key in ("mask_logits", "instance_logits", "edge_logits", "node_embeddings",
                "graph_embedding"):
        np.testing.assert_allclose(out[key].detach().numpy(), np.asarray(jout[key]),
                                   rtol=1e-5, atol=1e-5, err_msg=key)
    _, stats = region_graph_params_from_state_dict(tmodel.state_dict())
    _assert_trees_close(stats, jstats, rtol=1e-6, atol=1e-6)
    grads_sd = {**tmodel.state_dict(), **{n: p.grad for n, p in tmodel.named_parameters()}}
    tgrads, _ = region_graph_params_from_state_dict(grads_sd)
    got, want = dict(_leaves(tgrads)), dict(_leaves(jgrads))
    assert set(got) == set(want)
    scale = max(float(np.abs(g).max()) for g in want.values())
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-5, atol=1e-5 * scale, err_msg=key)
    assert torch.isfinite(tx.grad).all()
    assert float(tx.grad[~t(mask)].abs().max()) == 0.0


def test_dropout_mechanics():
    """Rate 0.3 keeps ~70 % and scales the kept values by 1/0.7; a fixed
    generator repeats its draws; eval mode and rate 0 are the identity."""
    x = torch.rand(200, 500) + 0.5
    drop = Dropout(0.3)
    drop.generator = torch.Generator().manual_seed(0)
    y = drop(x)
    kept = y != 0
    assert abs(float(kept.float().mean()) - 0.7) < 0.01
    torch.testing.assert_close(y[kept], x[kept] / 0.7, rtol=0, atol=0)
    drop.generator = torch.Generator().manual_seed(0)
    assert torch.equal(drop(x), y)
    assert torch.equal(drop.eval()(x), x)
    assert torch.equal(Dropout(0.0)(x), x)


def test_region_graph_dropout_draws_from_its_generator():
    """The model's dropouts follow ``set_generator``; ``node_embeddings``
    are taken before the head dropout; eval mode is deterministic and equal
    to the same weights at rate 0; the checkpoint keys are the inference
    model's."""
    x, adj, w, mask, _ = _graph_case(seed=3)
    _, _, plain = _jax_model_and_port(x, adj, w, mask)
    model = RegionGraphGNN(hidden_channels=H, dropout=0.3, head_dropout=0.5)
    head_only = RegionGraphGNN(hidden_channels=H, dropout=0.0, head_dropout=0.5)
    assert set(model.state_dict()) == set(plain.state_dict())
    for m in (model, head_only):
        m.load_state_dict(plain.state_dict())
    args = (t(x), t(adj), t(w), t(mask))

    def run(m, seed):
        m.set_generator(torch.Generator().manual_seed(seed))
        return m.train()(*args)

    a, b, c = run(model, 1), run(model, 1), run(model, 2)
    assert torch.equal(a["mask_logits"], b["mask_logits"])
    assert not torch.equal(a["mask_logits"], c["mask_logits"])
    ref = plain.train()(*args)
    heads = run(head_only, 1)
    torch.testing.assert_close(heads["node_embeddings"], ref["node_embeddings"], rtol=0, atol=0)
    assert not torch.equal(heads["mask_logits"], ref["mask_logits"])
    model.load_state_dict(plain.state_dict())      # the same running statistics
    with torch.no_grad():
        e1 = model.eval()(*args)
        e2 = plain.eval()(*args)
    for key in e1:
        assert torch.equal(e1[key], e2[key]), key


# ---------------------------------------------------------------------------
# Labels and the labelled graph build
# ---------------------------------------------------------------------------

def test_region_label_means_matches_jax():
    rng = np.random.default_rng(4)
    maps = rng.random((2, 24, 20, 3)).astype(np.float32)
    seg = rng.integers(0, 14, (2, 24, 20))
    seg[1] = np.minimum(seg[1], 5)                  # empty segments: count clamped at 1
    got = region_label_means(t(maps), t(seg), 16).numpy()
    for b in range(2):
        want = np.asarray(j_label_means(jnp.asarray(maps[b]), jnp.asarray(seg[b]), 16))
        np.testing.assert_allclose(got[b], want, rtol=1e-6, atol=1e-6)
    one = region_label_means(t(maps[..., 0]), t(seg), 16).numpy()
    np.testing.assert_allclose(one[..., 0], got[..., 0], rtol=0, atol=0)


def _agreeing_nodes(seg_a, seg_b, K):
    """(B, K) True where node k covers the same pixels in both maps."""
    out = np.zeros((seg_a.shape[0], K), bool)
    for b in range(seg_a.shape[0]):
        for k in range(K):
            out[b, k] = np.array_equal(seg_a[b] == k, seg_b[b] == k)
    return out


def test_build_region_graphs_with_labels_matches_jax():
    """uint8 and float GT maps give the same labels; the labels equal the
    JAX build's on every node whose pixels are the same in both
    segmentations (SLIC's own agreement is the inference bar, ≥ 99 %)."""
    ds = TinyDataset(n=4, seed=11)
    raw = ds.load_batch([0, 1, 2, 3])
    u8 = {k: (v * 255).round().astype(np.uint8) for k, v in raw.items()}
    batch, labels = build_region_graphs_with_labels(
        *(t(u8[k]) for k in ("image", "mask", "instance", "edge")), **SMALL)
    _, labels_f = build_region_graphs_with_labels(
        t(u8["image"]), *(t(u8[k].astype(np.float32) / 255.0) for k in ("mask", "instance", "edge")),
        **SMALL)
    for key in labels:
        assert torch.equal(labels[key], labels_f[key]), key
    assert labels["mask_labels"].dtype == torch.int64
    assert labels["edge_labels"].dtype == torch.float32

    jbatch, jlabels = j_build(*(jnp.asarray(u8[k]) for k in ("image", "mask", "instance", "edge")),
                              **SMALL)
    seg, jseg = batch.segments.numpy(), np.asarray(jbatch.segments)
    assert (seg == jseg).mean() >= 0.99
    agree = _agreeing_nodes(seg, jseg, SMALL["max_nodes"])
    assert agree[batch.node_mask.numpy()].mean() >= 0.9
    for key in labels:
        np.testing.assert_array_equal(labels[key].numpy()[agree], np.asarray(jlabels[key])[agree],
                                      err_msg=key)
    assert labels["mask_labels"].sum() > 0 and labels["edge_labels"].sum() > 0


def test_rg_loss_and_metrics_match_jax():
    rng = np.random.default_rng(5)
    _, _, _, mask, labels = _graph_case(seed=5)
    out = {"mask_logits": rng.standard_normal((3, 32, 2)).astype(np.float32),
           "instance_logits": rng.standard_normal((3, 32, 2)).astype(np.float32),
           "edge_logits": rng.standard_normal((3, 32, 1)).astype(np.float32)}
    loss, metrics = rg_loss({k: t(v) for k, v in out.items()},
                            {k: t(v) for k, v in labels.items()}, t(mask))
    jloss, jmetrics = j_rg_loss({k: jnp.asarray(v) for k, v in out.items()},
                                {k: jnp.asarray(v) for k, v in labels.items()}, jnp.asarray(mask))
    assert float(loss) == pytest.approx(float(jloss), rel=1e-6)
    assert set(metrics) == set(jmetrics)
    for key in metrics:
        assert float(metrics[key]) == pytest.approx(float(jmetrics[key]), rel=1e-6), key


def test_epoch_order_keeps_every_sample_with_a_tail_window():
    rng = np.random.default_rng(0)
    order = epoch_order(rng, np.arange(10), 4, shuffle=False)
    np.testing.assert_array_equal(order, [[0, 1, 2, 3], [4, 5, 6, 7], [6, 7, 8, 9]])
    np.testing.assert_array_equal(epoch_order(rng, np.arange(3), 4, False), [[0, 1, 2]])
    np.testing.assert_array_equal(epoch_order(rng, np.arange(8), 4, False).shape, (2, 4))
    shuffled = epoch_order(np.random.default_rng(1), np.arange(9), 4, True)
    assert set(shuffled.reshape(-1)) == set(range(9)) and shuffled.shape == (3, 4)


def test_cod10k_reader_matches_jax_pil_path(tmp_path):
    """The sample scan (complete quadruples only), PIL decode and resize and
    the name parser: bit-equal to the JAX package's PIL path."""
    from PIL import Image

    rng = np.random.default_rng(6)
    dirs = {d: tmp_path / d for d in ("images", "gt_object", "gt_instance", "gt_edge")}
    for d in dirs.values():
        d.mkdir()
    names = ["COD10K-CAM-1-Aquatic-1-BatFish-1", "COD10K-CAM-2-Terrestrial-23-Cat-7",
             "COD10K-NonCAM-5", "missing-gt"]
    for i, name in enumerate(names):
        ext = ".jpg" if i % 2 == 0 else ".png"
        Image.fromarray(rng.integers(0, 256, (40 + i, 50, 3), dtype=np.uint8)).save(
            dirs["images"] / (name + ext))
        for d in ("gt_object", "gt_instance", "gt_edge"):
            if name != "missing-gt":
                Image.fromarray(rng.integers(0, 256, (40 + i, 50), dtype=np.uint8)).save(
                    dirs[d] / (name + ".png"))
    args = [str(dirs[d]) for d in ("images", "gt_object", "gt_instance", "gt_edge")]
    tds = T_data.CODDataset(*args, image_size=32)
    jds = j_cod10k.CODDataset(*args, image_size=32, use_native=False)
    assert len(tds) == len(jds) == 3
    assert [s.image_name for s in tds.samples] == [s.image_name for s in jds.samples]
    got, want = tds.load_batch([2, 0]), jds.load_batch([2, 0])
    for key in ("image", "mask", "instance", "edge"):
        assert got[key].dtype == np.float32
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    assert got["image_name"] == want["image_name"]
    for name in names + ["x.jpg", "a-b"]:
        assert T_data.parse_cod10k_name(name + ".jpg") == j_cod10k.parse_cod10k_name(name + ".jpg")


def test_build_cached_dataset_mechanics():
    """Chunks padded with their last sample and trimmed, no adjacency
    stored, bfloat16 weights on request, and the same graphs as one build
    of all the images."""
    ds = TinyDataset(n=5, seed=12)
    trainer = RGTrainer(**SMALL)
    data = trainer.build_cached_dataset(ds, batch_size=4, device="cpu")
    assert set(data) == set(DATA_KEYS)
    assert data["features"].shape == (5, 32, 15) and data["edge_weights"].shape == (5, 32, 32)
    whole, labels = trainer.build_graphs(*(ds.load_batch(range(5))[k]
                                           for k in ("image", "mask", "instance", "edge")),
                                         device="cpu")
    assert torch.equal(data["features"], whole.features)
    assert torch.equal(data["edge_weights"] > 0, whole.adjacency)
    for key in labels:
        assert torch.equal(data[key], labels[key]), key
    half = trainer.build_cached_dataset(ds, batch_size=16, weights_dtype=torch.bfloat16,
                                        device="cpu")
    assert half["edge_weights"].dtype == torch.bfloat16
    assert torch.equal(half["edge_weights"], whole.edge_weights.to(torch.bfloat16))


# ---------------------------------------------------------------------------
# The slice as a whole: RGTrainer
# ---------------------------------------------------------------------------

def _port_data_from_jax(jdata):
    data = {k: t(v) for k, v in jdata.items()}
    for key in ("mask_labels", "instance_labels"):
        data[key] = data[key].long()
    return data


# The biases ahead of a BatchNorm in train mode have an exact gradient of
# zero: each side's float32 rounding gives ~1e-8, and Adam's normalisation
# turns that into steps of up to about lr, in unrelated directions. They,
# and the running means that follow them, are held to 2·lr·steps.
GRADIENT_FREE = {"/gat_bias", "/gcn2_bias", "/gcn3_bias", "/gcn4_bias"}


def _assert_trained_close(params, stats, jparams, jstats, lr, steps):
    drift = 2 * lr * steps
    got, want = dict(_leaves(params)), dict(_leaves(jparams))
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=0,
                                   atol=drift if key in GRADIENT_FREE else 1e-3, err_msg=key)
    got, want = dict(_leaves(stats)), dict(_leaves(jstats))
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=0,
                                   atol=drift if key.endswith("/mean") else 1e-3, err_msg=key)


def test_rg_trainer_matches_jax_trainer(monkeypatch):
    """The JAX ``RGTrainer.fit`` and the port's from the same initial
    weights (``init_state(PRNGKey(0))`` carried over by ``convert``), the
    same split and batches (12 samples: 9 train in 3 steps with the tail
    window, 3 validation in one short batch), on the graphs the JAX package
    built (SLIC's own agreement is tested above), at dropout 0, 3 epochs,
    lr 3e-4: per-epoch losses within 1e-3 relative, the same accuracies,
    final parameters and running variances within 1e-3, the gradient-free
    biases and the running means within 2·lr·steps. Not the recipe's lr
    1e-3: ``gat_att_dst`` (whose gradient vanishes where a row's attention
    logits all lie on one side of the LeakyReLU's kink) then ends close to
    the bar, as Adam turns rounding in small gradients into steps of up to
    lr."""
    ds = TinyDataset(n=12, seed=13)
    epochs, batch, lr = 3, 4, 3e-4
    jtrainer = JRGTrainer(model=JRG(hidden_channels=H, dropout=0.0, head_dropout=0.0),
                          learning_rate=lr, **SMALL)
    init = jtrainer.init_state(jax.random.PRNGKey(0))
    jstate, jhist = jtrainer.fit(ds, epochs=epochs, batch_size=batch, checkpoint_path=None,
                                 **QUIET)
    jdata = jtrainer.build_cached_dataset(ds, batch_size=16)

    model = RegionGraphGNN(hidden_channels=H, dropout=0.0, head_dropout=0.0)
    model.load_state_dict(region_graph_state_dict(init.params, init.batch_stats))
    trainer = RGTrainer(model=model, learning_rate=lr, **SMALL)
    monkeypatch.setattr(trainer, "build_cached_dataset",
                        lambda *a, **k: _port_data_from_jax(jdata))
    _, hist = trainer.fit(ds, epochs=epochs, batch_size=batch, checkpoint_path=None,
                          device="cpu", **QUIET)

    assert set(hist) == set(jhist)
    for key in ("train_loss", "val_loss"):
        np.testing.assert_allclose(hist[key], jhist[key], rtol=1e-3, err_msg=key)
    for key in ("train_acc_mask", "val_acc_mask"):
        np.testing.assert_allclose(hist[key], jhist[key], rtol=0, atol=1e-6, err_msg=key)
    params, stats = region_graph_params_from_state_dict(model.state_dict())
    _assert_trained_close(params, stats, jstate.params, jstate.batch_stats, lr, 3 * epochs)


def test_rg_trainer_resume_bitmatch(tmp_path):
    """A run resumed from its snapshot bit-matches an uninterrupted one,
    with dropout on (the generator's state travels in the snapshot)."""
    ds = TinyDataset(n=8, seed=14)
    kw = dict(batch_size=4, checkpoint_path=None, device="cpu", **QUIET)
    resume = str(tmp_path / "rg_resume.ckpt")

    def trainer():
        model = RegionGraphGNN(hidden_channels=H)
        model.reset_parameters(torch.Generator().manual_seed(0))
        return RGTrainer(model=model, **SMALL)

    full_model, full_hist = trainer().fit(ds, epochs=4, **kw)
    trainer().fit(ds, epochs=2, resume_path=resume, **kw)
    cont_model, cont_hist = trainer().fit(ds, epochs=4, resume_from=resume, **kw)
    assert cont_hist == full_hist
    for (k, a), b in zip(full_model.state_dict().items(), cont_model.state_dict().values()):
        assert torch.equal(a, b), k


def test_port_rg_checkpoint_loads_in_both_packages(tmp_path):
    """The best checkpoint of a port run is in the JAX layout: the JAX
    package's ``load_rg_model`` reads it and its eval outputs equal the
    port's ``load_rg_model``'s at 1e-5."""
    ds = TinyDataset(n=8, seed=15)
    ckpt = str(tmp_path / "rg_best.ckpt")
    trainer = RGTrainer(model=RegionGraphGNN(hidden_channels=H), **SMALL)
    _, history = trainer.fit(ds, epochs=2, batch_size=4, checkpoint_path=ckpt,
                             device="cpu", **QUIET)
    jmodel, variables = j_load_rg_model(ckpt)
    assert jmodel.hidden_channels == H
    loaded = load_rg_model(ckpt, device="cpu")
    x, adj, w, mask, _ = _graph_case(seed=16)
    want = jmodel.apply(variables, jnp.asarray(x), jnp.asarray(adj), jnp.asarray(w),
                        jnp.asarray(mask))
    with torch.no_grad():
        got = loaded(t(x), t(adj), t(w), t(mask))
    for key in want:
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), rtol=1e-5,
                                   atol=1e-5, err_msg=key)
    from camouflage_multimodal_tpu_torch.core.checkpoint import load_checkpoint
    blob = load_checkpoint(ckpt)
    assert blob["val_loss"] == min(history["val_loss"])
    assert blob["model_config"] == {"in_channels": 15, "hidden_channels": H, "num_classes": 2}


def test_rg_fit_refuses_a_mesh_and_a_missing_card():
    """``mesh=`` takes only a ``parallel.sharding.make_mesh`` mesh, a batch
    that does not divide over its data axis raises the JAX ``ValueError``
    (on a two-rank mesh of torch's fake backend), and ``cuda`` raises
    without a card. Data-parallel fits themselves are held in
    tests/test_torch_port_parallel.py."""
    from test_torch_port_parallel import fake_mesh

    trainer = RGTrainer(**SMALL)
    with pytest.raises(TypeError, match="DeviceMesh"):
        trainer.fit(TinyDataset(n=4), epochs=1, mesh=object(), device="cpu", **QUIET)
    with fake_mesh(2) as mesh:
        with pytest.raises(ValueError, match="not divisible by the mesh's data axis"):
            trainer.fit(TinyDataset(n=4), epochs=1, batch_size=3, mesh=mesh, device="cpu",
                        **QUIET)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="is_available"):
            trainer.fit(TinyDataset(n=4), epochs=1, **QUIET)
