"""Parity of the PyTorch port's knowledge-graph path with the JAX package,
on the CPU: the annotation normalizer, the store (ingest, queries, the JSON
file read by the other package), the featurizer, Adam with L2,
``KnowledgeGraphGNN`` in train and eval mode, ``KGTrainer`` as a whole,
the plateau rule, resume, the checkpoint exchange and the embedding
factory.

Annotations come from numpy with a seed (4 categories × 12 annotations,
vocabulary words so that colour and texture nodes appear, a 32-node
bucket, width 32). The JAX KG model hard-codes its two 0.2 dropouts, so
the JAX side of a train-mode comparison runs with flax's ``Dropout``
patched to the identity; the port's model gets ``head_drop.p = 0``.
Tolerances: host-side records and padded arrays bit-equal; Adam-L2 steps
1e-6; model outputs 1e-5 and gradients 1e-5 relative to the largest
gradient entry; a whole training run 1e-3 (losses relative, parameters
absolute); a checkpoint read by the other package and the embeddings of
the committed checkpoint 1e-5.
"""

import json

import flax.linen as fnn
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

jax.config.update("jax_platforms", "cpu")

from camouflage_multimodal_tpu.core.artifacts import (  # noqa: E402
    load_kg_embeddings as j_load_kg_embeddings)
from camouflage_multimodal_tpu.core.checkpoint import load_checkpoint as j_load_checkpoint  # noqa: E402
from camouflage_multimodal_tpu.kg import featurize as j_featurize  # noqa: E402
from camouflage_multimodal_tpu.kg import normalize as j_normalize  # noqa: E402
from camouflage_multimodal_tpu.kg.store import (  # noqa: E402
    CamouflageKnowledgeStore as JStore)
from camouflage_multimodal_tpu.models.knowledge_graph import (  # noqa: E402
    KnowledgeGraphGNN as JKG)
from camouflage_multimodal_tpu.train.state import (  # noqa: E402
    TrainState, apply_updates as j_apply_updates, make_adam_l2_tx)
from camouflage_multimodal_tpu.train import train_kg as j_train_kg  # noqa: E402
from camouflage_multimodal_tpu_torch import data as T_data  # noqa: E402
from camouflage_multimodal_tpu_torch.api import load_kg_model  # noqa: E402
from camouflage_multimodal_tpu_torch.convert import (  # noqa: E402
    knowledge_graph_params_from_state_dict, knowledge_graph_state_dict)
from camouflage_multimodal_tpu_torch.kg import featurize, normalize  # noqa: E402
from camouflage_multimodal_tpu_torch.kg.store import CamouflageKnowledgeStore  # noqa: E402
from camouflage_multimodal_tpu_torch.models.knowledge_graph import KnowledgeGraphGNN  # noqa: E402
from camouflage_multimodal_tpu_torch.train.state import apply_updates, make_adam_l2  # noqa: E402
from camouflage_multimodal_tpu_torch.train.train_kg import (  # noqa: E402
    KGTrainer, compare_embeddings, create_dataset_from_store, plateau_step)

QUIET = dict(log_fn=lambda *_: None)
KG_CKPT = "artifacts/kg_gnn_model.ckpt"
N = 32          # node bucket
H = 32          # hidden and embedding width

CATEGORIES = ("Fish", "Insect", "Reptile", "Mollusc")
COLORS = ("green", "brown", "sandy brown", "olive green", "gray", "blue-grey", "white",
          "dark green", "beige", "orange", "black", "red", "yellow", "purple")
TEXTURES = ("rough", "smooth", "scaly", "gravel", "rocky", "vegetation", "coral",
            "root-like", "bumpy", "fuzzy", "soft")
BACKGROUNDS = ("an underwater coral reef", "a sandy seabed", "a forest floor of dark leaves",
               "desert rocks in shadow", "open grassland", "murky blue water",
               "a dim rocky shore", "a tree trunk")
PATTERNS = ("Disruptive pattern", "spotted", "striped", "uniform", "mottled", "None", "banded")
LEVELS = ("high", "medium", "low", "very high", "very low", "unclear")


def synthetic_annotations(seed, categories=CATEGORIES, per_category=12):
    """(file name, annotation JSON) pairs in the schema of the reference's
    annotation files, with organisms repeated across files (MERGE)."""
    rng = np.random.default_rng(seed)
    out = []
    for cat in categories:
        for i in range(per_category):
            colors = rng.choice(COLORS, 2, replace=False)
            textures = rng.choice(TEXTURES, 2, replace=False)
            bg_colors = rng.choice(COLORS, 2, replace=False)
            out.append((f"{cat.lower()}_{i:03d}.json", {
                "object_name": f"{cat}{int(rng.integers(0, 5))}",
                "object_category": cat,
                "background_description": (f"{rng.choice(BACKGROUNDS)} with {bg_colors[0]} "
                                           f"and {bg_colors[1]} {rng.choice(TEXTURES)} patches"),
                "explanation": (f"Its {colors[0]} and {colors[1]} body has a {textures[0]}, "
                                f"{textures[1]} surface"),
                "camouflage_type": str(rng.choice(PATTERNS)),
                "camouflage_presence": "Camouflage" if rng.random() < 0.7 else "None",
                "color_similarity": str(rng.choice(LEVELS)),
                "texture_similarity": str(rng.choice(LEVELS)),
                "contrast_difference": str(rng.choice(LEVELS)),
                "camouflage_score": float(np.round(rng.random(), 3)),
                "confidence": float(np.round(0.5 + 0.5 * rng.random(), 3)),
            }))
    return out


def _stores(annotations):
    tstore, jstore = CamouflageKnowledgeStore(), JStore()
    for name, obj in annotations:
        tstore.ingest_annotation(obj, name)
        jstore.ingest_annotation(obj, name)
    return tstore, jstore


TABLES = ("organisms", "environments", "assessments", "similarities", "observations")


def _assert_same_store(a, b):
    for table in TABLES:
        assert getattr(a, table) == getattr(b, table), table


def t(x):
    return torch.from_numpy(np.array(x))


def _leaves(tree, prefix=""):
    if isinstance(tree, dict) or hasattr(tree, "items"):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    else:
        yield prefix, np.asarray(tree)


@pytest.fixture
def no_jax_dropout(monkeypatch):
    """flax's ``Dropout`` as the identity: the JAX KG model's 0.2 rates are
    hard-coded."""
    monkeypatch.setattr(fnn.Dropout, "__call__",
                        lambda self, inputs, deterministic=None, rng=None: inputs)


# ---------------------------------------------------------------------------
# Host side: normalizer, store, featurizer
# ---------------------------------------------------------------------------

def test_normalizer_matches_jax():
    for name, obj in synthetic_annotations(0):
        assert normalize.extract_structured(obj, name) == j_normalize.extract_structured(obj, name)
    for text in ("Olive Green", " translucent ", "gravel", "Shape disruption", "Very High",
                 "deep ocean water", "plain"):
        assert normalize.normalize_color(text) == j_normalize.normalize_color(text)
        assert normalize.normalize_texture(text) == j_normalize.normalize_texture(text)
        assert normalize.normalize_pattern(text) == j_normalize.normalize_pattern(text)
        assert (normalize.determine_environment_type(text)
                == j_normalize.determine_environment_type(text))
        assert (normalize.text_similarity_to_numeric(text)
                == j_normalize.text_similarity_to_numeric(text))
        assert (normalize.extract_colors_from_text(text)
                == j_normalize.extract_colors_from_text(text))


def test_store_and_featurizer_match_jax():
    """MERGE-semantics ingest, the category census, subgraph extraction,
    featurization and padding (with truncation) equal the JAX package's."""
    tstore, jstore = _stores(synthetic_annotations(1))
    _assert_same_store(tstore, jstore)
    assert tstore.categories() == jstore.categories()
    assert len(tstore.organisms) < 4 * 12                 # organisms repeat
    for cat, _ in tstore.categories():
        for limit in (50, 3):
            assert (tstore.extract_category_subgraphs(cat, limit)
                    == jstore.extract_category_subgraphs(cat, limit))
    subs = create_dataset_from_store(tstore, limit_per_category=50)
    jsubs = j_train_kg.create_dataset_from_store(jstore, limit_per_category=50)
    assert len(subs) == len(jsubs) == 48
    for a, b in zip(subs, jsubs):
        np.testing.assert_array_equal(a["x"], b["x"])
        assert a["edges"] == b["edges"] and a["y"] == b["y"]
    assert max(s["x"].shape[0] for s in subs) > 12
    assert np.any([s["x"][:, 12:32].any() for s in subs])   # vocabulary features
    for bucket in (N, 12):
        got = featurize.pad_subgraphs(subs, bucket)
        want = j_featurize.pad_subgraphs(jsubs, bucket)
        for g, w in zip(got[:4], want[:4]):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
        assert got[4] == want[4]
    assert featurize.pad_subgraphs(subs, 12)[4] > 0


def test_store_files_cross_packages(tmp_path):
    """``save`` in one package, ``load`` in the other, both ways; the
    directory ingest with its processed-files log and a malformed file."""
    ann = synthetic_annotations(2)
    tstore, jstore = _stores(ann)
    tstore.save(str(tmp_path / "port.json"))
    jstore.save(str(tmp_path / "jax.json"))
    _assert_same_store(JStore.load(str(tmp_path / "port.json")), jstore)
    _assert_same_store(CamouflageKnowledgeStore.load(str(tmp_path / "jax.json")), tstore)

    folder = tmp_path / "annotations"
    folder.mkdir()
    for name, obj in ann[:20]:
        (folder / name).write_text(json.dumps(obj))
    (folder / "broken.json").write_text("{not json")
    results = []
    for cls, log in ((CamouflageKnowledgeStore, "t.txt"), (JStore, "j.txt")):
        store = cls()
        first = store.ingest_directory(str(folder), processed_log=str(tmp_path / log))
        again = store.ingest_directory(str(folder), processed_log=str(tmp_path / log))
        results.append((store, first, again))
    (tstore2, t_first, t_again), (jstore2, j_first, j_again) = results
    assert t_first == j_first == (20, 1) and t_again == j_again == (0, 1)
    _assert_same_store(tstore2, jstore2)
    (tmp_path / "old.pkl").write_bytes(b"\x80\x04legacy")
    with pytest.raises(ValueError, match="not a JSON KG store"):
        CamouflageKnowledgeStore.load(str(tmp_path / "old.pkl"))


# ---------------------------------------------------------------------------
# Optimizer and model
# ---------------------------------------------------------------------------

def test_adam_l2_matches_optax():
    """Five steps of clip → L2 → Adam at a varying learning rate, with the
    clip active on some steps: parameters within 1e-6 of optax's
    ``make_adam_l2_tx``."""
    rng = np.random.default_rng(3)
    params = {"w": rng.standard_normal((6, 5)).astype(np.float32),
              "b": rng.standard_normal(5).astype(np.float32)}
    tx = make_adam_l2_tx(1e-2)
    state = TrainState(params={k: jnp.asarray(v) for k, v in params.items()}, batch_stats={},
                       opt_state=tx.init(params), step=jnp.zeros((), jnp.int32))
    tparams = {k: torch.nn.Parameter(t(v)) for k, v in params.items()}
    optimizer = make_adam_l2(tparams.values(), 1e-2)
    for step in range(5):
        grads = {k: (rng.standard_normal(v.shape) * (0.05 if step % 2 else 2.0)).astype(np.float32)
                 for k, v in params.items()}
        lr = 1e-2 / (step + 1)
        state = j_apply_updates(tx, state, {k: jnp.asarray(v) for k, v in grads.items()},
                                jnp.asarray(lr, jnp.float32))
        for k, p in tparams.items():
            p.grad = t(grads[k])
        apply_updates(optimizer, lr)
        for k in params:
            np.testing.assert_allclose(tparams[k].detach().numpy(), np.asarray(state.params[k]),
                                       rtol=1e-6, atol=1e-6, err_msg=f"{k} step {step}")


def _kg_batch(seed=4, B=6, bucket=N):
    tstore, _ = _stores(synthetic_annotations(seed))
    subs = create_dataset_from_store(tstore)[:B]
    x, adj, mask, y, _ = featurize.pad_subgraphs(subs, bucket)
    return x, adj, mask, y


def _kg_models(x, adj, mask, hidden=H):
    jmodel = JKG(hidden_channels=hidden, embedding_dim=hidden, dropout=0.0)
    variables = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(adj),
                            jnp.asarray(mask))
    tmodel = KnowledgeGraphGNN(hidden_channels=hidden, embedding_dim=hidden, dropout=0.0)
    tmodel.head_drop.p = 0.0
    tmodel.load_state_dict(knowledge_graph_state_dict(variables["params"],
                                                      variables["batch_stats"]))
    return jmodel, variables, tmodel


def test_kg_model_train_mode_and_gradients_match_jax(no_jax_dropout):
    """Train mode at dropout 0: score and embedding at 1e-5, the updated
    batch statistics at 1e-6, the gradients of the MSE against
    ``jax.grad`` at 1e-5 relative and 1e-5 of the largest entry absolute
    (the GCN biases ahead of a BatchNorm have an exact gradient of zero);
    the weight conversion is exact both ways."""
    x, adj, mask, y = _kg_batch()
    jmodel, variables, tmodel = _kg_models(x, adj, mask)
    back = knowledge_graph_params_from_state_dict(tmodel.state_dict())
    for got, want in zip(back, (variables["params"], variables["batch_stats"])):
        got, want = dict(_leaves(got)), dict(_leaves(want))
        assert set(got) == set(want)
        for key in want:
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)

    def loss_fn(params):
        out, mutated = jmodel.apply(
            {"params": params, "batch_stats": variables["batch_stats"]}, jnp.asarray(x),
            jnp.asarray(adj), jnp.asarray(mask), train=True, mutable=["batch_stats"])
        return jnp.mean((out["score"][:, 0] - jnp.asarray(y)) ** 2), (out, mutated["batch_stats"])

    (jloss, (jout, jstats)), jgrads = jax.value_and_grad(loss_fn, has_aux=True)(variables["params"])
    out = tmodel.train()(t(x), t(adj), t(mask))
    loss = torch.mean((out["score"][:, 0] - t(y)) ** 2)
    loss.backward()
    assert float(loss.detach()) == pytest.approx(float(jloss), rel=1e-5)
    for key in ("score", "embedding"):
        np.testing.assert_allclose(out[key].detach().numpy(), np.asarray(jout[key]),
                                   rtol=1e-5, atol=1e-5, err_msg=key)
    _, stats = knowledge_graph_params_from_state_dict(tmodel.state_dict())
    for key, want in _leaves(jstats):
        np.testing.assert_allclose(dict(_leaves(stats))[key], want, rtol=1e-6, atol=1e-6,
                                   err_msg=key)
    grads_sd = {**tmodel.state_dict(), **{n: p.grad for n, p in tmodel.named_parameters()}}
    got = dict(_leaves(knowledge_graph_params_from_state_dict(grads_sd)[0]))
    want = dict(_leaves(jgrads))
    scale = max(float(np.abs(g).max()) for g in want.values())
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-5, atol=1e-5 * scale, err_msg=key)


def test_kg_model_eval_with_the_committed_checkpoint():
    """``api.load_kg_model`` on ``artifacts/kg_gnn_model.ckpt`` against the
    JAX model with the same variables, in eval mode, at the full width
    (64-node bucket): 1e-5."""
    x, adj, mask, _ = _kg_batch(seed=5, B=8, bucket=64)
    ckpt = j_load_checkpoint(KG_CKPT)
    want = JKG(embedding_dim=int(ckpt["embedding_dim"])).apply(
        {"params": ckpt["params"], "batch_stats": ckpt["batch_stats"]},
        jnp.asarray(x), jnp.asarray(adj), jnp.asarray(mask))
    model = load_kg_model(KG_CKPT, device="cpu")
    assert not model.training
    with torch.no_grad():
        got = model(t(x), t(adj), t(mask))
    for key in ("score", "embedding"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), rtol=1e-5,
                                   atol=1e-5, err_msg=key)


# ---------------------------------------------------------------------------
# The slice as a whole: KGTrainer
# ---------------------------------------------------------------------------

# The GCN biases ahead of a BatchNorm: exact gradient zero, moved by Adam on
# float32 rounding (tests/test_torch_port_train_rg.py says more).
GRADIENT_FREE = {"/gcn1_bias", "/gcn2_bias", "/gcn3_bias"}


def test_kg_trainer_matches_jax_trainer(no_jax_dropout):
    """The JAX ``KGTrainer.fit`` and the port's from the same initial
    weights and split (48 subgraphs: 38 train in 5 steps of 8 with the tail
    window, 10 validation in 2), 4 epochs, dropout 0: per-epoch losses
    within 1e-3 relative, final parameters and running variances within
    1e-3, the gradient-free biases and the running means within 2·lr·steps.
    At lr 3e-4: the biases' noise-driven steps shift the running means
    behind them, which eval mode reads, and at 1e-3 that moved the
    validation loss past the 1e-3 bar."""
    tstore, jstore = _stores(synthetic_annotations(6))
    subs = create_dataset_from_store(tstore)
    epochs, batch, lr = 4, 8, 3e-4
    jtrainer = j_train_kg.KGTrainer(model=JKG(hidden_channels=H, embedding_dim=H, dropout=0.0),
                                    max_nodes=N, learning_rate=lr)
    init = jtrainer.init_state(jax.random.PRNGKey(0))
    jstate, jhist = jtrainer.fit(j_train_kg.create_dataset_from_store(jstore), epochs=epochs,
                                 batch_size=batch, checkpoint_path=None, **QUIET)

    model = KnowledgeGraphGNN(hidden_channels=H, embedding_dim=H, dropout=0.0)
    model.head_drop.p = 0.0
    model.load_state_dict(knowledge_graph_state_dict(init.params, init.batch_stats))
    trainer = KGTrainer(model=model, max_nodes=N, learning_rate=lr)
    _, hist = trainer.fit(subs, epochs=epochs, batch_size=batch, checkpoint_path=None,
                          device="cpu", **QUIET)
    assert set(hist) == set(jhist)
    for key in hist:
        np.testing.assert_allclose(hist[key], jhist[key], rtol=1e-3, err_msg=key)
    drift = 2 * lr * 5 * epochs
    params, stats = knowledge_graph_params_from_state_dict(model.state_dict())
    for key, want in _leaves(jstate.params):
        np.testing.assert_allclose(dict(_leaves(params))[key], want, rtol=0,
                                   atol=drift if key in GRADIENT_FREE else 1e-3, err_msg=key)
    for key, want in _leaves(jstate.batch_stats):
        np.testing.assert_allclose(dict(_leaves(stats))[key], want, rtol=0,
                                   atol=drift if key.endswith("/mean") else 1e-3, err_msg=key)


def test_plateau_rule_on_a_scripted_loss_sequence():
    """Improvements below 1e-8 do not count, the sixth epoch without one
    drops the rate tenfold and resets the counter; a tiny relative
    improvement counts (``ReduceLROnPlateau``'s default threshold would
    not)."""
    losses = [1.0, 0.9, 0.9, 0.9 - 1e-9, 0.95, 0.9, 0.91, 0.92, 0.93, 0.89,
              0.89, 0.89, 0.89, 0.89, 0.89, 0.89, 0.889999]
    lr, plateau, best = 1.0, 0, float("inf")
    lrs, plateaus = [], []
    for loss in losses:
        lr, plateau = plateau_step(loss, best, lr, plateau)
        best = min(best, loss)
        lrs.append(lr)
        plateaus.append(plateau)
    assert plateaus == [0, 0, 1, 2, 3, 4, 5, 0, 1, 0, 1, 2, 3, 4, 5, 0, 0]
    assert lrs == [1.0] * 7 + [0.1] * 8 + [0.1 * 0.1] * 2


def test_kg_trainer_resume_bitmatch(tmp_path):
    """Resume bit-matches an uninterrupted run with dropout on; the learning
    rate and the plateau counter travel in the snapshot."""
    tstore, _ = _stores(synthetic_annotations(7))
    subs = create_dataset_from_store(tstore)
    resume = str(tmp_path / "kg_resume.ckpt")
    kw = dict(batch_size=8, checkpoint_path=None, device="cpu", **QUIET)

    def trainer():
        model = KnowledgeGraphGNN(hidden_channels=H, embedding_dim=H)
        model.reset_parameters(torch.Generator().manual_seed(0))
        return KGTrainer(model=model, max_nodes=N, learning_rate=0.5)

    full_model, full_hist = trainer().fit(subs, epochs=10, **kw)
    trainer().fit(subs, epochs=5, resume_path=resume, **kw)
    from camouflage_multimodal_tpu_torch.core.checkpoint import load_checkpoint
    blob = load_checkpoint(resume)
    assert {"lr", "plateau"} <= set(blob)
    cont_model, cont_hist = trainer().fit(subs, epochs=10, resume_from=resume, **kw)
    assert cont_hist == full_hist
    for (k, a), b in zip(full_model.state_dict().items(), cont_model.state_dict().values()):
        assert torch.equal(a, b), k


def test_port_kg_checkpoint_loads_in_the_jax_package(tmp_path):
    """A port run's best checkpoint read the JAX package's way (its
    ``extract-kg`` command) and by ``api.load_kg_model``: eval outputs equal
    at 1e-5."""
    tstore, _ = _stores(synthetic_annotations(8))
    subs = create_dataset_from_store(tstore)
    ckpt = str(tmp_path / "kg.ckpt")
    _, history = KGTrainer(max_nodes=N).fit(subs, epochs=2, batch_size=16, checkpoint_path=ckpt,
                                            device="cpu", **QUIET)
    blob = j_load_checkpoint(ckpt)
    assert int(blob["embedding_dim"]) == 128 and blob["val_loss"] == min(history["val_loss"])
    x, adj, mask, _, _ = featurize.pad_subgraphs(subs[:8], N)
    want = JKG(embedding_dim=int(blob["embedding_dim"])).apply(
        {"params": blob["params"], "batch_stats": blob["batch_stats"]},
        jnp.asarray(x), jnp.asarray(adj), jnp.asarray(mask))
    with torch.no_grad():
        got = load_kg_model(ckpt, device="cpu")(t(x), t(adj), t(mask))
    for key in ("score", "embedding"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), rtol=1e-5,
                                   atol=1e-5, err_msg=key)


def test_embedding_factory_matches_jax(tmp_path):
    """With the committed checkpoint: per-category embeddings and their
    statistics, the MAE self-test (1e-5) and the separation report; the
    embeddings written by ``save_kg_embeddings`` read back by both
    packages."""
    tstore, jstore = _stores(synthetic_annotations(9))
    ckpt = j_load_checkpoint(KG_CKPT)
    jtrainer = j_train_kg.KGTrainer(max_nodes=64)
    state = TrainState(params=ckpt["params"], batch_stats=ckpt["batch_stats"],
                       opt_state=None, step=0)
    jemb, jstats = jtrainer.batch_extract_embeddings(state, jstore, limit=10)
    model = load_kg_model(KG_CKPT, device="cpu")
    trainer = KGTrainer(model=model, max_nodes=64)
    emb, stats = trainer.batch_extract_embeddings(model, tstore, limit=10)
    assert list(emb) == list(jemb) and len(emb) == len(CATEGORIES)
    for cat in emb:
        assert emb[cat].shape == (1, 128) and emb[cat].dtype == np.float32
        np.testing.assert_allclose(emb[cat], jemb[cat], rtol=1e-5, atol=1e-5, err_msg=cat)
        for key in jstats[cat]:
            assert stats[cat][key] == pytest.approx(jstats[cat][key], rel=1e-4, abs=1e-6)
    maes = trainer.test_model_predictions(model, tstore)
    jmaes = jtrainer.test_model_predictions(state, jstore)
    assert list(maes) == list(jmaes)
    for cat in maes:
        assert maes[cat] == pytest.approx(jmaes[cat], abs=1e-5)
    sims, jsims = compare_embeddings(emb), j_train_kg.compare_embeddings(jemb)
    assert list(sims) == list(jsims)
    for key in sims:
        assert sims[key] == pytest.approx(jsims[key], abs=1e-5)
    assert trainer.extract_category_embedding(model, tstore, "Bird") is None

    path = str(tmp_path / "kg" / "all_embeddings.npz")
    T_data.save_kg_embeddings(path, emb)
    for loaded in (T_data.load_kg_embeddings(path), j_load_kg_embeddings(path)):
        assert list(loaded) == list(emb)
        for cat in emb:
            np.testing.assert_array_equal(loaded[cat], emb[cat])


def test_kg_entry_points_refuse_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    tstore, _ = _stores(synthetic_annotations(10, per_category=2))
    with pytest.raises(RuntimeError, match="is_available"):
        KGTrainer(max_nodes=N).fit(create_dataset_from_store(tstore), epochs=1, **QUIET)
    with pytest.raises(RuntimeError, match="is_available"):
        load_kg_model(KG_CKPT)
