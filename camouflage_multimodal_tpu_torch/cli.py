"""Command-line entry points, port of ``camouflage_multimodal_tpu/cli.py``:
the same ten subcommands, flags, defaults, printed lines and output files,
plus ``--device`` (default ``cuda``, which raises without a card; ``cpu``
runs the plain PyTorch versions) on every subcommand that runs a model.

    python -m camouflage_multimodal_tpu_torch.cli train-rg        ↔ region_graph/train.py
    python -m camouflage_multimodal_tpu_torch.cli extract-rg      ↔ extract_rg_embeddings.py
    python -m camouflage_multimodal_tpu_torch.cli ingest-kg       ↔ ingest_to_neo4j.py (serverless)
    python -m camouflage_multimodal_tpu_torch.cli train-kg        ↔ knowledge_graph/train_model.py
    python -m camouflage_multimodal_tpu_torch.cli extract-kg      ↔ extract_kg_embeddings.py
    python -m camouflage_multimodal_tpu_torch.cli train-fusion    ↔ train_multimodal.py --config ...
    python -m camouflage_multimodal_tpu_torch.cli detect          ↔ region_graph/test.py --image ...
    python -m camouflage_multimodal_tpu_torch.cli test-multimodal ↔ test_multimodal.py
    python -m camouflage_multimodal_tpu_torch.cli evaluate        (batched on-device eval)
    python -m camouflage_multimodal_tpu_torch.cli serve           (micro-batching HTTP server)

``--config`` files need PyYAML and the figures of ``detect`` and
``test-multimodal`` need matplotlib; both are loaded only when used.
``--data-parallel`` on ``train-rg`` and ``train-fusion`` trains over the
ranks of the launcher's process group, one process per card::

    torchrun --nproc-per-node N -m camouflage_multimodal_tpu_torch.cli train-rg ... --data-parallel
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys


def _add_common(p):
    p.add_argument("--config", type=str, default=None, help="YAML config path")


def _add_device(p):
    p.add_argument("--device", default="cuda",
                   help="'cuda' (the default; raises without a card) or 'cpu'")


def _add_data_parallel(p):
    p.add_argument("--data-parallel", action="store_true",
                   help="shard the batch axis over the ranks of the process group "
                        "(one process per card under torchrun; a world of 1 "
                        "without a launcher); batch size must divide")


@contextlib.contextmanager
def _maybe_mesh(args):
    """The ``--data-parallel`` mesh (None without the flag): joins the
    launcher's process group, lays a (data, model=1) mesh over it, prints
    the JAX CLI's line and tears the group down when the command ends."""
    if not getattr(args, "data_parallel", False):
        yield None
        return
    from camouflage_multimodal_tpu_torch.core.device import resolve_device
    from camouflage_multimodal_tpu_torch.parallel import distributed
    from camouflage_multimodal_tpu_torch.parallel.sharding import make_mesh, mesh_shape

    device = resolve_device(args.device)
    distributed.initialize(device=device.type)
    try:
        mesh = make_mesh(device, model_axis=1)
        print(f"data-parallel over {mesh.size()} device(s): mesh {mesh_shape(mesh)}")
        yield mesh
    finally:
        distributed.shutdown()


def cmd_train_rg(args):
    from camouflage_multimodal_tpu_torch.core.config import load_config
    from camouflage_multimodal_tpu_torch.data.cod10k import CODDataset
    from camouflage_multimodal_tpu_torch.train.train_rg import RGTrainer

    cfg = load_config(args.config)
    ds = CODDataset(args.image_dir or cfg["image_dir"],
                    args.mask_dir or cfg["mask_dir"],
                    args.instance_dir or cfg["instance_dir"],
                    args.edge_dir or cfg["edge_dir"],
                    image_size=cfg["rg"]["image_size"])
    print(f"Found {len(ds)} valid image-mask-instance-edge quadruples")
    trainer = RGTrainer(n_segments=cfg["rg"]["n_segments"],
                        max_nodes=cfg["rg"]["max_nodes"],
                        learning_rate=args.lr, weight_decay=1e-4)
    with _maybe_mesh(args) as mesh:
        trainer.fit(ds, epochs=args.epochs, batch_size=args.batch_size,
                    train_split=cfg["train_split"], seed=cfg["seed"],
                    checkpoint_path=args.output,
                    resume_from=args.resume_from, resume_path=args.resume_path,
                    mesh=mesh, device=args.device)


def cmd_extract_rg(args):
    from camouflage_multimodal_tpu_torch.api import load_rg_model
    from camouflage_multimodal_tpu_torch.extract import batch_extract_embeddings
    from camouflage_multimodal_tpu_torch.pipeline import RegionGraphPipeline

    pipeline = RegionGraphPipeline(load_rg_model(args.model, args.device),
                                   n_segments=args.n_segments)
    _, summary = batch_extract_embeddings(
        pipeline, args.image_dir, args.output,
        max_images=args.max_images, batch_size=args.batch_size,
        save_individual=args.save_individual)
    pt = summary["processing_time"]
    print(f"done: {pt['successful_images']} images, "
          f"{pt['avg_per_image']:.3f}s/image")


def cmd_ingest_kg(args):
    from camouflage_multimodal_tpu_torch.kg.store import CamouflageKnowledgeStore

    # A rerun skips the files its log names, so it resumes the store it wrote
    # (the JAX command starts empty and saves a store without them).
    resume = (args.processed_log and os.path.exists(args.processed_log)
              and os.path.exists(args.output))
    store = CamouflageKnowledgeStore.load(args.output) if resume else CamouflageKnowledgeStore()
    ok, failed = store.ingest_directory(args.annotations,
                                        processed_log=args.processed_log)
    store.save(args.output)
    print(f"Complete! Success: {ok}, Failed: {failed} → {args.output}")


def cmd_train_kg(args):
    from camouflage_multimodal_tpu_torch.kg.store import CamouflageKnowledgeStore
    from camouflage_multimodal_tpu_torch.train.train_kg import (
        KGTrainer, create_dataset_from_store)

    store = CamouflageKnowledgeStore.load(args.store)
    dataset = create_dataset_from_store(store, limit_per_category=args.limit)
    print(f"Created {len(dataset)} samples")
    trainer = KGTrainer(max_nodes=args.max_nodes)
    trainer.fit(dataset, epochs=args.epochs, batch_size=args.batch_size,
                checkpoint_path=args.output,
                resume_from=args.resume_from, resume_path=args.resume_path,
                device=args.device)


def cmd_extract_kg(args):
    from camouflage_multimodal_tpu_torch.api import load_kg_model
    from camouflage_multimodal_tpu_torch.core.artifacts import save_kg_embeddings
    from camouflage_multimodal_tpu_torch.kg.store import CamouflageKnowledgeStore
    from camouflage_multimodal_tpu_torch.train.train_kg import KGTrainer, compare_embeddings

    store = CamouflageKnowledgeStore.load(args.store)
    model = load_kg_model(args.model, args.device)
    trainer = KGTrainer(model=model, max_nodes=args.max_nodes)

    maes = trainer.test_model_predictions(model, store)
    for cat, mae in maes.items():
        print(f"  {cat}: MAE {mae:.4f}")

    embeddings, stats = trainer.batch_extract_embeddings(model, store, limit=args.limit)
    os.makedirs(args.output, exist_ok=True)
    save_kg_embeddings(os.path.join(args.output, "all_embeddings.npz"), embeddings)
    with open(os.path.join(args.output, "embedding_stats.json"), "w") as f:
        json.dump(stats, f, indent=2)
    with open(os.path.join(args.output, "summary.json"), "w") as f:
        json.dump({
            "num_categories": len(embeddings),
            "embedding_dim": 128,
            "categories": list(embeddings.keys()),
            "model_path": args.model,
        }, f, indent=2)
    sims = compare_embeddings(embeddings)
    if sims:
        avg = sum(sims.values()) / len(sims)
        print(f"Average embedding similarity: {avg:.4f}")


def cmd_train_fusion(args):
    from camouflage_multimodal_tpu_torch.core.config import load_config
    from camouflage_multimodal_tpu_torch.data.matcher import EmbeddingMatcher
    from camouflage_multimodal_tpu_torch.train.train_fusion import FusionDataset, FusionTrainer

    cfg = load_config(args.config)
    matcher = EmbeddingMatcher(cfg["rg_embeddings_path"], cfg["kg_embeddings_path"])
    matched = matcher.create_matched_dataset(cfg["use_all_kg_categories"])
    dataset = FusionDataset(matched, cfg["mask_dir"], cfg["instance_dir"],
                            cfg["edge_dir"], augment=True)
    print(f"Dataset: {len(dataset)} samples")
    trainer = FusionTrainer(model_config=cfg["model"],
                            learning_rate=cfg["learning_rate"],
                            weight_decay=cfg["weight_decay"],
                            task_weights=cfg["task_weights"],
                            balanced=bool(args.balanced or cfg.get("balanced", False)))
    os.makedirs(cfg["checkpoint_dir"], exist_ok=True)
    # The JAX ``use_scan`` epochs (``_fit_scan``: the padded dataset on the
    # device, batches gathered there) are the port's ``device_resident``
    # epochs; the host loop is the JAX ``_fit_loop``.
    with _maybe_mesh(args) as mesh:
        trainer.fit(dataset, epochs=cfg["epochs"], batch_size=cfg["batch_size"],
                    train_split=cfg["train_split"], seed=cfg["seed"],
                    checkpoint_dir=cfg["checkpoint_dir"], config=cfg,
                    device_resident=bool(cfg.get("use_scan", len(dataset) >= 512)),
                    resume_from=args.resume_from, resume_path=args.resume_path,
                    mesh=mesh, device=args.device)


def cmd_detect(args):
    from camouflage_multimodal_tpu_torch.api import detect_camouflage

    heatmap, mean_score, classification, metrics = detect_camouflage(
        args.image, args.model, args.output, args.mask,
        n_segments=args.n_segments, image_size=args.image_size,
        paint_mapping=args.paint_mapping, device=args.device)
    print(f"Mean score: {mean_score:.4f}  →  {classification}")
    if metrics:
        for k in ("iou", "dice", "precision", "recall", "f1", "mae",
                  "s_measure", "e_measure"):
            print(f"  {k}: {metrics[k]:.4f}")


def cmd_test_multimodal(args):
    from camouflage_multimodal_tpu_torch.api import MultimodalPredictor, test_image_directory
    from camouflage_multimodal_tpu_torch.data.cod10k import load_image_rgb

    predictor = MultimodalPredictor(args.checkpoint, args.rg_model, args.kg_embeddings,
                                    device=args.device)
    os.makedirs(args.output, exist_ok=True)
    if args.image:
        from camouflage_multimodal_tpu_torch.viz import multimodal_panel

        predictions, attn, kg_ordered = predictor.predict_single_image(args.image)
        label = predictions["mask_pred"]
        print(f"Prediction: {'CAMOUFLAGED' if label == 1 else 'NOT CAMOUFLAGED'}")
        print(f"Camouflaged Prob: {predictions['mask_prob'][1]:.2%}")
        print(f"Score: {predictions['score']:.3f}")
        image = load_image_rgb(args.image)
        multimodal_panel(image, predictions,
                         {"rg2kg": attn["rg2kg"]} if attn else None, kg_ordered,
                         os.path.join(args.output,
                                      f"prediction_{os.path.basename(args.image)}"),
                         os.path.basename(args.image))
    elif args.image_dir:
        results = test_image_directory(predictor, args.image_dir, args.output,
                                       max_images=args.max_images,
                                       save_figures=args.save_figures)
        camo = sum(r["pred_label"] for r in results)
        print(f"Total: {len(results)}  Camouflaged: {camo}  "
              f"Not: {len(results) - camo}")
    else:
        print("Provide --image or --image-dir", file=sys.stderr)
        sys.exit(1)


def cmd_evaluate(args):
    from camouflage_multimodal_tpu_torch.api import evaluate_directory

    metrics = evaluate_directory(args.model, args.image_dir, args.gt_dir,
                                 max_images=args.max_images,
                                 batch_size=args.batch_size, device=args.device)
    print(json.dumps(metrics, indent=2))


def cmd_serve(args):
    from camouflage_multimodal_tpu_torch.serve import serve_forever

    serve_forever(args.checkpoint, args.rg_model, args.kg_embeddings,
                  host=args.host, port=args.port, batch_size=args.batch_size,
                  max_wait_ms=args.max_wait_ms, n_segments=args.n_segments,
                  device=args.device)


def _add_resume(p):
    """Mid-training resume (params + opt state + epoch + RNG; beyond the
    reference, which could only restart from scratch)."""
    p.add_argument("--resume-path", default=None,
                   help="write a full train-state snapshot here every epoch")
    p.add_argument("--resume-from", default=None,
                   help="continue training from a --resume-path snapshot")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="camouflage_multimodal_tpu_torch")
    sub = parser.add_subparsers(dest="command", required=True)

    p = sub.add_parser("train-rg")
    _add_common(p)
    _add_resume(p)
    p.add_argument("--image-dir", default=None)
    p.add_argument("--mask-dir", default=None)
    p.add_argument("--instance-dir", default=None)
    p.add_argument("--edge-dir", default=None)
    p.add_argument("--epochs", type=int, default=30)
    p.add_argument("--batch-size", type=int, default=4)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--output", default="best_model.ckpt")
    _add_data_parallel(p)
    _add_device(p)
    p.set_defaults(func=cmd_train_rg)

    p = sub.add_parser("extract-rg")
    p.add_argument("--model", default="best_model.ckpt")
    p.add_argument("--image-dir", required=True)
    p.add_argument("--output", default="rg_embeddings")
    p.add_argument("--n-segments", type=int, default=500)
    p.add_argument("--max-images", type=int, default=None)
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--save-individual", action="store_true",
                   help="also write per-image <name>_embedding.npz artifacts")
    _add_device(p)
    p.set_defaults(func=cmd_extract_rg)

    p = sub.add_parser("ingest-kg")
    p.add_argument("--annotations", required=True)
    p.add_argument("--output", default="kg_store.json")
    p.add_argument("--processed-log", default="processed_files.txt")
    p.set_defaults(func=cmd_ingest_kg)

    p = sub.add_parser("train-kg")
    p.add_argument("--store", default="kg_store.json")
    p.add_argument("--epochs", type=int, default=50)
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--limit", type=int, default=50)
    p.add_argument("--max-nodes", type=int, default=64)
    p.add_argument("--output", default="kg_gnn_model.ckpt")
    _add_resume(p)
    _add_device(p)
    p.set_defaults(func=cmd_train_kg)

    p = sub.add_parser("extract-kg")
    p.add_argument("--model", default="kg_gnn_model.ckpt")
    p.add_argument("--store", default="kg_store.json")
    p.add_argument("--output", default="kg_embeddings")
    p.add_argument("--limit", type=int, default=10)
    p.add_argument("--max-nodes", type=int, default=64)
    _add_device(p)
    p.set_defaults(func=cmd_extract_kg)

    p = sub.add_parser("train-fusion")
    _add_common(p)
    _add_resume(p)
    p.add_argument("--balanced", action="store_true",
                   help="replace the reference's hard-coded class-1 oversample "
                        "boost + focal alpha with data-driven inverse-frequency "
                        "forms (fixes the class-0 collapse on CAM-majority data)")
    _add_data_parallel(p)
    _add_device(p)
    p.set_defaults(func=cmd_train_fusion)

    p = sub.add_parser("detect")
    p.add_argument("--image", "-i", required=True)
    p.add_argument("--model", "-m", default="best_model.ckpt")
    p.add_argument("--mask", default=None)
    p.add_argument("--output", "-o", default="results")
    # beyond-reference knobs (the reference hardcodes 500 segments / 256²)
    p.add_argument("--n-segments", type=int, default=500)
    p.add_argument("--image-size", type=int, default=256)
    p.add_argument("--paint-mapping", choices=("corrected", "verbatim"),
                   default="corrected",
                   help="'verbatim' reproduces the reference's off-by-one "
                        "heatmap paint-back (test.py:241-244) bug-compatibly")
    _add_device(p)
    p.set_defaults(func=cmd_detect)

    p = sub.add_parser("test-multimodal")
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--rg-model", default="best_model.ckpt")
    p.add_argument("--kg-embeddings", default="kg_embeddings/all_embeddings.npz")
    p.add_argument("--image", default=None)
    p.add_argument("--image-dir", default=None)
    p.add_argument("--output", default="results")
    p.add_argument("--max-images", type=int, default=None)
    p.add_argument("--save-figures", action="store_true")
    _add_device(p)
    p.set_defaults(func=cmd_test_multimodal)

    p = sub.add_parser("evaluate")
    p.add_argument("--model", default="best_model.ckpt")
    p.add_argument("--image-dir", required=True)
    p.add_argument("--gt-dir", required=True)
    p.add_argument("--max-images", type=int, default=None)
    p.add_argument("--batch-size", type=int, default=16)
    _add_device(p)
    p.set_defaults(func=cmd_evaluate)

    p = sub.add_parser("serve", help="HTTP inference server with "
                                     "micro-batching (POST /predict)")
    p.add_argument("--checkpoint", required=True,
                   help="fusion checkpoint (.ckpt or reference .pth)")
    p.add_argument("--rg-model", default="best_model.ckpt")
    p.add_argument("--kg-embeddings", default="kg_embeddings/all_embeddings.npz")
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--batch-size", type=int, default=8,
                   help="largest device batch; requests coalesce into it")
    p.add_argument("--max-wait-ms", type=float, default=5.0,
                   help="max coalescing wait after the first request")
    p.add_argument("--n-segments", type=int, default=500)
    _add_device(p)
    p.set_defaults(func=cmd_serve)
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)
    args.func(args)


if __name__ == "__main__":
    main()
