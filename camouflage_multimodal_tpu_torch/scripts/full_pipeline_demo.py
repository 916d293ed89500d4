"""Full-chain demo: the trained RG model → RG embeddings → KG ingest → KG
train → KG embeddings → fusion train → batch multimodal inference, each
step on the previous steps' files.

Port of the JAX system's ``scripts/full_pipeline_demo.sh``: its six steps in
its order, with its arguments, through the port's CLI (``cli.main``), and
its banners. A step that fails stops the run with its exception (the
script's ``set -e``); nothing is caught or skipped.

Inputs derive from ``--reference``, a checkout of the reference in its
layout (default: the working directory): ``data/COD10K/images`` and the
``gt_object``, ``gt_instance`` and ``gt_edge`` directories beside it,
``models/knowledge_graph/annotations`` and ``test_images``. Steps 1 and 6
use the repo's committed ``artifacts/rg_model.ckpt``. Every output, the
fusion config included, goes under ``--out`` (default
``artifacts/torch_port/demo``) with the shell script's file names; nothing
else is written.

    python -m camouflage_multimodal_tpu_torch.scripts.full_pipeline_demo \\
        [--reference DIR] [--max-images 256] [--kg-epochs 20] \\
        [--fusion-epochs 12] [--test-images 8] [--no-save-figures] \\
        [--device cuda] [--out DIR]
"""

from __future__ import annotations

import argparse
import json
import os

import torch

from camouflage_multimodal_tpu_torch import cli
from camouflage_multimodal_tpu_torch.scripts import fidelity_gate as gate

RG_MODEL = os.path.join(gate.COMMITTED, "rg_model.ckpt")
OUT = os.path.join(gate.OUT, "demo")


def main(argv=None, device: str | torch.device = "cuda") -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0],
                                 formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    ap.add_argument("--reference", default=".",
                    help="the reference checkout (COD10K, annotations, test images)")
    ap.add_argument("--max-images", type=int, default=256, help="step 1's images")
    ap.add_argument("--kg-epochs", type=int, default=20, help="step 3's epochs")
    ap.add_argument("--fusion-epochs", type=int, default=12, help="step 5's epochs")
    ap.add_argument("--test-images", type=int, default=8, help="step 6's images")
    ap.add_argument("--save-figures", action=argparse.BooleanOptionalAction, default=True,
                    help="step 6's figures (they need matplotlib)")
    ap.add_argument("--device", default=str(device),
                    help="'cuda' (raises without a card) or 'cpu'")
    ap.add_argument("--out", default=OUT, help="output root")
    args = ap.parse_args(argv)

    from camouflage_multimodal_tpu_torch.core.device import resolve_device

    resolve_device(args.device)
    ref, out, dev = args.reference, args.out, ["--device", args.device]
    cod10k = os.path.join(ref, "data", "COD10K")
    rg_dir = os.path.join(out, "rg_embeddings")
    store = os.path.join(out, "kg_store.pkl")
    kg_model = os.path.join(out, "kg_gnn_model.ckpt")
    kg_dir = os.path.join(out, "kg_embeddings")
    kg_embeddings = os.path.join(kg_dir, "all_embeddings.npz")
    checkpoints = os.path.join(out, "checkpoints")
    config = os.path.join(out, "fusion_config.yaml")
    os.makedirs(out, exist_ok=True)

    print(f"=== [1/6] extract RG embeddings ({args.max_images} images, trained model) ===",
          flush=True)
    cli.main(["extract-rg", "--model", RG_MODEL, "--image-dir", os.path.join(cod10k, "images"),
              "--output", rg_dir, "--max-images", str(args.max_images),
              "--batch-size", "16"] + dev)

    print("=== [2/6] ingest full KG ===", flush=True)
    cli.main(["ingest-kg", "--annotations",
              os.path.join(ref, "models", "knowledge_graph", "annotations"),
              "--output", store, "--processed-log", os.path.join(out, "processed_files.txt")])

    print("=== [3/6] train KG GNN ===", flush=True)
    cli.main(["train-kg", "--store", store, "--epochs", str(args.kg_epochs),
              "--output", kg_model] + dev)

    print("=== [4/6] extract KG category embeddings ===", flush=True)
    cli.main(["extract-kg", "--model", kg_model, "--store", store, "--output", kg_dir] + dev)

    print("=== [5/6] train fusion ===", flush=True)
    # The shell script's config; a JSON string is a YAML string.
    with open(config, "w") as f:
        for key, value in (("rg_embeddings_path", os.path.join(rg_dir, "all_rg_embeddings.npz")),
                           ("kg_embeddings_path", kg_embeddings),
                           ("mask_dir", os.path.join(cod10k, "gt_object")),
                           ("instance_dir", os.path.join(cod10k, "gt_instance")),
                           ("edge_dir", os.path.join(cod10k, "gt_edge")),
                           ("checkpoint_dir", checkpoints),
                           ("epochs", args.fusion_epochs), ("batch_size", 8)):
            f.write(f"{key}: {json.dumps(value)}\n")
    cli.main(["train-fusion", "--config", config] + dev)

    print("=== [6/6] batch multimodal inference on test images ===", flush=True)
    cli.main(["test-multimodal", "--checkpoint",
              os.path.join(checkpoints, "multimodal_best_fixed.ckpt"), "--rg-model", RG_MODEL,
              "--kg-embeddings", kg_embeddings, "--image-dir", os.path.join(ref, "test_images"),
              "--max-images", str(args.test_images), "--output", os.path.join(out, "results")]
             + (["--save-figures"] if args.save_figures else []) + dev)
    print("=== DONE ===", flush=True)


if __name__ == "__main__":
    main()
