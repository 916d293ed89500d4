"""Cross-validate the port's SLIC + connectivity against recorded node counts.

Port of the JAX system's ``scripts/slic_node_crossval.py``. The reference
ships per-image ``num_nodes`` of its own skimage run
(``slic(n_segments=500, compactness=10, sigma=1)`` at 256²) in its
``embedding_summary.json``; this script compares against them

* the port's component count (:func:`counts`: ``ops.slic`` with
  ``backend="exact"``, kernel B1 on the card, and the per-pixel
  connectivity pass, at 256² in batches), under the JAX report's key
  ``jax_vs_skimage``;
* the numpy reference port's count (``tools/reference_pipeline.slic_np``,
  the fidelity gate's reference side), under ``npport_vs_skimage``.

Any JSON of that format works as ``REF_SUMMARY``
(``{"images": {"<name>.jpg": {"num_nodes": n}}}``), with the images in
``IMG_DIR``; both default to the reference checkout's layout relative to
the working directory. Writes ``slic_node_crossval.json`` under
``--out`` (default ``artifacts/torch_port/``).

    python -m camouflage_multimodal_tpu_torch.scripts.slic_node_crossval \\
        [--sample N] [--np-sample 60] [--batch-size 16] [--out DIR]
"""

from __future__ import annotations

import argparse
import json
import os
import time
from collections import defaultdict

import numpy as np
import torch

from camouflage_multimodal_tpu_torch.core.device import resolve_device
from camouflage_multimodal_tpu_torch.data.cod10k import load_image_rgb
from camouflage_multimodal_tpu_torch.scripts import fidelity_gate as gate
from camouflage_multimodal_tpu_torch.scripts.fidelity_gate import category_of

REF_SUMMARY = os.path.join("models", "region_graph", "rg_embeddings",
                           "embedding_summary.json")
IMG_DIR = os.path.join(gate.REF_DATA, "images")
OUT_NAME = "slic_node_crossval.json"


def counts(names, batch_size: int = 16, device: str | torch.device = "cuda"):
    """name → number of connected segments of the port's SLIC at 256²,
    500 segments."""
    from camouflage_multimodal_tpu_torch.ops.slic import slic

    dev = resolve_device(device)
    out = {}
    t0 = time.time()
    for i in range(0, len(names), batch_size):
        chunk = names[i: i + batch_size]
        imgs = np.stack([(load_image_rgb(os.path.join(IMG_DIR, n), 256) * 255.0)
                         .round().astype(np.uint8) for n in chunk])
        x = torch.from_numpy(imgs).to(dev).float() / 255.0
        seg = slic(x, n_segments=500, backend="exact")
        for n, v in zip(chunk, (seg.amax(dim=(1, 2)) + 1).tolist()):
            out[n] = int(v)
        if (i // batch_size) % 25 == 0:
            done = i + len(chunk)
            rate = done / max(time.time() - t0, 1e-9)
            print(f"  port {done}/{len(names)} ({rate:.1f} img/s)", flush=True)
    return out


def np_counts(names):
    gate.reference_side()
    from reference_pipeline import slic_np

    out = {}
    for i, n in enumerate(names):
        seg = slic_np(load_image_rgb(os.path.join(IMG_DIR, n), 256), n_segments=500)
        out[n] = int(len(np.unique(seg)))
        if i % 10 == 0:
            print(f"  np {i}/{len(names)}", flush=True)
    return out


def summarize(deltas_by_name, ref):
    names = sorted(deltas_by_name)
    d = np.array([deltas_by_name[n] for n in names])
    per_cat = defaultdict(list)
    for n in names:
        per_cat[category_of(n)].append(deltas_by_name[n])
    return {
        "n_images": len(names),
        "median_abs_delta": float(np.median(np.abs(d))),
        "mean_delta": float(d.mean()),
        "mean_abs_delta": float(np.abs(d).mean()),
        "p90_abs_delta": float(np.percentile(np.abs(d), 90)),
        "max_abs_delta": int(np.abs(d).max()),
        "pct_within_2": float((np.abs(d) <= 2).mean() * 100),
        "pct_within_5": float((np.abs(d) <= 5).mean() * 100),
        "pct_within_10": float((np.abs(d) <= 10).mean() * 100),
        "per_category": {
            c: {"n": len(v),
                "median_abs_delta": float(np.median(np.abs(v))),
                "mean_delta": float(np.mean(v)),
                "pct_within_5": float((np.abs(np.array(v)) <= 5).mean() * 100)}
            for c, v in sorted(per_cat.items())
        },
    }


def interleaved(names, n: int):
    stride = max(len(names) // n, 1)
    return names[::stride][:n]


def main(argv=None, device: str | torch.device = "cuda") -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sample", type=int, default=0,
                    help="interleaved sample size for the port's comparison (0 = all)")
    ap.add_argument("--np-sample", type=int, default=60,
                    help="interleaved sample size for the numpy-port comparison "
                         "(slow host loop)")
    ap.add_argument("--batch-size", type=int, default=16)
    ap.add_argument("--out", default=gate.OUT, help="output root (default: %(default)s)")
    args = ap.parse_args(argv)

    with open(REF_SUMMARY) as f:
        ref = {k: v["num_nodes"] for k, v in json.load(f)["images"].items()}
    all_names = sorted(ref)
    names = interleaved(all_names, args.sample) if args.sample else all_names

    print(f"port pipeline over {len(names)} images ...", flush=True)
    pc = counts(names, args.batch_size, device)
    report = {
        "reference_source": REF_SUMMARY,
        "protocol": ("PIL bicubic 256^2 decode -> slic(n_segments=500, "
                     "compactness=10, sigma=1) -> count sequential labels; "
                     "reference counts are the recorded ones of REF_SUMMARY"),
        "notes": ("jax_vs_skimage holds the port's counts (ops.slic, "
                  f"backend='exact', on {resolve_device(device).type}); "
                  "npport_vs_skimage the numpy reference port's."),
        "jax_vs_skimage": summarize({n: pc[n] - ref[n] for n in names}, ref),
    }

    if args.np_sample:
        np_names = interleaved(all_names, args.np_sample)
        print(f"numpy reference port over {len(np_names)} images ...", flush=True)
        nc = np_counts(np_names)
        report["npport_vs_skimage"] = summarize({n: nc[n] - ref[n] for n in np_names}, ref)

    os.makedirs(args.out, exist_ok=True)
    path = os.path.join(args.out, OUT_NAME)
    with open(path, "w") as f:
        json.dump(report, f, indent=2)
    print(json.dumps({k: v for k, v in report["jax_vs_skimage"].items()
                      if k != "per_category"}, indent=2))
    print(f"wrote {path}")
    return report


if __name__ == "__main__":
    main()
