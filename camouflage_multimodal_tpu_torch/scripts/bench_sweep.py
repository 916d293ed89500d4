"""Re-runnable bench sweep over the JAX bench sweep's rows.

Port of the JAX system's ``scripts/bench_sweep.py``: runs
``python -m camouflage_multimodal_tpu_torch.bench`` in a fresh subprocess
per (image size, batch) row and prints each row's dict, the JAX sweep's
keys; ``--out`` writes them all as one JSON document (nothing is written
without it: ``artifacts/bench_sweep.json`` is the JAX system's record).

    python -m camouflage_multimodal_tpu_torch.scripts.bench_sweep [--device cuda|cpu] \\
        [--image-dir DIR] [--out PATH]

The other knobs (``BENCH_ITERS``, ``BENCH_E2E_PASSES``, ...) pass through
the environment to every row.
"""

from __future__ import annotations

import argparse
import datetime
import json
import os
import subprocess
import sys
from typing import Dict, Mapping, Optional, Sequence

ROWS = [(256, 16), (352, 16), (352, 32), (416, 16)]
REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def bench_line(size: int, batch: int, device: str = "cuda",
               image_dir: Optional[str] = None,
               env: Optional[Mapping[str, str]] = None, timeout: float = 3600) -> Dict:
    """The bench's JSON line for one row, from a fresh process."""
    env = dict(os.environ if env is None else env,
               BENCH_IMAGE_SIZE=str(size), BENCH_BATCH=str(batch))
    env["PYTHONPATH"] = os.pathsep.join(p for p in (REPO, env.get("PYTHONPATH")) if p)
    cmd = [sys.executable, "-m", "camouflage_multimodal_tpu_torch.bench", "--device", device]
    if image_dir is not None:
        cmd += ["--image-dir", image_dir]
    out = subprocess.run(cmd, env=env, capture_output=True, text=True, timeout=timeout)
    if out.returncode != 0:
        raise RuntimeError(f"bench at {size}x{size}, batch {batch} exited "
                           f"{out.returncode}:\n{out.stderr[-4000:]}")
    return json.loads([ln for ln in out.stdout.splitlines() if ln.startswith("{")][-1])


def row_of(size: int, batch: int, r: Mapping) -> Dict:
    """The JAX sweep's row dict of one bench line."""
    return {
        "image_size": size,
        "batch": batch,
        "e2e_imgs_per_sec": r["value"],
        "e2e_vs_baseline": r["vs_baseline"],
        "e2e_median_imgs_per_sec": r.get("e2e_median_imgs_per_sec"),
        "device_only_imgs_per_sec": r["device_only_imgs_per_sec"],
        "p50_per_image_ms": r["p50_per_image_ms"],
        "p50_batch1_ms": r["p50_batch1_ms"],
        "draft_decode_imgs_per_sec": r.get("draft_decode_imgs_per_sec"),
    }


def run_row(size: int, batch: int, **kw) -> Dict:
    row = row_of(size, batch, bench_line(size, batch, **kw))
    print(json.dumps(row), flush=True)
    return row


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--image-dir", default=None,
                    help="directory of *.jpg (default: none, the seeded images)")
    ap.add_argument("--out", default=None, help="write the rows here as JSON")
    args = ap.parse_args(argv)
    rows = [run_row(s, b, device=args.device, image_dir=args.image_dir) for s, b in ROWS]
    doc = {
        "description": ("camouflage_multimodal_tpu_torch.bench over the JAX bench "
                        "sweep's rows (end to end = PIL decode | pinned upload on its "
                        "own stream | compute; every timed batch ends in a "
                        "device->host pull; reference anchor 2.2161 s/image)"),
        "date": str(datetime.date.today()),
        "generated_by": "camouflage_multimodal_tpu_torch/scripts/bench_sweep.py",
        "device": args.device,
        "rows": rows,
    }
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(doc, f, indent=2)
        print(f"wrote {args.out}")
    return doc


if __name__ == "__main__":
    main()
