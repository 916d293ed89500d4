"""Open-loop HTTP serving: the program's ``InferenceService`` (micro-batcher
over a ``MultimodalPredictor`` of the seeded checkpoints) behind its own
``make_server`` on 127.0.0.1, driven by ``loadgen.py`` in a process of its
own at the mix's fixed rate.

The schedule comes from the seed: exactly ``rate_per_s · seconds`` arrival
times, uniform order statistics over the window (a Poisson process given
its count, so every seed offers the same work in another order), each with
a seeded body (one of the mix's fixed 1024 × 768 JPEG scenes, resized by
the service) and a heatmap flag with the mix's share. Latency is taken at the client from the
request's due time; a request that fails or never answers counts at the
generator's timeout.

``correct``: requests drawn from the seed (heatmap ones among them) are
compared, after the window, with the plain reference on the same bytes.
"""

from __future__ import annotations

import base64
import http.client
import io
import json
import os
import subprocess
import sys
import threading
from typing import Dict, List

import numpy as np
import torch

import scenes
import weights
from harness import HERE, Check, Outcome, percentile
from reference.pipeline import predict as reference_predict
from tracing import span

BANDS = ((0.35, "HIGHLY CAMOUFLAGED"), (0.20, "MODERATELY CAMOUFLAGED"),
         (0.10, "SLIGHTLY CAMOUFLAGED"))


def band(mean: float) -> str:
    """The four-level classification of a heatmap's mean (the reference's
    ``region_graph/test.py`` bands)."""
    for threshold, name in BANDS:
        if mean > threshold:
            return name
    return "NOT CAMOUFLAGED"


def schedule(ctx, n_bodies: int) -> Dict:
    tr = ctx.traffic
    rng = np.random.default_rng(ctx.seed)
    n = max(1, int(round(tr["rate_per_s"] * ctx.seconds)))
    due = np.sort(rng.uniform(0.0, ctx.seconds, n))
    heat = rng.random(n) < tr["heatmap_share"]
    body = rng.integers(0, n_bodies, n)
    heat_ids, plain_ids = np.flatnonzero(heat), np.flatnonzero(~heat)
    k = tr["sample_requests"]
    keep = np.concatenate([rng.choice(heat_ids, min(len(heat_ids), k // 2), replace=False),
                           rng.choice(plain_ids, min(len(plain_ids), k - k // 2), replace=False)])
    return {"due": due.tolist(), "heatmap": heat.tolist(), "body": body.tolist(),
            "keep": sorted(int(i) for i in keep), "timeout_s": tr["timeout_s"],
            "drain_s": tr["drain_s"]}


def run(ctx) -> Outcome:
    from camouflage_multimodal_tpu_torch.api import MultimodalPredictor
    from camouflage_multimodal_tpu_torch.serve import InferenceService, make_server

    cfg, tr, dev = ctx.config, ctx.traffic, ctx.device
    width, height = tr["scene_size"]
    blobs = scenes.jpeg_bytes(scenes.scenes(ctx.fixed_generator(tr["scene_seed"]), tr["scenes"],
                                            width, height), tr["jpeg_quality"])
    paths = scenes.write_jpegs(os.path.join(ctx.tmp, "bodies"), blobs)
    ctx.phase("inputs")
    ref_rg, ref_fusion, rg_state, fusion_state, kg = weights.models(cfg, ctx.generator(1))
    files = weights.write_checkpoints(ctx.tmp, cfg, rg_state, fusion_state, kg)
    predictor = MultimodalPredictor(*files, n_segments=cfg["slic"]["n_segments"], device=dev)
    ctx.phase("models")
    if predictor.rg_pipeline.image_size != cfg["image_size"]:
        raise ValueError(f"the predictor serves {predictor.rg_pipeline.image_size}², the "
                         f"configuration states {cfg['image_size']}²")
    service = InferenceService(predictor, batch_size=tr["batch_size"],
                               max_wait_ms=tr["max_wait_ms"])
    inner = ctx.wrapped("predict", service.batcher.predict_fn)

    def predict_fn(images):
        with span("predict"):
            return inner(images)

    service.batcher.predict_fn = predict_fn
    service.warmup()
    ctx.phase("warmup")
    server = make_server(service, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    # The HTTP path's first calls (handler, PIL decode, PNG encode) in set-up.
    for query in ("", "?heatmap=1"):
        conn = http.client.HTTPConnection("127.0.0.1", server.server_address[1], timeout=600)
        conn.request("POST", "/predict" + query, body=blobs[0])
        if conn.getresponse().status != 200:
            raise RuntimeError("the service failed its warm-up request")
        conn.close()

    spec = dict(schedule(ctx, len(paths)), bodies=paths)
    spec_path, out_path = (os.path.join(ctx.tmp, n) for n in ("spec.json", "result.json"))
    with open(spec_path, "w") as f:
        json.dump(spec, f)
    gen = subprocess.Popen([sys.executable, str(HERE / "loadgen.py"),
                            "--port", str(server.server_address[1]), "--spec", spec_path,
                            "--out", out_path], stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                           text=True)
    try:
        if gen.stdout.readline().strip() != "ready":
            raise RuntimeError("the load generator did not start")
        ctx.setup_done()
        before = service.batcher.stats()
        with ctx.tracer.window():
            gen.stdin.write("go\n")
            gen.stdin.flush()
            gen.wait(timeout=ctx.seconds + tr["drain_s"] + 60)
        after = service.batcher.stats()
    finally:
        if gen.poll() is None:
            gen.kill()
            gen.wait()
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)
        service.close()
    if gen.returncode != 0:
        raise RuntimeError(f"the load generator exited with {gen.returncode}")
    with open(out_path) as f:
        records = json.load(f)["records"]
    memory = ctx.memory_peak()
    del predictor, service, inner
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    ok = [r is not None and r["status"] == 200 for r in records]
    latency = [1000.0 * (r["done"] - r["due"]) if good else 1000.0 * tr["timeout_s"]
               for r, good in zip(records, ok)]
    in_window = sum(1 for r, good in zip(records, ok) if good and r["done"] <= ctx.seconds)
    e2e = {"request_p50_ms": percentile(latency, 50), "request_p95_ms": percentile(latency, 95),
           "images_per_s": in_window / ctx.seconds}
    calls = after["batches"] - before["batches"]
    half = [r is not None and r["due"] < ctx.seconds / 2 for r in records]
    window = {"calls": calls, "requests": after["requests"] - before["requests"],
              # For the knee sweep (knee.py): how far the generator ran late,
              # the share answered inside the window, and whether the tail grew.
              "late_ms_max": 1000.0 * max((r["late"] for r in records if r), default=0.0),
              "offered": len(records), "completed_in_window": in_window,
              "p95_first_half_ms": percentile([x for x, h in zip(latency, half) if h] or [0.0], 95),
              "p95_second_half_ms": percentile([x for x, h in zip(latency, half) if not h] or [0.0],
                                               95)}
    checks = compare(ctx, spec, records, blobs, ref_rg, ref_fusion, kg)
    return Outcome(attempted=len(records), failed=len(records) - sum(ok), end_to_end=e2e,
                   checks=checks, memory_peak_bytes=memory, window=window)


def compare(ctx, spec: Dict, records: List, blobs: List[bytes], ref_rg, ref_fusion,
            kg) -> List[Check]:
    """The kept responses against the plain reference on the same bytes."""
    from PIL import Image

    cfg, tr, dev = ctx.config, ctx.traffic, ctx.device
    limits, size = tr["limits"], cfg["image_size"]
    keep = spec["keep"]
    got = [(i, records[i]["response"]) for i in keep
           if records[i] is not None and records[i]["status"] == 200]
    worst = {"prob_gap": 0.0, "heatmap_flips": 0.0, "label_flips": 0.0}
    for lo in range(0, len(got), tr["reference_block"]):
        block = got[lo:lo + tr["reference_block"]]
        images = torch.from_numpy(np.stack([scenes.decode(blobs[spec["body"][i]], size)
                                            for i, _ in block])).to(dev)
        ref = reference_predict(images, ref_rg, ref_fusion, kg, cfg["slic"]["n_segments"],
                                cfg["max_nodes"], cfg["slic"]["iterations"])
        ref = {k: v.double().cpu().numpy() for k, v in ref.items()}
        for j, (i, resp) in enumerate(block):
            gaps = [abs(resp["mask_prob"][c] - ref["mask_prob"][j][c]) for c in range(2)]
            gaps += [abs(resp["edge_prob"] - ref["edge_prob"][j][0]),
                     abs(resp["score"] - ref["score"][j][0])]
            worst["prob_gap"] = max(worst["prob_gap"], max(gaps))
            heat = ref["heatmap"][j]
            for key, pred in (("mask_logits", "mask_pred"), ("instance_logits", "instance_pred")):
                logits = ref[key][j]
                if abs(logits[1] - logits[0]) > tr["label_margin"] and \
                        resp[pred] != int(np.argmax(logits)):
                    worst["label_flips"] += 1
            mean = float(heat.astype(np.float32).mean())
            if min(abs(mean - t) for t, _ in BANDS) > tr["label_margin"] and \
                    resp["classification"] != band(mean):
                worst["label_flips"] += 1
            if spec["heatmap"][i]:
                png = Image.open(io.BytesIO(base64.b64decode(resp["heatmap_png_base64"])))
                scaled = heat.astype(np.float32) * np.float32(255.0)
                want = np.clip(scaled, 0, 255).astype(np.uint8)
                # A byte is judged where the reference lies clear of a step
                # boundary: a rounding-sized difference may flip it there.
                clear = np.abs(scaled - np.round(scaled)) > tr["heatmap_margin_lsb"]
                worst["heatmap_flips"] += float((clear & (np.asarray(png) != want)).sum())
    checks = [Check(k, v, limits[k]) for k, v in worst.items()]
    checks.append(Check("requests_missing", float(len(keep) - len(got)), 0.0))
    return checks


# ---------------------------------------------------------------------------
# The control and the faults (readings.py, tests/test_benchmark_controls.py)
# ---------------------------------------------------------------------------

def control(ctx) -> None:
    """The reference in the predictor's place, matrix products in TF32: the
    nearest precision below the configuration's float32."""
    ref_rg, ref_fusion, _, _, kg = weights.models(ctx.config, ctx.generator(1))
    cfg = ctx.config

    def predict(images: np.ndarray):
        prev = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
        try:
            out = reference_predict(torch.from_numpy(images).to(ctx.device), ref_rg, ref_fusion,
                                    kg, cfg["slic"]["n_segments"], cfg["max_nodes"],
                                    cfg["slic"]["iterations"])
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev
        return {k: v.cpu().numpy() for k, v in out.items()}

    ctx.wraps["predict"] = lambda _: predict


def _altered(fn):
    def predict(images):
        out = dict(fn(images))
        out["mask_prob"] = np.array(out["mask_prob"])
        out["mask_prob"][0] = out["mask_prob"][0][::-1]           # one answer swapped
        return out
    return predict


def _half_batch(fn):
    def predict(images):
        if len(images) < 2:
            return fn(images)
        out = fn(images[:len(images) // 2])
        return {k: np.concatenate([v, v]) if isinstance(v, np.ndarray) else v
                for k, v in out.items() if k != "attention"}
    return predict


FAULTS = {
    "answer_altered": lambda ctx: ctx.wraps.__setitem__("predict", _altered),
    "half_batch": lambda ctx: ctx.wraps.__setitem__("predict", _half_batch),
}
