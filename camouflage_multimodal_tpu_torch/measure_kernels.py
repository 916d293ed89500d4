"""Where the time of kernels B1 and B2 goes, beyond what ``chip_smoke.py``
prints. Needs an NVIDIA GPU and ``nvcc``:

    python -m camouflage_multimodal_tpu_torch.measure_kernels

* ``host_parts``: microseconds of host time of one wrapper call at the main
  path's shapes, and of its parts — the input checks, the allocations, the C
  launcher alone (its launches included) — since both calls take less time on
  the card than the host needs to enqueue them.
* ``gemm_variant``: device time of each ``proj_kernel`` launch of one B2 call
  per direction, for the kernel as it is (variant 0) and for builds of
  ``csrc/gemm_3xtf32.cuh`` without its mma instructions (1), with its loads
  alone (2) and with its arithmetic alone (3). Each variant is built and run
  in a process of its own; variants 1-3 compute wrong results.

Prints one JSON object per line.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import torch

from camouflage_multimodal_tpu_torch.core import kernels
from camouflage_multimodal_tpu_torch.ops import attention as A
from camouflage_multimodal_tpu_torch.ops import slic as S

E, HEADS, BATCH = 256, 8, 4


def _host_us(fn, reps: int = 300) -> float:
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    elapsed = time.perf_counter() - t0
    torch.cuda.synchronize()
    return elapsed / reps * 1e6


def _mha_cases(dev):
    g = torch.Generator(device=dev).manual_seed(0)
    params = {n: (torch.randn(E, E, device=dev, generator=g) / 16 if n[0] == "w"
                  else torch.randn(E, device=dev, generator=g)) for n in A.PARAM_NAMES}
    for nq, nk in ((640, 13), (13, 640)):
        q = torch.randn(BATCH, nq, E, device=dev, generator=g)
        k = torch.randn(BATCH, nk, E, device=dev, generator=g)
        yield params, q, k, torch.ones(BATCH, nk, dtype=torch.bool, device=dev)


def host_parts(dev) -> None:
    for params, q, k, mask in _mha_cases(dev):
        nq, nk = q.shape[1], k.shape[1]
        pointers = A._check_cuda_inputs(params, q, k, k, HEADS, mask)
        chunks = A._key_chunks(nk, E, HEADS)
        n_q, n_k = q.numel(), k.numel()
        n_attn = BATCH * HEADS * nq * (nk + chunks * (2 + E // HEADS))
        buf = torch.empty(2 * n_q + 2 * n_k + n_attn, device=dev)
        out, probs = torch.empty_like(q), torch.empty(BATCH, nq, nk, device=dev)
        lib, base = kernels.library("fused_mha"), buf.data_ptr()
        stream, scale = kernels.stream_handle(q), A._scale(E // HEADS)

        def launcher():
            return lib.fused_mha(*pointers[:3], mask.data_ptr(), *pointers[3:], base,
                                 base + 8 * n_q, base + 8 * n_q + 4 * n_k, base + 4 * n_q,
                                 out.data_ptr(), probs.data_ptr(),
                                 base + 8 * (n_q + n_k) if chunks else None, BATCH, nq, nk, E,
                                 HEADS, chunks, scale, stream)

        print(json.dumps({"host_parts": "fused_mha", "nq": nq, "nk": nk,
                          "call_us": _host_us(lambda: A.fused_mha(params, q, k, k, HEADS, mask)),
                          "checks_us": _host_us(lambda: A._check_cuda_inputs(
                              params, q, k, k, HEADS, mask)),
                          "allocations_us": _host_us(lambda: (
                              torch.empty(buf.numel(), dtype=torch.float32, device=dev),
                              torch.empty_like(q),
                              torch.empty((BATCH, nq, nk), dtype=torch.float32, device=dev))),
                          "launcher_us": _host_us(launcher)}), flush=True)

    pix = torch.rand(BATCH, 256 * 256, 5, device=dev)
    centers = torch.rand(BATCH, 529, 5, device=dev) * 255
    prev = torch.zeros(BATCH, 256 * 256, dtype=torch.int32, device=dev)
    out = torch.empty_like(prev)
    lib, stream = kernels.library("slic_assign"), kernels.stream_handle(pix)
    print(json.dumps({"host_parts": "slic_assign",
                      "call_us": _host_us(lambda: S.slic_assign(pix, centers, prev, 0.8, 11,
                                                                width=256)),
                      "allocations_us": _host_us(lambda: torch.empty_like(prev)),
                      "launcher_us": _host_us(lambda: lib.slic_assign(
                          pix.data_ptr(), centers.data_ptr(), prev.data_ptr(), out.data_ptr(),
                          BATCH, 256, 256, S.TILE_WIDTH, 529, 0.8, 11, stream))}), flush=True)


def gemm_variant(dev, variant: int) -> None:
    from torch.profiler import ProfilerActivity, profile

    kernels.NVCC_FLAGS.append(f"-DGEMM3_VARIANT={variant}")   # part of the library's hash
    cases = list(_mha_cases(dev))
    for params, q, k, mask in cases:
        A.fused_mha(params, q, k, k, HEADS, mask)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            for params, q, k, mask in cases:
                A.fused_mha(params, q, k, k, HEADS, mask)
        torch.cuda.synchronize()
    times = [ev.time_range.elapsed_us() for ev in prof.events() if "proj_kernel" in ev.name]
    # Launch order within one pair of calls: rg2kg QKV, rg2kg out, kg2rg QKV, kg2rg out.
    names = ("rg2kg_qkv_us", "rg2kg_out_us", "kg2rg_qkv_us", "kg2rg_out_us")
    med = {n: sorted(times[i::4])[len(times[i::4]) // 2] for i, n in enumerate(names)}
    print(json.dumps({"gemm_variant": variant, **med}), flush=True)


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("measure_kernels: needs an NVIDIA GPU")
    dev = torch.device("cuda")
    if len(sys.argv) > 1:
        gemm_variant(dev, int(sys.argv[1]))
        return
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(smi.stdout.strip(), flush=True)
    host_parts(dev)
    for variant in range(4):
        subprocess.run([sys.executable, "-m", __spec__.name, str(variant)], check=True)


if __name__ == "__main__":
    main()
