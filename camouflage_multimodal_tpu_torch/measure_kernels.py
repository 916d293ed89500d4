"""Where the time of kernels B1, B2 and B3 goes, beyond what ``chip_smoke.py``
prints. Needs an NVIDIA GPU and ``nvcc``:

    python -m camouflage_multimodal_tpu_torch.measure_kernels

* ``host_parts``: microseconds of host time of one wrapper call at the main
  path's shapes, and of its parts — the input checks, the allocations, the
  pointer arithmetic, the C launcher alone (its launches included) — since
  the calls take less time on the card than the host needs to enqueue them.
  B3 is timed at the training shapes without a cotangent for the attention
  maps, as a train step calls it: through ``torch.autograd``, as the bare
  wrapper, and part by part.
* ``gemm_variant``: device time of each ``proj_kernel`` launch of one B2 call
  per direction, for the kernel as it is (variant 0) and for builds of
  ``csrc/gemm_3xtf32.cuh`` without its mma instructions (1), with its loads
  alone (2) and with its arithmetic alone (3). Each variant is built and run
  in a process of its own; variants 1-3 compute wrong results.

Prints one JSON object per line.
"""

from __future__ import annotations

import json
import importlib
import subprocess
import sys
import time

import torch

from camouflage_multimodal_tpu_torch.core import kernels
from camouflage_multimodal_tpu_torch.ops import attention as A

S = importlib.import_module("camouflage_multimodal_tpu_torch.ops.slic")   # ops.slic is the function

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


def _mha_cases(dev, nodes: int = 640):
    g = torch.Generator(device=dev).manual_seed(0)
    params = {n: (torch.randn(E, E, device=dev, generator=g) / 16 if n[0] == "w"
                  else torch.randn(E, device=dev, generator=g)) for n in A.PARAM_NAMES}
    for nq, nk in ((nodes, 13), (13, nodes)):
        q = torch.randn(BATCH, nq, E, device=dev, generator=g)
        k = torch.randn(BATCH, nk, E, device=dev, generator=g)
        yield params, q, k, torch.ones(BATCH, nk, dtype=torch.bool, device=dev)


class _NoKernel(torch.autograd.Function):
    """An autograd node shaped like ``FusedMHA`` (13 inputs and 5 more saved
    tensors, 2 outputs, 11 gradients) that launches nothing: what
    ``torch.autograd`` itself costs the host around kernel B3."""

    @staticmethod
    def forward(ctx, results, grads, extra, *inputs):
        ctx.save_for_backward(*inputs, *extra)
        ctx.grads = grads
        ctx.set_materialize_grads(False)
        return tuple(t.clone() for t in results)

    @staticmethod
    def backward(ctx, d_out, d_probs):
        ctx.saved_tensors
        d_q, d_k, d_v, *d_weights = ctx.grads
        return (None, None, None, d_q, d_k, d_v, None, *d_weights)


def host_parts(dev) -> None:
    for params, q, k, mask in _mha_cases(dev):
        nq, nk = q.shape[1], k.shape[1]
        pointers = A._check_cuda_inputs(params, q, k, k, HEADS, mask)
        chunks = A._key_chunks(nk, E, HEADS)
        n_q, n_k = q.numel(), k.numel()
        n_attn = BATCH * HEADS * nq * (nk + chunks * (2 + E // HEADS))
        n_stats = 2 * BATCH * HEADS * nq if chunks else 0
        buf = torch.empty(2 * n_q + 2 * n_k + n_stats + n_attn, device=dev)
        out, probs = torch.empty_like(q), torch.empty(BATCH, nq, nk, device=dev)
        lib, base = kernels.library("fused_mha"), buf.data_ptr()
        stream, scale = kernels.stream_handle(q), A._scale(E // HEADS)

        def launcher():
            return lib.fused_mha(*pointers[:3], mask.data_ptr(), *pointers[3:], base,
                                 base + 8 * n_q, base + 8 * n_q + 4 * n_k, base + 4 * n_q,
                                 out.data_ptr(), probs.data_ptr(),
                                 base + 8 * (n_q + n_k) + 4 * n_stats if chunks else None,
                                 base + 8 * (n_q + n_k) if chunks else None, BATCH, nq, nk, E,
                                 E, E, HEADS, HEADS, chunks, scale, stream)

        print(json.dumps({"host_parts": "fused_mha", "nq": nq, "nk": nk,
                          "call_us": _host_us(lambda: A.fused_mha(params, q, k, k, HEADS, mask)),
                          "checks_us": _host_us(lambda: A._check_cuda_inputs(
                              params, q, k, k, HEADS, mask)),
                          "allocations_us": _host_us(lambda: (
                              torch.empty(buf.numel(), dtype=torch.float32, device=dev),
                              torch.empty_like(q),
                              torch.empty((BATCH, nq, nk), dtype=torch.float32, device=dev))),
                          "launcher_us": _host_us(launcher)}), flush=True)

    for params, q, k, mask in _mha_cases(dev, nodes=576):
        nq, nk = q.shape[1], k.shape[1]
        leaves = [t.clone().requires_grad_() for t in (q, k, *(params[n] for n in A.PARAM_NAMES))]
        lq, lk, *lw = leaves
        out, _ = A.fused_mha(dict(zip(A.PARAM_NAMES, lw)), lq, lk, lk, HEADS, mask)
        d_out = torch.randn_like(out)
        weights = [params[n] for n in A.PARAM_NAMES]
        saved = out.grad_fn.saved_tensors[-len(A.SAVED_NAMES):]
        chunks = A._key_chunks(nk, E, HEADS)
        n_scratch = A._bwd_scratch_floats(BATCH, nq, nk, E, HEADS, chunks, E, E)
        sizes = (q.numel(), k.numel(), k.numel()) + (E * E, E) * 4
        scratch = torch.empty(n_scratch, device=dev)
        grads = torch.empty(sum(sizes), device=dev)
        lib, stream = kernels.library("fused_mha_bwd"), kernels.stream_handle(q)
        scale = A._scale(E // HEADS)

        def pointers():
            base, outs = grads.data_ptr(), []
            for n in sizes:
                outs.append(base)
                base += 4 * n
            return (q.data_ptr(), k.data_ptr(), k.data_ptr(), mask.data_ptr(),
                    *(w.data_ptr() for w in weights[::2]), *(t.data_ptr() for t in saved[:4]),
                    saved[4].data_ptr() if chunks else None, d_out.data_ptr(), None,
                    scratch.data_ptr(), n_scratch, *outs)

        args = pointers()
        parts = [g.view(t.shape) for g, t in
                 zip(grads.split_with_sizes(sizes), (q, k, k, *weights))]
        null_out, _ = _NoKernel.apply((out.detach(), out.detach()), parts, saved, lq, lk, lk, mask,
                                      *lw)
        null_leaves = [lq, lk, *lw]
        before = kernels.device_launches("fused_mha_bwd")
        A._launch_backward(q, k, k, mask, weights, saved, HEADS, d_out, None)
        print(json.dumps({
            "host_parts": "fused_mha_bwd", "nq": nq, "nk": nk,
            "kernel_launches": kernels.device_launches("fused_mha_bwd") - before,
            "call_us": _host_us(lambda: torch.autograd.grad([out], leaves, [d_out],
                                                            retain_graph=True)),
            "autograd_alone_us": _host_us(lambda: torch.autograd.grad(
                [null_out], null_leaves, [d_out], retain_graph=True)),
            "wrapper_us": _host_us(lambda: A._launch_backward(q, k, k, mask, weights, saved,
                                                              HEADS, d_out, None)),
            "checks_us": _host_us(lambda: A._check_cotangents(q, nk, d_out, None, E)),
            "allocations_us": _host_us(lambda: (
                torch.empty(n_scratch, dtype=torch.float32, device=dev),
                torch.empty(sum(sizes), dtype=torch.float32, device=dev))),
            "views_us": _host_us(lambda: [g.view(E, E) if g.numel() == E * E else g
                                          for g in grads.split_with_sizes(sizes)]),
            "pointers_us": _host_us(pointers),
            "launcher_us": _host_us(lambda: lib.fused_mha_bwd(
                *args, BATCH, nq, nk, E, E, E, HEADS, HEADS, chunks, scale, stream))}), flush=True)

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
