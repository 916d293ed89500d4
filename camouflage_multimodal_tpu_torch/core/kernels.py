"""Build, load and count the hand-written CUDA kernels of ``csrc/``.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, loaded through ``ctypes`` (no
PyTorch headers: a build takes seconds, not minutes). Libraries land in
``_build/`` beside this package, named by a hash of their sources and flags,
so a changed source never loads a stale library. Builds happen at first use
— or all at once, one ``nvcc`` per source started together, through
:func:`build_all` — and never when a module is imported.

``LAUNCHES`` holds one plain integer per kernel; each wrapper adds one where
it launches its kernel and nowhere else, so a run can show that the main
path went through the kernels. Each library also counts the CUDA kernels it
has launched (:func:`device_launches`): one wrapper call of the attention
kernels is several of those.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, Sequence

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
KERNELS = ("slic_assign", "fused_mha", "fused_mha_bwd", "canny_hysteresis")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

LAUNCHES: Dict[str, int] = {name: 0 for name in KERNELS}

_P, _I, _F, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
# C signature of each library's launcher (pointers, then sizes, then stream).
_SIGNATURES = {
    # pix, centers, prev, out, batch, height, width, tile_w, k, ratio, step,
    # stream
    "slic_assign": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _I, _P],
    # q, k, v, mask, wq, bq, wk, bk, wv, bv, wo, bo (or null), qp, kp, vp,
    # ctx, out, probs, attn_scratch (or null), stats (or null), batch, nq,
    # nk, e_in, e, e_out, heads, total_heads, key_chunks, scale, stream
    "fused_mha": [_P] * 20 + [_I] * 9 + [_F, _P],
    # q, k, v, mask, wq, wk, wv, wo, qp, kp, vp, ctx, stats (or null), d_out,
    # d_probs (or null), scratch, its size in floats; d_q, d_k, d_v, d_wq,
    # d_bq, d_wk, d_bk, d_wv, d_bv, d_wo, d_bo; batch, nq, nk, e_in, e,
    # e_out, heads, total_heads, key_chunks, scale, stream
    "fused_mha_bwd": [_P] * 16 + [_L] + [_P] * 11 + [_I] * 9 + [_F, _P],
    # low, high, out, rounds, scratch (or null), batch, height, width, stream
    "canny_hysteresis": [_P] * 5 + [_I] * 3 + [_P],
}

# Further entry points of a library, for tests and measurements.
_EXTRA_SIGNATURES = {
    # a, b, y, colsum (or null), rows, e, form (1 = a b^T, 2 = a^T b by row
    # chunks), stream
    "fused_mha_bwd": {"fused_mha_bwd_gemm": [_P] * 4 + [_I] * 3 + [_P]},
}

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the "
                       "CUDA toolkit is installed")


def build_path(name: str, sources: Iterable[Path], flags: Sequence[str]) -> Path:
    """``_build/lib<name>-<hash>.so``, the hash taken over ``flags`` and the
    bytes of every source, so a changed source or flag never loads a stale
    library (the host libraries of ``native.py`` are named the same way)."""
    h = hashlib.sha256(" ".join(flags).encode())
    for src in sources:
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _library_path(name: str) -> Path:
    return build_path(name, sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"], NVCC_FLAGS)


def build_all(names: Iterable[str] = KERNELS) -> Dict[str, str]:
    """Compile every missing library, one ``nvcc`` per source, all started
    together. Returns ``{name: ptxas report}`` (empty for cached builds)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name in names:
        out = _library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    reports = {}
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        reports[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return reports


def library(name: str) -> ctypes.CDLL:
    """The loaded library for kernel ``name``, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = _library_path(name)
            if not path.exists():
                build_all([name])
            lib = ctypes.CDLL(str(path))
            lib.cmt_error_string.restype = ctypes.c_char_p
            lib.cmt_error_string.argtypes = [ctypes.c_int]
            lib.cmt_kernel_launches.restype = ctypes.c_longlong
            lib.cmt_kernel_launches.argtypes = []
            fn = getattr(lib, name)
            fn.restype = ctypes.c_int
            fn.argtypes = _SIGNATURES[name]
            for extra, argtypes in _EXTRA_SIGNATURES.get(name, {}).items():
                getattr(lib, extra).restype = ctypes.c_int
                getattr(lib, extra).argtypes = argtypes
            _libs[name] = lib
        return lib


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise on a nonzero ``cudaGetLastError()`` code returned by a launcher."""
    if rc != 0:
        msg = lib.cmt_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")


def device_launches(name: str) -> int:
    """CUDA kernels that library ``name`` has launched since it was loaded:
    the difference around one wrapper call is that call's launches."""
    return int(library(name).cmt_kernel_launches())


def stream_handle(t: torch.Tensor) -> int:
    """The current stream of the CUDA tensor's device, as the integer a
    launcher takes (read without building a ``torch.cuda.Stream``: the
    wrappers run many times per batch)."""
    return torch._C._cuda_getCurrentRawStream(t.get_device())
