"""ctypes bindings of the port's native host data path (``csrc/host/``).

Port of ``camouflage_multimodal_tpu/native.py``: the threaded libjpeg /
libpng decoder with PIL's fixed-point bicubic resize (``dataio.cpp``,
bit-exact with PIL's decode + resize) and the CPU region-graph builder
(``graph_builder.cpp``: SLIC, Canny, features, RAG). Both are the port's
own copies of the JAX package's sources, built with ``g++`` at first use
(never at import) into ``_build/``, each named by a hash of its sources,
flags and the compiler's resolution of ``-march=native``
(:func:`core.kernels.build_path`); a build goes to a temporary name first
and is renamed into place, so processes and threads building at once never
load a half-written file. A batch call releases the interpreter lock
(``ctypes.CDLL``) and fans the batch out over up to 8 threads of its own.

The JPEG and PNG code comes from the copies Pillow's wheels carry in
``pillow.libs/`` (the libraries PIL itself decodes with; the build records
their directory as the library's rpath), compiled against the libjpeg-turbo
6.2-API and libpng 1.6 headers in ``csrc/host/include/``; where Pillow
carries none, the system's ``-ljpeg -lpng``.

Unlike the JAX module, a library that cannot be built or loaded raises
``RuntimeError`` (with the compiler's output): nothing here falls back to
PIL. Callers take PIL only when asked to (``use_native=False``), or for a
single file the native decoder rejected, where the JAX code does the same.

``DECODED`` counts the batch calls into the decoder and their images, as
``core.kernels.LAUNCHES`` counts kernel launches, so a run can show that a
path decoded natively.
"""

from __future__ import annotations

import ctypes
import functools
import os
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from camouflage_multimodal_tpu_torch.core.kernels import CSRC, build_path

HOST_SRC = CSRC / "host"
INCLUDE = HOST_SRC / "include"
CXX = "g++"
CXX_FLAGS = ["-O3", "-march=native", "-funroll-loops", "-fPIC", "-std=c++17", "-shared"]
MAX_THREADS = 8
# library name → (source, whether it links libjpeg and libpng)
LIBRARIES = {"cmtdataio": ("dataio.cpp", True), "cmtgraph": ("graph_builder.cpp", False)}

DECODED: Dict[str, int] = {"batches": 0, "images": 0}

_P = ctypes.POINTER
_STR, _INT, _F32, _U8 = ctypes.c_char_p, ctypes.c_int, ctypes.c_float, ctypes.c_uint8
_SIGNATURES = {
    "cmtdataio": {
        "cmt_load_image": [_STR, _INT, _INT, _P(_F32)],
        "cmt_load_batch": [_P(_STR), _INT, _INT, _INT, _P(_F32), _P(_INT), _INT],
        "cmt_load_image_u8": [_STR, _INT, _INT, _P(_U8)],
        "cmt_load_batch_u8": [_P(_STR), _INT, _INT, _INT, _P(_U8), _P(_INT), _INT],
        "cmt_load_batch_u8_draft": [_P(_STR), _INT, _INT, _INT, _INT, _P(_U8), _P(_INT), _INT],
    },
    "cmtgraph": {
        "cmt_build_region_graph": [
            _P(_F32), _INT, _INT, _INT, ctypes.c_double, ctypes.c_double, _INT, _INT,
            _P(ctypes.c_int32), _P(_F32), _P(_U8), _P(_F32), _P(_U8)],
    },
}

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()
_count_lock = threading.Lock()


def reset_counts() -> None:
    with _count_lock:
        for key in DECODED:
            DECODED[key] = 0


def _count(n: int) -> None:
    with _count_lock:
        DECODED["batches"] += 1
        DECODED["images"] += n


@functools.lru_cache(maxsize=None)
def _target(cxx: str) -> str:
    """What ``-march=native`` means to ``cxx`` on this machine (part of a
    library's hash: a build for another CPU is never loaded)."""
    try:
        res = subprocess.run([cxx, "-march=native", "-Q", "--help=target"],
                             capture_output=True, text=True, timeout=60)
    except FileNotFoundError as e:
        raise RuntimeError(f"C++ compiler {cxx!r} not found: the port's host "
                           f"libraries build with g++ ({e})") from e
    if res.returncode != 0:
        raise RuntimeError(f"{cxx} -march=native -Q --help=target failed:\n{res.stderr}")
    return res.stdout


def _pillow_libs() -> Path:
    """The directory where Pillow's wheels carry their shared libraries."""
    import PIL

    return Path(PIL.__file__).resolve().parent.parent / "pillow.libs"


def _image_libs() -> List[str]:
    """Link arguments for libjpeg and libpng: Pillow's own copies with an
    rpath to them, else the system's."""
    carried = _pillow_libs()
    jpeg, png = sorted(carried.glob("libjpeg*.so*")), sorted(carried.glob("libpng16*.so*"))
    if jpeg and png:
        return [str(jpeg[0]), str(png[0]), f"-Wl,-rpath,{carried}", "-lpthread"]
    return ["-ljpeg", "-lpng", "-lpthread"]


def _build(name: str, source: Path, links: Sequence[str], out: Path) -> None:
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [CXX, *CXX_FLAGS, "-I", str(INCLUDE), "-o", str(tmp), str(source), *links]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    except FileNotFoundError as e:
        raise RuntimeError(f"C++ compiler {CXX!r} not found: the port's host "
                           f"libraries build with g++ ({e})") from e
    if res.returncode != 0:
        raise RuntimeError(f"building lib{name} failed:\n{' '.join(cmd)}\n{res.stderr}")
    os.replace(tmp, out)


def _recipe(name: str) -> Tuple[Path, List[str], Path]:
    """(source, link arguments, build path) of library ``name``."""
    source, images = LIBRARIES[name]
    links = _image_libs() if images else []
    path = build_path(name, [HOST_SRC / source, *sorted(INCLUDE.glob("*.h"))],
                      [CXX, *CXX_FLAGS, *links, _target(CXX)])
    return HOST_SRC / source, links, path


def library_path(name: str) -> Path:
    """Where library ``name`` (``"cmtdataio"`` or ``"cmtgraph"``) is built."""
    return _recipe(name)[2]


def library(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, built on first use; raises
    ``RuntimeError`` when it cannot be built or loaded."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            source, links, path = _recipe(name)
            if not path.exists():
                _build(name, source, links, path)
            try:
                lib = ctypes.CDLL(str(path))
            except OSError as e:
                raise RuntimeError(f"cannot load {path}: {e}") from e
            for fn, argtypes in _SIGNATURES[name].items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            _libs[name] = lib
        return lib


def get_lib() -> ctypes.CDLL:
    """libcmtdataio: the threaded decoder."""
    return library("cmtdataio")


def get_graph_lib() -> ctypes.CDLL:
    """libcmtgraph: the CPU graph builder (SLIC + Canny + features + RAG)."""
    return library("cmtgraph")


def available() -> bool:
    """Whether both libraries build and load here. The port's decode paths
    never consult this: they call the library and raise."""
    try:
        get_lib()
        get_graph_lib()
    except RuntimeError:
        return False
    return True


def default_threads() -> int:
    """The decoder's thread count when the caller gives none: the host's
    cores, at most ``MAX_THREADS``."""
    return min(max(os.cpu_count() or 1, 1), MAX_THREADS)


def _threads(n_threads: Optional[int]) -> int:
    if n_threads is None:
        return default_threads()
    if n_threads < 1:
        raise ValueError(f"n_threads must be at least 1, got {n_threads}")
    return n_threads


def _path_array(paths: Sequence[str]):
    return (ctypes.c_char_p * len(paths))(*[os.fsencode(p) for p in paths])


def load_image(path: str, size: int = 256, gray: bool = False) -> np.ndarray:
    """Decode + bicubic-resize one image → float32 in [0, 1], (size, size[, 3])."""
    c = 1 if gray else 3
    out = np.empty(size * size * c, dtype=np.float32)
    rc = get_lib().cmt_load_image(os.fsencode(path), size, int(gray),
                                  out.ctypes.data_as(_P(_F32)))
    if rc != 0:
        raise IOError(f"native decode failed for {path}")
    return out.reshape((size, size) if gray else (size, size, 3))


def load_batch(paths: Sequence[str], size: int = 256, gray: bool = False,
               n_threads: Optional[int] = None) -> Tuple[np.ndarray, np.ndarray]:
    """Threaded batch decode → (float32 batch (N, size, size[, 3]) in
    [0, 1], ok (N,) bool). A file that fails to decode has ``ok`` False
    and unspecified pixels."""
    lib = get_lib()
    n = len(paths)
    c = 1 if gray else 3
    out = np.empty((n, size * size * c), dtype=np.float32)
    status = np.empty(n, dtype=np.int32)
    lib.cmt_load_batch(_path_array(paths), n, size, int(gray), out.ctypes.data_as(_P(_F32)),
                       status.ctypes.data_as(_P(_INT)), _threads(n_threads))
    _count(n)
    return out.reshape((n, size, size) if gray else (n, size, size, 3)), status == 0


def load_batch_u8(paths: Sequence[str], size: int = 256, gray: bool = False,
                  n_threads: Optional[int] = None,
                  draft: bool = False) -> Tuple[np.ndarray, np.ndarray]:
    """Threaded batch decode straight to uint8 (PIL's bytes) → (batch
    (N, size, size[, 3]), ok (N,) bool): the feed of the device-side
    normalize, 4x smaller on the host link than floats.

    ``draft=True`` decodes JPEGs at the smallest libjpeg M/8 DCT scale that
    still covers ``size`` on both axes (the IDCT does a low-pass downsample,
    about half the decode + resize work); its pixels differ slightly from
    the full decode (PNGs are unaffected): for throughput, not parity."""
    lib = get_lib()
    n = len(paths)
    c = 1 if gray else 3
    out = np.empty((n, size * size * c), dtype=np.uint8)
    status = np.empty(n, dtype=np.int32)
    lib.cmt_load_batch_u8_draft(_path_array(paths), n, size, int(gray), int(draft),
                                out.ctypes.data_as(_P(_U8)),
                                status.ctypes.data_as(_P(_INT)), _threads(n_threads))
    _count(n)
    return out.reshape((n, size, size) if gray else (n, size, size, 3)), status == 0


def build_region_graph(image: np.ndarray, n_segments: int = 500,
                       compactness: float = 10.0, sigma: float = 1.0,
                       num_iters: int = 10, max_nodes: int = 640) -> Dict:
    """CPU region-graph build of one (H, W, 3) float image in [0, 1].

    Returns dict: segments (H, W) i32, features (K, 15) f32, node_mask (K,)
    bool, edge_weights (K, K) f32, canny (H, W) bool, num_clusters."""
    lib = get_graph_lib()
    image = np.ascontiguousarray(image, dtype=np.float32)
    if image.ndim != 3 or image.shape[2] != 3:
        raise ValueError(f"image must be (H, W, 3), got {image.shape}")
    H, W, _ = image.shape
    K = max_nodes
    segments = np.empty((H, W), dtype=np.int32)
    features = np.empty((K, 15), dtype=np.float32)
    node_mask = np.empty(K, dtype=np.uint8)
    weights = np.empty((K, K), dtype=np.float32)
    edges = np.empty((H, W), dtype=np.uint8)
    rc = lib.cmt_build_region_graph(
        image.ctypes.data_as(_P(_F32)), H, W, n_segments, compactness, sigma, num_iters, K,
        segments.ctypes.data_as(_P(ctypes.c_int32)), features.ctypes.data_as(_P(_F32)),
        node_mask.ctypes.data_as(_P(_U8)), weights.ctypes.data_as(_P(_F32)),
        edges.ctypes.data_as(_P(_U8)))
    if rc < 0:
        raise ValueError(f"max_nodes={K} too small for the SLIC grid")
    return {"segments": segments, "features": features, "node_mask": node_mask.astype(bool),
            "edge_weights": weights, "canny": edges.astype(bool), "num_clusters": rc}
