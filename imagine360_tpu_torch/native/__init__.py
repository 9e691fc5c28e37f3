"""Host-preprocessing routines: bilinear remap, uint8 -> model range and the
largest inscribed rectangle (counterpart of imagine360_tpu/native).

They run on a threaded C++ library, `remap.cc` beside this file, compiled
at first use with `$CXX` (default g++) and the flags of the repo's native
Makefile into `imagine360_tpu_torch/_build/`, under a name that carries a
hash of the source, the compiler, the flags and the target that
`-march=native` resolves to, so a stale library or one built for another
CPU is never loaded. Several processes may build at once: each holds an
`fcntl` lock around the build and moves a finished library into place with
`os.replace`. A missing compiler or a failed build raises with the
compiler's output; nothing falls back quietly.

The numpy versions are the plain ones, with the semantics of the JAX
package's Python fallbacks (imagine360_tpu/pipeline/anchor.py). A caller
reaches them only by naming them, `backend="numpy"`. `calls()` counts the
calls of each route.
"""
from __future__ import annotations

import ctypes
import fcntl
import functools
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).with_name("remap.cc")
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
CXXFLAGS = ("-O3", "-march=native", "-fPIC", "-shared", "-std=c++17", "-pthread")
# threads of one call, as the JAX package runs them, and no more than the host has
NUM_THREADS = min(8, os.cpu_count() or 1)
BACKENDS = ("library", "numpy")
FUNCTIONS = ("remap_bilinear", "u8_to_model_range", "max_inscribed_rect")

_calls = {b: dict.fromkeys(FUNCTIONS, 0) for b in BACKENDS}


def calls() -> dict:
    """{route: {function: calls}} since the last reset_calls()."""
    return {b: dict(c) for b, c in _calls.items()}


def reset_calls() -> None:
    for c in _calls.values():
        for k in c:
            c[k] = 0


def _route(fn: str, backend: str) -> bool:
    """Count the call; True for the library route."""
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r}: one of {BACKENDS}")
    _calls[backend][fn] += 1
    return backend == "library"


def _compiler() -> str:
    return os.environ.get("CXX") or "g++"


def _run(cmd) -> subprocess.CompletedProcess:
    try:
        res = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:
        raise RuntimeError(f"host library: cannot run {cmd[0]!r}: {e}") from e
    if res.returncode != 0:
        raise RuntimeError(f"host library: {' '.join(cmd)} failed ({res.returncode}):\n"
                           f"{res.stderr[-8000:]}")
    return res


@functools.lru_cache(maxsize=None)
def _digest(cxx: str) -> str:
    target = _run([cxx, "-march=native", "-Q", "--help=target"]).stdout
    h = hashlib.sha256(SOURCE.read_bytes())
    for part in (cxx, " ".join(CXXFLAGS), target):
        h.update(part.encode())
    return h.hexdigest()[:16]


def library_path(cxx: str) -> Path:
    """Where the library of this source, compiler, flags and host CPU is."""
    return BUILD_DIR / f"libi360_host_{_digest(cxx)}.so"


def build_library() -> Path:
    """Compile remap.cc (once per hash) and return the library's path."""
    cxx = _compiler()
    lib = library_path(cxx)
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "libi360_host.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not lib.exists():            # another process may have built it meanwhile
            tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
            try:
                _run([cxx, *CXXFLAGS, str(SOURCE), "-o", str(tmp)])
                os.replace(tmp, lib)
            finally:
                if tmp.exists():
                    tmp.unlink()
    return lib


@functools.lru_cache(maxsize=None)
def _load(path: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(path)
    f32p, u8p = ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_uint8)
    i = ctypes.c_int
    remap = [i, i, i, f32p, f32p, i, i, f32p, i, i]
    lib.remap_bilinear_f32.argtypes = [f32p, *remap]
    lib.remap_bilinear_u8.argtypes = [u8p, *remap]
    lib.u8_to_model_range.argtypes = [u8p, ctypes.c_int64, f32p, i]
    lib.max_inscribed_rect_u8.argtypes = [u8p, i, i, ctypes.POINTER(ctypes.c_int)]
    for name in ("remap_bilinear_f32", "remap_bilinear_u8", "u8_to_model_range",
                 "max_inscribed_rect_u8"):
        getattr(lib, name).restype = None
    return lib


def load_library() -> ctypes.CDLL:
    """The library, built first where it is missing."""
    return _load(str(build_library()))


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def remap_bilinear(src: np.ndarray, gx: np.ndarray, gy: np.ndarray, wrap_x: bool = True,
                   backend: str = "library", num_threads: int = NUM_THREADS) -> np.ndarray:
    """src [H, W, C] or [H, W], uint8 or float; gx/gy [oh, ow] absolute
    pixel coords -> float32 [oh, ow, C] (or [oh, ow]). Bilinear; x wraps
    (wrap_x) or clamps, y clamps (cv2.BORDER_WRAP behaviour at the
    360-degree seam)."""
    if not _route("remap_bilinear", backend):
        return _remap_bilinear_numpy(src, gx, gy, wrap_x)
    if src.ndim not in (2, 3) or np.shape(gx) != np.shape(gy) or np.ndim(gx) != 2:
        raise ValueError(f"remap_bilinear takes src [H, W] or [H, W, C] and grids [oh, ow], "
                         f"got {src.shape}, {np.shape(gx)}, {np.shape(gy)}")
    lib = load_library()
    src = np.ascontiguousarray(src)
    flat = src.ndim == 2
    if flat:
        src = src[..., None]
    if src.dtype != np.uint8:
        src = np.ascontiguousarray(src, np.float32)
    gx = np.ascontiguousarray(gx, np.float32)
    gy = np.ascontiguousarray(gy, np.float32)
    H, W, C = src.shape
    oh, ow = gx.shape
    out = np.empty((oh, ow, C), np.float32)
    f32 = ctypes.c_float
    fn, sp = ((lib.remap_bilinear_u8, _ptr(src, ctypes.c_uint8)) if src.dtype == np.uint8
              else (lib.remap_bilinear_f32, _ptr(src, f32)))
    fn(sp, H, W, C, _ptr(gx, f32), _ptr(gy, f32), oh, ow, _ptr(out, f32), int(wrap_x),
       num_threads)
    return out[..., 0] if flat else out


def u8_to_model_range(frames: np.ndarray, backend: str = "library",
                      num_threads: int = NUM_THREADS) -> np.ndarray:
    """uint8 [0, 255] -> float32 [-1, 1]."""
    if not _route("u8_to_model_range", backend):
        return frames.astype(np.float32) / 127.5 - 1.0
    if frames.dtype != np.uint8:
        raise TypeError(f"u8_to_model_range takes uint8 frames, got {frames.dtype}")
    lib = load_library()
    frames = np.ascontiguousarray(frames)
    out = np.empty(frames.shape, np.float32)
    lib.u8_to_model_range(_ptr(frames, ctypes.c_uint8), frames.size,
                          _ptr(out, ctypes.c_float), num_threads)
    return out


def max_inscribed_rect(mask: np.ndarray, backend: str = "library"):
    """Largest all-ones axis-aligned rectangle in a binary [h, w] mask, as
    (top, left, width, height)."""
    if not _route("max_inscribed_rect", backend):
        return _max_inscribed_rect_numpy(mask)
    if np.ndim(mask) != 2:
        raise ValueError(f"max_inscribed_rect takes a [h, w] mask, got {np.shape(mask)}")
    lib = load_library()
    m = np.ascontiguousarray(np.asarray(mask).astype(bool), np.uint8)
    out = (ctypes.c_int * 4)()
    lib.max_inscribed_rect_u8(_ptr(m, ctypes.c_uint8), m.shape[0], m.shape[1], out)
    return int(out[0]), int(out[1]), int(out[2]), int(out[3])


# ---------------------------------------------------------------------------
# the plain versions (numpy)
# ---------------------------------------------------------------------------


def _remap_bilinear_numpy(src, gx, gy, wrap_x):
    H, W = src.shape[:2]
    x0 = np.floor(gx).astype(np.int64)
    y0 = np.floor(gy).astype(np.int64)
    wx, wy = gx - x0, gy - y0
    if src.ndim == 3:
        wx, wy = wx[..., None], wy[..., None]
    if wrap_x:
        xs0, xs1 = x0 % W, (x0 + 1) % W
    else:
        xs0, xs1 = np.clip(x0, 0, W - 1), np.clip(x0 + 1, 0, W - 1)
    ys0 = np.clip(y0, 0, H - 1)
    ys1 = np.clip(y0 + 1, 0, H - 1)
    return (src[ys0, xs0] * (1 - wx) * (1 - wy) + src[ys0, xs1] * wx * (1 - wy)
            + src[ys1, xs0] * (1 - wx) * wy + src[ys1, xs1] * wx * wy)


def _max_inscribed_rect_numpy(mask):
    """Histogram-stack algorithm over column heights; of equal areas, the
    first found scanning rows top to bottom and columns left to right. Rows
    without a set pixel and the columns outside a row's first and last
    nonzero height hold no rectangle and cannot end one, so the scan skips
    them; the result is that of the full scan."""
    h, w = mask.shape
    m = np.asarray(mask).astype(bool)
    heights = np.zeros(w, dtype=np.int64)
    best_area = 0
    best = (0, 0, 0, 0)
    for i in range(h):
        heights = np.where(m[i], heights + 1, 0)
        nz = np.flatnonzero(heights)
        if nz.size == 0:
            continue
        lo, hi = int(nz[0]), int(nz[-1]) + 1
        row = heights[lo:hi].tolist() + [0]
        stack = []  # (start index, height)
        for j, cur in enumerate(row, start=lo):
            start = j
            while stack and stack[-1][1] > cur:
                s, hh = stack.pop()
                area = hh * (j - s)
                if area > best_area:
                    best_area = area
                    best = (i - hh + 1, s, j - s, hh)
                start = s
            if not stack or stack[-1][1] < cur:
                stack.append((start, cur))
    return best
