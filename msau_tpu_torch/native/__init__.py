"""The native rasterizer core: ``rasterlib.c`` (the JAX package's C core,
copied byte for byte) behind a ctypes binding.

The shared object is built at first use, ``gcc -O2 -shared -fPIC``, into
``build/msau_tpu_torch/librasterlib-<hash>.so`` beside the CUDA kernels
(the hash covers the flags and the source, so an edited source builds
anew), never into the package.  Processes that reach first use together
build it once: one takes a lock and compiles to a temporary name, then
renames it into place; the others wait and load it.

Failures are never silent: where no C compiler exists and nothing is
built, ``native_available()`` is False and ``data.native`` takes its numpy
versions (as the JAX package does without its ``.so``); a build that
fails with a compiler present raises ``RuntimeError`` with the compiler's
output, on the first call and on every later one.

``char_records`` and ``wordgrid_records`` call the C core and nothing else;
``data.native`` dispatches between them and its numpy versions.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

SOURCE = Path(__file__).resolve().parent / "rasterlib.c"
BUILD_DIR = SOURCE.parents[2] / "build" / "msau_tpu_torch"
CFLAGS = ("-O2", "-shared", "-fPIC")

_LIB: Optional[ctypes.CDLL] = None
_ERROR: Optional[RuntimeError] = None
_GUARD = threading.Lock()
# this process's load: the library's path, whether this process built it,
# and the build's seconds
BUILD_INFO: dict = {}


def compiler() -> Optional[str]:
    """The C compiler's path, or None where there is none."""
    return shutil.which("gcc")


def source_hash() -> str:
    h = hashlib.sha256(" ".join(CFLAGS).encode())
    h.update(SOURCE.read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_DIR / f"librasterlib-{source_hash()}.so"


def build() -> Tuple[Path, bool]:
    """The shared object, compiled where it is not built yet -> (path,
    whether this call compiled it).  Raises ``RuntimeError`` where no C
    compiler exists or the compiler fails (with its output)."""
    out = library_path()
    if out.exists():
        return out, False
    cc = compiler()
    if cc is None:
        raise RuntimeError("no C compiler (gcc) to build the rasterizer core")
    out.parent.mkdir(parents=True, exist_ok=True)
    with open(out.parent / f"{out.name}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if out.exists():        # another process built it while we waited
            return out, False
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.run([cc, *CFLAGS, "-o", str(tmp), str(SOURCE)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"{cc} failed ({proc.returncode}) on "
                               f"{SOURCE}:\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
    return out, True


def _bind(path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    lib.build_char_records.restype = ctypes.c_int64
    lib.build_char_records.argtypes = [
        ctypes.c_int64, i32p, i32p, i32p, ctypes.c_double, i32p, i32p, i32p,
    ]
    lib.build_wordgrid_records.restype = ctypes.c_int64
    lib.build_wordgrid_records.argtypes = [
        ctypes.c_int64, f64p, i32p, i32p,
        ctypes.c_double, ctypes.c_double, ctypes.c_double, ctypes.c_double,
        i32p,
    ]
    return lib


def _load() -> Optional[ctypes.CDLL]:
    """The bound core (built first where needed), or None where no C
    compiler exists and nothing is built; a failed build raises, now and
    on every later call."""
    global _LIB, _ERROR
    with _GUARD:
        if _LIB is not None:
            return _LIB
        if _ERROR is not None:
            raise _ERROR
        if compiler() is None and not library_path().exists():
            return None
        t0 = time.perf_counter()
        try:
            path, built = build()
        except RuntimeError as e:
            _ERROR = e
            raise
        _LIB = _bind(path)
        BUILD_INFO.update(path=str(path), built=built,
                          seconds=time.perf_counter() - t0)
        return _LIB


def native_available() -> bool:
    """Whether the C core runs (``data.native`` dispatches to it)."""
    return _load() is not None


def _require() -> ctypes.CDLL:
    lib = _load()
    if lib is None:
        raise RuntimeError("the rasterizer core is not built and no C "
                           "compiler exists")
    return lib


def char_records(line_boxes: np.ndarray, text_offsets: np.ndarray,
                 char_ids: np.ndarray, cap_factor: float
                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The C core's ``build_char_records``: line_boxes [L, 4] int32 scaled
    (x1, y1, x2, y2), text_offsets [L+1], char_ids [total] -> (records
    [N, 5] (y1, y2, sx, ex, id), line_idx [N] 1-based, char_pos [N]
    1-based)."""
    lib = _require()
    line_boxes = np.ascontiguousarray(line_boxes, np.int32)
    text_offsets = np.ascontiguousarray(text_offsets, np.int32)
    char_ids = np.ascontiguousarray(char_ids, np.int32)
    total = int(char_ids.shape[0])
    out = np.empty((total, 5), np.int32)
    li = np.empty(total, np.int32)
    cp = np.empty(total, np.int32)
    n = lib.build_char_records(
        len(line_boxes), line_boxes.reshape(-1), text_offsets, char_ids,
        float(cap_factor), out.reshape(-1), li, cp)
    return out[:n], li[:n], cp[:n]


def wordgrid_records(word_boxes: np.ndarray, text_offsets: np.ndarray,
                     char_ids: np.ndarray, min_x: float, min_y: float,
                     min_scale: float, min_h: float) -> np.ndarray:
    """The C core's ``build_wordgrid_records``: word_boxes [W, 4] float64
    (x, y, w, h), text_offsets [W+1], char_ids [total] -> records [N, 5]
    (y1, y2, x1, x2, id) in cell units."""
    lib = _require()
    word_boxes = np.ascontiguousarray(word_boxes, np.float64)
    text_offsets = np.ascontiguousarray(text_offsets, np.int32)
    char_ids = np.ascontiguousarray(char_ids, np.int32)
    total = int(char_ids.shape[0])
    out = np.empty((total, 5), np.int32)
    n = lib.build_wordgrid_records(
        len(word_boxes), word_boxes.reshape(-1), text_offsets, char_ids,
        float(min_x), float(min_y), float(min_scale), float(min_h),
        out.reshape(-1))
    return out[:n]
