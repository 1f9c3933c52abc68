"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/*.cu`` file compiles in its own ``nvcc`` process, all started
together, and one more links the objects into one shared library with a
plain C interface (no PyTorch headers, so the build takes seconds), bound
with ``ctypes``.  The library lands in
``build/msau_tpu_torch/`` at the checkout root, named by a hash of the
sources and flags, and is built at first use — never at import, so the
package imports on machines without ``nvcc`` or a card.

Every C entry point takes its pointers and the CUDA stream as
``ctypes.c_void_p`` and returns the ``cudaGetLastError()`` after its
launches; :func:`check` turns a non-zero code into an exception.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Optional

import torch

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "msau_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas=-v",
)
LINK_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-shared")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
# C entry point -> argument types (every pointer and the stream are c_void_p)
SIGNATURES = {
    # boxes, values, n_boxes, out, height, width, stream
    "msau_paint_boxes": (_P, _P, _I, _P, _I, _I, _P),
    # f, g, h, out, m, l, n, t, cb, c, is_bf16, stream
    "msau_resident_attention_fwd": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                                    _I, _P),
    # cls, parent, labels ([batch, height, width]), batch, height, width,
    # stream
    "msau_ccl_multiclass": (_P, _P, _P, _I, _I, _I, _P),
    # cb, c, is_bf16, dout_f32 -> the attention backward's block slots on
    # the card (occupancy API x SMs), or a negative error
    "msau_attention_bwd_slots": (_I, _I, _I, _I),
    # f, g, h, dout, m, l, df, dg, dh, partial, partial_floats, per_image,
    # n, t, cb, c, is_bf16, stream
    "msau_resident_attention_bwd": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                                    _L, _I, _I, _I, _I, _I, _I, _P),
    # f, g, h, out (f32), m, l, n, t, cb, c, is_bf16, stream
    "msau_fused_attention_fwd": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                 _P),
    # f, g, h, dout (f32), m, l, df, dg, dh, partial, partial_floats,
    # per_image, n, t, cb, c, is_bf16, stream
    "msau_fused_attention_bwd": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _L,
                                 _I, _I, _I, _I, _I, _I, _P),
    # logits, labels, mask, partial, ce_out, correct_out, blocks, n, c,
    # length, is_bf16, stream
    "msau_masked_ce_fwd": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    # logits, labels, mask, g, dlogits, n, c, length, is_bf16, stream
    "msau_masked_ce_bwd": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
    # x, y, n, hw, c, in_bf16, out_bf16, stream
    "msau_nhwc_to_nchw": (_P, _P, _I, _I, _I, _I, _I, _P),
    # x, y, nc, h, w, is_bf16, stream
    "msau_maxpool2": (_P, _P, _I, _I, _I, _I, _P),
    # a, b, w, bias, y, y2, n, ca, cb, h, w, cout, cout_a, kh, kw, dil, pt,
    # pleft, act, lrn_size, alpha, beta, lrn_k, is_bf16, stream
    "msau_flat_conv2d": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                         _I, _I, _I, _I, _I, _I, _I, _F, _F, _F, _I, _P),
    # ca, cb, cout, kh, kw, dil, pleft, is_bf16 -> 1 where msau_flat_conv2d
    # runs the shape in f32 on the tensor cores
    "msau_flat_conv_tc": (_I, _I, _I, _I, _I, _I, _I, _I),
    # a, b, w, bias, g, g0, partial, out, n, ca, cb, h, w, cout, kh, kw, dil,
    # pt, pleft, act, lrn_size, alpha, beta, lrn_k, is_bf16, stream
    "msau_flat_conv_bwd": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                           _I, _I, _I, _I, _I, _I, _I, _I, _F, _F, _F, _I, _P),
    # a, b, w, bias, g, da, db, partial, out, n, ca, cb, h, w, cout, act,
    # is_bf16, stream
    "msau_concat_conv1x1_bwd": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                                _I, _I, _I, _I, _I, _I, _P),
    # ca, cb, cout, is_bf16 -> 1 where the one-pass kernel takes them
    "msau_concat_conv1x1_bwd_fits": (_I, _I, _I, _I),
    # x, g, dx, nc, h, w, is_bf16, stream
    "msau_maxpool2_bwd": (_P, _P, _P, _I, _I, _I, _I, _P),
    # x, w, bias, y, n, cin, h, w, cout, k, ho, wo, is_bf16, stream
    "msau_flat_deconv2": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                          _P),
    # g, w, dx, n, cin, h, w, cout, k, ho, wo, is_bf16, stream
    "msau_flat_deconv2_dx": (_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                             _P),
    # x, g, partial, dw, n, cin, h, w, cout, k, ho, wo, is_bf16, stream
    "msau_flat_deconv2_dw": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                             _I, _P),
    # x, w1, b1, w2, b2, y, n, c, h, w, act, is_bf16, stream
    "msau_flat_res_block": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    # n, c, b, h, w, max_h, max_w -> bytes of shared memory the box filter
    # needs at this shape, 0 where it refuses it
    "msau_box_conv_smem": (_I, _I, _I, _I, _I, _I, _I),
    # n, c, b, h, w -> tiles of a plane (the backward's partials: C * B * 5
    # * N * tiles floats), 0 where the shape is refused
    "msau_box_conv_tiles": (_I, _I, _I, _I, _I),
    # x, ybox, xbox, out, n, c, b, h, w, max_h, max_w, normalize, is_bf16,
    # stream
    "msau_box_conv_fwd": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                          _P),
    # x, ybox, xbox, g, dx, dybox, dxbox, partial, tickets, n, c, b, h, w,
    # max_h, max_w, normalize, is_bf16, stream
    "msau_box_conv_bwd": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                          _I, _I, _I, _I, _I, _P),
    # x, g, w1, b1, w2, b2, dx, partial, out, n, c, h, w, act, is_bf16, stream
    "msau_flat_res_block_bwd": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                                _I, _I, _I, _I, _P),
}
# rows of the f32 scratch a kernel that sums weight gradients across blocks
# writes (kPartialBlocks in csrc/common.cuh): one per block of its grid
PARTIAL_BLOCKS = 264


class KernelLibrary:
    """The compiled kernels of ``csrc/``; ``build_seconds`` is 0 when the
    library for these sources was already on disk."""

    def __init__(self, path: Path, build_seconds: float, build_log: str):
        self.path = path
        self.build_seconds = build_seconds
        self.build_log = build_log
        self._lib = ctypes.CDLL(str(path))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(self._lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int

    def __getattr__(self, name):
        if name in SIGNATURES:
            return getattr(self._lib, name)
        raise AttributeError(name)


_LIBRARY: Optional[KernelLibrary] = None
# a failed build, re-raised by every later call instead of building again
_BUILD_ERROR: Optional[RuntimeError] = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _sources():
    return sorted(CSRC.glob("*.cu"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
    for src in _sources() + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def library() -> KernelLibrary:
    """Build (once per source hash) and load the kernel library."""
    global _LIBRARY, _BUILD_ERROR
    if _LIBRARY is not None:
        return _LIBRARY
    if _BUILD_ERROR is not None:
        raise _BUILD_ERROR
    out = BUILD_DIR / f"libmsau_kernels-{source_hash()}.so"
    seconds, log = 0.0, ""
    if not out.exists():
        t0 = time.perf_counter()
        try:
            log = _build(out)
        except RuntimeError as e:
            _BUILD_ERROR = e
            raise
        seconds = time.perf_counter() - t0
    _LIBRARY = KernelLibrary(out, seconds, log)
    return _LIBRARY


def _build(out: Path) -> str:
    """Compile every source in parallel, link into ``out``; returns the
    compilers' output (ptxas register and shared-memory lines)."""
    nvcc = _nvcc()
    objs = BUILD_DIR / f"obj-{out.stem}-{os.getpid()}"
    objs.mkdir(parents=True, exist_ok=True)
    jobs = []
    for src in _sources():
        obj = objs / f"{src.stem}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
        jobs.append((src.name, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    log, failed = [], []
    for name, _, proc in jobs:  # wait for every process, failed or not
        text, _ = proc.communicate()
        log.append(f"== {name}\n{text}")
        if proc.returncode != 0:
            failed.append(name)
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(log))
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([nvcc, *LINK_FLAGS, "-o", str(tmp),
                           *(str(obj) for _, obj, _ in jobs)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    shutil.rmtree(objs, ignore_errors=True)
    return "\n".join(log)


def stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def check(name: str, code: int) -> None:
    if code != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {code}")


def require_cuda(name: str, t: torch.Tensor, dtype, ndim: int) -> None:
    """Validate a tensor handed to a CUDA kernel wrapper."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if dtype is not None and t.dtype not in (
            dtype if isinstance(dtype, tuple) else (dtype,)):
        raise ValueError(f"{name}: dtype {t.dtype} not supported")
    if t.ndim != ndim:
        raise ValueError(f"{name}: expected {ndim}-D, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: tensor must be contiguous")
