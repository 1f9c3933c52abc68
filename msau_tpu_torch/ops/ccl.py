"""Multiclass 4-connected component labelling of an int32 [H, W] class map.

Pixels connect only to 4-neighbours of the SAME class value (class <= 0 is
background).  The label of a component is the linear index of its
raster-first pixel + 1, so sorting roots ascending reproduces scipy's label
numbering; background is 0.

``connected_components_multiclass`` is the entry point: a CUDA tensor
launches the hand-written block-based union-find (``csrc/ccl.cu``, the port of the
TPU kernel ``msau_tpu/ops/ccl.py:_ccl_mc_kernel``); a CPU tensor takes
``connected_components_multiclass_plain``, same-class min propagation with
pointer jumping.  Both run to convergence, with no sweep cap: they equal the
TPU kernel's fixpoint, and differ from it only where that kernel stops at its
``max_iters`` cap unconverged.
"""

from __future__ import annotations

import torch

from msau_tpu_torch.ops import cuda_lib

INF = torch.iinfo(torch.int32).max


def _shifted(x: torch.Tensor, dy: int, dx: int, fill: int) -> torch.Tensor:
    """out[y, x] = x[y + dy, x + dx], ``fill`` outside the grid."""
    h, w = x.shape
    out = torch.full_like(x, fill)
    ys, yd = slice(max(dy, 0), h + min(dy, 0)), slice(max(-dy, 0), h + min(-dy, 0))
    xs, xd = slice(max(dx, 0), w + min(dx, 0)), slice(max(-dx, 0), w + min(-dx, 0))
    out[yd, xd] = x[ys, xs]
    return out


def connected_components_multiclass_plain(cls: torch.Tensor) -> torch.Tensor:
    """Min-label propagation between same-class 4-neighbours, with a
    pointer-jumping hop per sweep, iterated to convergence.

    A label is always (linear index + 1) of a pixel of the same component,
    so the fixpoint is the component's minimum index + 1.  Raises if it has
    not converged after H*W sweeps (it cannot need more)."""
    h, w = cls.shape
    cls = cls.to(torch.int32)
    fg = cls > 0
    idx = torch.arange(1, h * w + 1, dtype=torch.int32,
                       device=cls.device).reshape(h, w)
    labels = torch.where(fg, idx, torch.zeros_like(idx))
    neighbours = [(0, 1), (0, -1), (1, 0), (-1, 0)]
    same = [fg & (_shifted(cls, dy, dx, -1) == cls) for dy, dx in neighbours]
    for _ in range(h * w):
        vals = torch.where(fg, labels, torch.full_like(labels, INF))
        new = vals
        for (dy, dx), ok in zip(neighbours, same):
            nb = _shifted(vals, dy, dx, INF)
            new = torch.where(ok, torch.minimum(new, nb), new)
        # pointer jump: label[p] <- min(label[p], label[label[p] - 1])
        flat = new.reshape(-1)
        tgt = flat[(torch.clamp(new, 1, h * w) - 1).reshape(-1).long()]
        new = torch.minimum(new, tgt.reshape(h, w))
        new = torch.where(fg, new, torch.zeros_like(new))
        if torch.equal(new, labels):
            return labels
        labels = new
    raise RuntimeError(f"CCL did not converge after {h * w} sweeps")


def connected_components_multiclass_cuda(cls: torch.Tensor) -> torch.Tensor:
    """Launch the three union-find kernels (tiles in shared memory, unions
    across tile borders, flatten) as one call;
    ``connected_components_multiclass_cuda.launches`` counts calls."""
    cuda_lib.require_cuda("connected_components_multiclass", cls,
                          torch.int32, 2)
    h, w = cls.shape
    if h * w >= 2**31 - 1:
        raise ValueError("connected_components_multiclass: map too large")
    parent = torch.empty((h, w), dtype=torch.int32, device=cls.device)
    labels = torch.empty((h, w), dtype=torch.int32, device=cls.device)
    code = cuda_lib.library().msau_ccl_multiclass(
        cls.data_ptr(), parent.data_ptr(), labels.data_ptr(), h, w,
        cuda_lib.stream_ptr(cls.device))
    cuda_lib.check("msau_ccl_multiclass", code)
    connected_components_multiclass_cuda.launches += 1
    return labels


connected_components_multiclass_cuda.launches = 0


def connected_components_multiclass(cls: torch.Tensor) -> torch.Tensor:
    """Labels of an int32 [H, W] class map; the device of ``cls`` picks the
    implementation."""
    if cls.device.type == "cuda":
        return connected_components_multiclass_cuda(cls)
    if cls.device.type != "cpu":
        raise ValueError(f"connected_components_multiclass: unsupported "
                         f"device {cls.device}")
    return connected_components_multiclass_plain(cls)
