"""Connected-component labelling (4-connectivity) and per-component stats.

``connected_components_multiclass`` labels an int32 class map, [H, W] or a
stack of pages [B, H, W]: pixels connect only to 4-neighbours of the SAME
class value on the same page (class <= 0 is background).  The label of a
component is the linear index of its raster-first pixel within its page + 1,
so sorting roots ascending reproduces scipy's label numbering; background is
0.  A [B, H, W] stack gives what ``jax.vmap`` of the TPU kernel gives.

It is the entry point of the kernel: a CUDA tensor launches the
hand-written block-based union-find (``csrc/ccl.cu``, the port of the TPU
kernel ``msau_tpu/ops/ccl.py:_ccl_mc_kernel``), one call of three launches
for any B; a CPU tensor takes ``connected_components_multiclass_plain``,
same-class min propagation with pointer jumping.  Both run to convergence,
with no sweep cap: they equal the TPU kernel's fixpoint, and differ from it
only where that kernel stops at its ``max_iters`` cap unconverged.

The single-map functions of ``msau_tpu.ops.ccl`` (XLA there, torch ops
here): ``connected_components_jax`` (a boolean mask, labelled as a one-class
map), ``component_stats`` and ``top_k_components``.
"""

from __future__ import annotations

from typing import Dict

import torch

from msau_tpu_torch.ops import cuda_lib

INF = torch.iinfo(torch.int32).max
INT_MIN = torch.iinfo(torch.int32).min


def _shifted(x: torch.Tensor, dy: int, dx: int, fill: int) -> torch.Tensor:
    """out[..., y, x] = x[..., y + dy, x + dx], ``fill`` outside the grid."""
    h, w = x.shape[-2:]
    out = torch.full_like(x, fill)
    ys, yd = slice(max(dy, 0), h + min(dy, 0)), slice(max(-dy, 0), h + min(-dy, 0))
    xs, xd = slice(max(dx, 0), w + min(dx, 0)), slice(max(-dx, 0), w + min(-dx, 0))
    out[..., yd, xd] = x[..., ys, xs]
    return out


def connected_components_multiclass_plain(cls: torch.Tensor) -> torch.Tensor:
    """Min-label propagation between same-class 4-neighbours, with a
    pointer-jumping hop per sweep, iterated to convergence, on [H, W] or on
    every page of [B, H, W] at once.

    A label is always (page-local linear index + 1) of a pixel of the same
    component, so the fixpoint is the component's minimum index + 1; a page
    at its fixpoint stays there while the others converge.  Raises if it
    has not converged after H*W sweeps (it cannot need more)."""
    if cls.ndim == 2:
        return connected_components_multiclass_plain(cls[None])[0]
    b, h, w = cls.shape
    cls = cls.to(torch.int32)
    fg = cls > 0
    idx = torch.arange(1, h * w + 1, dtype=torch.int32,
                       device=cls.device).reshape(1, h, w)
    labels = torch.where(fg, idx, torch.zeros_like(idx))
    neighbours = [(0, 1), (0, -1), (1, 0), (-1, 0)]
    same = [fg & (_shifted(cls, dy, dx, -1) == cls) for dy, dx in neighbours]
    for _ in range(h * w):
        vals = torch.where(fg, labels, torch.full_like(labels, INF))
        new = vals
        for (dy, dx), ok in zip(neighbours, same):
            nb = _shifted(vals, dy, dx, INF)
            new = torch.where(ok, torch.minimum(new, nb), new)
        # pointer jump: label[p] <- min(label[p], label[label[p] - 1]), the
        # gather along the page's own pixels
        tgt = torch.gather(new.reshape(b, h * w), 1,
                           (torch.clamp(new, 1, h * w) - 1).reshape(b, -1).long())
        new = torch.minimum(new, tgt.reshape(b, h, w))
        new = torch.where(fg, new, torch.zeros_like(new))
        if torch.equal(new, labels):
            return labels
        labels = new
    raise RuntimeError(f"CCL did not converge after {h * w} sweeps")


def connected_components_multiclass_cuda(cls: torch.Tensor) -> torch.Tensor:
    """Launch the three union-find kernels (tiles in shared memory, unions
    across tile borders, flatten) as one call over every page of ``cls``
    ([H, W] or [B, H, W]); ``connected_components_multiclass_cuda.launches``
    counts calls."""
    cuda_lib.require_cuda("connected_components_multiclass", cls,
                          torch.int32, 2 if cls.ndim == 2 else 3)
    b, h, w = cls.shape if cls.ndim == 3 else (1,) + tuple(cls.shape)
    if b * h * w >= 2**31 - 1:
        raise ValueError("connected_components_multiclass: map too large")
    parent = torch.empty_like(cls)
    labels = torch.empty_like(cls)
    code = cuda_lib.library().msau_ccl_multiclass(
        cls.data_ptr(), parent.data_ptr(), labels.data_ptr(), b, h, w,
        cuda_lib.stream_ptr(cls.device))
    cuda_lib.check("msau_ccl_multiclass", code)
    connected_components_multiclass_cuda.launches += 1
    return labels


connected_components_multiclass_cuda.launches = 0


def connected_components_multiclass(cls: torch.Tensor) -> torch.Tensor:
    """Labels of an int32 class map, [H, W] or [B, H, W] (page-local
    labels); the device of ``cls`` picks the implementation."""
    if cls.device.type == "cuda":
        return connected_components_multiclass_cuda(cls)
    if cls.device.type != "cpu":
        raise ValueError(f"connected_components_multiclass: unsupported "
                         f"device {cls.device}")
    return connected_components_multiclass_plain(cls)


# ---------------------------------------------------------------------------
# Single-map functions (XLA in the JAX package)
# ---------------------------------------------------------------------------
def connected_components_jax(mask: torch.Tensor,
                             max_iters: int = 64) -> torch.Tensor:
    """4-connected components of a boolean [H, W] mask: int32 labels, 0 =
    background, otherwise (linear index of the component's raster-first
    pixel) + 1.  The multiclass labelling of the mask as a one-class map;
    ``max_iters`` is accepted for the JAX signature and not used, since the
    labelling runs to convergence (the JAX sweeps stop at the cap)."""
    del max_iters
    return connected_components_multiclass(mask.to(torch.int32))


def segment_reduce(src: torch.Tensor, seg: torch.Tensor, n: int, reduce: str,
             identity: int) -> torch.Tensor:
    """jax.ops.segment_{sum,min,max} over a flat ``seg``: empty segments
    hold the identity."""
    out = torch.full((n,), identity, dtype=src.dtype, device=src.device)
    return out.scatter_reduce(0, seg.long(), src, reduce, include_self=True)


def component_stats(labels: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Per-root stats over a [H, W] label map (root ids index a [H*W+1]
    table): pixel counts, bbox corners (y1, x1 inclusive; y2, x2 exclusive,
    scipy find_objects' slice convention) and bbox areas, each int32
    [H*W + 1]; index 0 is background.  Empty roots hold the segment
    identities of ``jax.ops``: int32 max for the minima, int32 min (+ 1) for
    the maxima, and 0 area."""
    h, w = labels.shape
    n = h * w + 1
    flat = labels.reshape(-1)
    pix = torch.arange(h * w, dtype=torch.int32, device=labels.device)
    rows = torch.div(pix, w, rounding_mode="floor")
    cols = pix % w
    count = segment_reduce(torch.ones_like(flat), flat, n, "sum", 0)
    y1 = segment_reduce(rows, flat, n, "amin", INF)
    y2 = segment_reduce(rows, flat, n, "amax", INT_MIN) + 1
    x1 = segment_reduce(cols, flat, n, "amin", INF)
    x2 = segment_reduce(cols, flat, n, "amax", INT_MIN) + 1
    bbox_area = torch.where(count > 0, (y2 - y1) * (x2 - x1),
                            torch.zeros_like(count))
    return {"count": count, "y1": y1, "x1": x1, "y2": y2, "x2": x2,
            "bbox_area": bbox_area}


def top_k_lower_index(vals: torch.Tensor, k: int):
    """``lax.top_k`` along the last axis: descending values, ties to the
    lower index.  ``torch.topk`` promises no tie order, so it runs on a
    unique int64 key per row (the value first, then the lower index), which
    never mixes rows."""
    n = vals.shape[-1]
    idx = torch.arange(n, device=vals.device, dtype=torch.int64)
    key = vals.to(torch.int64) * n + (n - 1 - idx)
    top, _ = torch.topk(key, k, dim=-1)
    return (torch.div(top, n, rounding_mode="floor")).to(vals.dtype), \
        (n - 1 - top % n)


def top_k_components(stats: Dict[str, torch.Tensor],
                     k: int = 8) -> Dict[str, torch.Tensor]:
    """Top-k components by bbox area -> [k] tables: root id, bbox, pixel
    count, bbox area, valid; invalid slots have root 0 (and 0 stats)."""
    area = stats["bbox_area"].clone()
    area[0] = 0   # exclude background
    vals, roots = top_k_lower_index(area, k)
    valid = vals > 0
    take = lambda a: torch.where(valid, a[roots], torch.zeros_like(vals))
    return {
        "root": torch.where(valid, roots.to(torch.int32),
                            torch.zeros_like(vals)),
        "bbox_area": vals,
        "count": take(stats["count"]),
        "y1": take(stats["y1"]),
        "x1": take(stats["x1"]),
        "y2": take(stats["y2"]),
        "x2": take(stats["x2"]),
        "valid": valid,
    }
