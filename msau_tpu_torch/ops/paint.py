"""Box-program painting into an int32 [H, W] grid, last write wins.

``paint_boxes`` is the entry point: a CUDA tensor launches the hand-written
kernels (``csrc/paint.cu``, the port of the TPU kernel
``msau_tpu/ops/paint_pallas.py:_paint_kernel``: the largest covering box
index scattered by atomic maximum, then mapped to its value); a CPU tensor
takes ``paint_boxes_plain``, the masked-select loop of
``msau_tpu.data.rasterize.paint_boxes``.
"""

from __future__ import annotations

import torch

from msau_tpu_torch.ops import cuda_lib


def paint_boxes_plain(boxes: torch.Tensor, values: torch.Tensor,
                      height: int, width: int) -> torch.Tensor:
    """Sequential ``grid[y1:y2, x1:x2] = v`` over the box list, as masked
    selects (the semantics of every rasterizing loop in the reference)."""
    dev = boxes.device
    rows = torch.arange(height, device=dev, dtype=torch.int32)[:, None]
    cols = torch.arange(width, device=dev, dtype=torch.int32)[None, :]
    grid = torch.zeros((height, width), dtype=torch.int32, device=dev)
    for (y1, y2, x1, x2), v in zip(boxes.tolist(), values.tolist()):
        if y2 <= y1 or x2 <= x1:
            continue
        mask = (rows >= y1) & (rows < y2) & (cols >= x1) & (cols < x2)
        grid = torch.where(mask, torch.tensor(v, dtype=torch.int32,
                                              device=dev), grid)
    return grid


def paint_boxes_cuda(boxes: torch.Tensor, values: torch.Tensor,
                     height: int, width: int) -> torch.Tensor:
    """Launch the paint kernels (clear, scatter, map) as one call;
    ``paint_boxes_cuda.launches`` counts calls."""
    cuda_lib.require_cuda("paint_boxes", boxes, torch.int32, 2)
    cuda_lib.require_cuda("paint_boxes", values, torch.int32, 1)
    n = boxes.shape[0]
    if boxes.shape[1] != 4 or values.shape[0] != n:
        raise ValueError(f"paint_boxes: boxes {tuple(boxes.shape)} / values "
                         f"{tuple(values.shape)} mismatch")
    if boxes.data_ptr() % 16:
        raise ValueError("paint_boxes: boxes must be 16-byte aligned")
    if height * width >= 2**31:
        raise ValueError("paint_boxes: grid too large")
    if values.device != boxes.device:
        raise ValueError("paint_boxes: boxes and values on different devices")
    out = torch.empty((height, width), dtype=torch.int32, device=boxes.device)
    lib = cuda_lib.library()
    code = lib.msau_paint_boxes(
        boxes.data_ptr(), values.data_ptr(), n, out.data_ptr(), height, width,
        cuda_lib.stream_ptr(boxes.device))
    cuda_lib.check("msau_paint_boxes", code)
    paint_boxes_cuda.launches += 1
    return out


paint_boxes_cuda.launches = 0


def paint_boxes(boxes: torch.Tensor, values: torch.Tensor,
                height: int, width: int) -> torch.Tensor:
    """Paint ``boxes`` ([B, 4] int32 (y1, y2, x1, x2)) with ``values`` ([B]
    int32) in order; the device of ``boxes`` picks the implementation."""
    if boxes.device.type == "cuda":
        return paint_boxes_cuda(boxes, values, height, width)
    if boxes.device.type != "cpu":
        raise ValueError(f"paint_boxes: unsupported device {boxes.device}")
    return paint_boxes_plain(boxes, values, height, width)
