"""Feature-grid rasterization: dense per-cell feature vectors painted into
cell boxes (port of ``msau_tpu.data.featgrid``).

Each OCR cell's feature vector (sentence embedding, bag of words) fills the
cell's rectangle on a cell-unit grid; labels fill the same rectangles
("box") or only the top-left pixel ("box_mask_px_label", "px").  The host
builds box programs of a [H, W] int32 cell-index grid and a label grid;
``ops.paint`` paints both on the device of the caller's choice (the paint
kernel on a card), and one gather (``gather_features``) turns the index
grid into the [H, W, D] feature grid there.  The grids are not padded.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from msau_tpu_torch.data.rasterize import BoxProgram
from msau_tpu_torch.data.wordgrid import WordGridExample
from msau_tpu_torch.ops.paint import paint_boxes


def cell_unit_layout(boxes: np.ndarray) -> Tuple[float, float, float, float, int, int]:
    """(min_x, min_y, min_w, min_h, H, W) of the cell-unit grid of ``boxes``
    [N, 4] xywh."""
    x, y, w, h = boxes.T
    min_x, min_y = float(x.min()), float(y.min())
    max_x = float((x + w).max())
    max_y = float((y + h).max())
    min_w, min_h = float(w.min()), float(h.min())
    width = int((max_x - min_x) / min_w) + 1
    height = int((max_y - min_y) / min_h) + 1
    return min_x, min_y, min_w, min_h, height, width


def cell_index_programs(
    boxes: np.ndarray,          # [N, 4] xywh
    labels: Optional[np.ndarray] = None,
    style: str = "box",         # "box" | "box_mask_px_label" | "px"
) -> Tuple[int, int, BoxProgram, BoxProgram]:
    """(H, W, cell-index program, label program) for the three reference
    loaders:

    * "box": features and labels fill the cell rectangles;
    * "box_mask_px_label": features fill the rectangles, labels only the
      top-left pixel;
    * "px": features and labels only at the top-left pixel.
    """
    min_x, min_y, min_w, min_h, height, width = cell_unit_layout(boxes)
    x, y, w, h = boxes.T
    nx = ((x - min_x) / min_w).astype(np.int64)
    ny = ((y - min_y) / min_h).astype(np.int64)
    nw = np.maximum((w / min_w).astype(np.int64), 1)
    nh = np.maximum((h / min_h).astype(np.int64), 1)

    if style == "px":
        idx_boxes = np.stack([ny, ny + 1, nx, nx + 1], -1)
    else:
        idx_boxes = np.stack([ny, ny + nh, nx, nx + nw], -1)
    idx_vals = np.arange(1, len(boxes) + 1)
    idx_prog = BoxProgram(
        idx_boxes.astype(np.int32), idx_vals.astype(np.int32)
    ).clipped(height, width)

    if labels is None:
        lab_prog = BoxProgram.empty()
    else:
        if style == "box":
            lab_boxes = np.stack([ny, ny + nh, nx, nx + nw], -1)
        else:
            lab_boxes = np.stack([ny, ny + 1, nx, nx + 1], -1)
        lab_prog = BoxProgram(
            lab_boxes.astype(np.int32), (np.asarray(labels) + 1).astype(np.int32)
        ).clipped(height, width)
    return height, width, idx_prog, lab_prog


def gather_features(idx_grid: torch.Tensor, feats: torch.Tensor) -> torch.Tensor:
    """[H, W] int cell ids (1-based; 0 = background) + [N, D] features ->
    [H, W, D] on their device; background rows are zero."""
    padded = torch.cat([feats.new_zeros((1, feats.shape[1])), feats])
    return padded[idx_grid.long()]


def rasterize_feature_example(
    ex: WordGridExample,
    feats: np.ndarray,                 # [n_lines, D] per-cell features
    style: str = "box",
    *,
    device,
) -> Dict[str, np.ndarray]:
    """A feature-grid example from the text-line cells, painted and
    gathered on ``device`` -> {"input": [H, W, D] f32, "label": [H, W]
    int32, "valid": [H, W] bool}, numpy."""
    if len(ex.line_boxes) != len(feats):
        raise ValueError(f"{len(ex.line_boxes)} cells but {len(feats)} "
                         "feature vectors")
    h, w, idx_prog, lab_prog = cell_index_programs(
        ex.line_boxes, ex.labels, style=style
    )

    def paint(prog):
        return paint_boxes(torch.from_numpy(prog.boxes).to(device),
                           torch.from_numpy(prog.values).to(device), h, w)

    grid = gather_features(paint(idx_prog), torch.as_tensor(
        np.asarray(feats, np.float32), device=device))
    return {
        "input": grid.cpu().numpy(),
        "label": paint(lab_prog).cpu().numpy(),
        "valid": np.ones((h, w), bool),
    }
