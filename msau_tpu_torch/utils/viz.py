"""Debug visualization (PIL): prediction overlays, field boxes, GT boxes.

Covers the reference's visual-debugging surface
(inference/generic_util.py:116-207, utils/draw_utils.py) without OpenCV:
class-colored mask overlays, predicted/GT field rectangles with captions,
and chargrid renderings.  All functions return PIL Images.  Host copy of
``msau_tpu.utils.viz``; PIL stays an optional import.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

try:
    from PIL import Image, ImageDraw
    _HAS_PIL = True
except Exception:  # pragma: no cover
    _HAS_PIL = False

_PALETTE = [
    (0, 0, 0), (230, 25, 75), (60, 180, 75), (255, 225, 25), (0, 130, 200),
    (245, 130, 48), (145, 30, 180), (70, 240, 240), (240, 50, 230),
    (210, 245, 60), (250, 190, 190), (0, 128, 128), (230, 190, 255),
    (170, 110, 40), (255, 250, 200), (128, 0, 0), (170, 255, 195),
    (128, 128, 0), (255, 215, 180), (0, 0, 128), (128, 128, 128),
]


def class_color(c: int) -> Tuple[int, int, int]:
    return _PALETTE[c % len(_PALETTE)]


def render_class_map(class_map: np.ndarray, alpha_bg: bool = True):
    """[H, W] int class ids -> RGB image."""
    assert _HAS_PIL, "PIL not available"
    h, w = class_map.shape
    rgb = np.zeros((h, w, 3), np.uint8)
    for c in np.unique(class_map):
        rgb[class_map == c] = class_color(int(c))
    return Image.fromarray(rgb)


def draw_rectangle(draw, box, color, width: int = 3):
    x1, y1, x2, y2 = box
    for i in range(width):
        draw.rectangle((x1 - i, y1 - i, x2 + i, y2 + i), outline=color)


def visualize_kv_results(
    class_map: np.ndarray,
    values: Sequence,
    class_names: Optional[Sequence[str]] = None,
    scale: int = 2,
    gt_boxes: Optional[Sequence[Tuple[Sequence[int], int]]] = None,
):
    """Pred overlay + per-field boxes + optional GT boxes
    (generic_util.py:116-191 equivalent, PIL-only)."""
    assert _HAS_PIL, "PIL not available"
    img = render_class_map(class_map)
    img = img.resize((img.width * scale, img.height * scale), Image.NEAREST)
    draw = ImageDraw.Draw(img)
    for c, v in enumerate(values):
        boxes = getattr(v, "boxes", None) or (v[1] if len(v) > 1 else None)
        if not boxes:
            continue
        name = class_names[c] if class_names and c < len(class_names) else str(c)
        text = getattr(v, "text", v[0])
        for b in boxes:
            sb = [int(z * scale) for z in b]
            draw_rectangle(draw, sb, "magenta")
            draw.text((sb[0], sb[3] + 2), f"{name}", fill="magenta")
            if text:
                draw.text((sb[0], sb[1] + 2), text[:24], fill="green")
    if gt_boxes:
        for box, vid in gt_boxes:
            sb = [int(z * scale) for z in box]
            draw_rectangle(draw, sb, "red")
            draw.text((sb[2] + 3, sb[1]), f"v{vid}", fill="red")
    return img


def render_chargrid(char_ids: np.ndarray):
    """[H, W] token-id grid -> grayscale-ish RGB for debugging."""
    assert _HAS_PIL, "PIL not available"
    ids = char_ids.astype(np.int64)
    rgb = np.zeros((*ids.shape, 3), np.uint8)
    nz = ids > 0
    rgb[nz, 0] = 60 + (ids[nz] * 37) % 180
    rgb[nz, 1] = 60 + (ids[nz] * 91) % 180
    rgb[nz, 2] = 60 + (ids[nz] * 53) % 180
    return Image.fromarray(rgb)
