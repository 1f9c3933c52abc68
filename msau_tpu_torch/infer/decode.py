"""KV decoding: on-device segmentation map -> field components, host strings.

Port of ``msau_tpu.infer.decode``.  ``decode_fields_device`` runs as torch
ops on the device of its inputs — argmax, bit-packed closing, one
multiclass labelling (``ops.ccl``, the union-find CUDA kernel on a card),
per-root stats and selection, and the component x line reductions — and only
the small per-class tables reach the host, where ``extract_values`` (a host
copy of the original, pinned by tests/test_torch_host_copies.py) replays the
reference string policy.  A stack of pages ([B, H, W, C] probabilities)
decodes in one pass with one labelling launch, every table gaining a
leading B (``jax.vmap`` of the JAX decoder), and ``pack_decode_out`` packs
it as [B, L].

Tie rules kept from the JAX decoder:
  * argmax over classes takes the first maximum;
  * the owner of a pixel where several classes' closings overlap is the
    lowest class (the lowest set bit of the packed mask);
  * the largest-bbox and topmost components are the first (lowest root)
    among equals;
  * the multi-line alt components are the top k by bbox area with ties
    going to the LOWER root, as ``lax.top_k`` breaks them.  ``torch.topk``
    promises no tie order, so the selection runs on a unique int64 key
    (area first, then the lower root).

Known divergence from the JAX decoder: the labelling runs to convergence,
with no sweep cap (the union-find kernel has none; the CPU plain version
iterates to its fixpoint).  The JAX decoder's Pallas CCL stops after
``4 * max_iters`` sweeps and has no pointer jumping, so on a maze-like
argmax map it can return components still split; there the tables differ.
On every map where the JAX labelling converged they are identical.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from msau_tpu_torch.infer.reading_order import sort_box_reading_order
from msau_tpu_torch.infer.schema import FieldSchema
from msau_tpu_torch.ops.ccl import (
    connected_components_multiclass,
    segment_reduce,
    top_k_lower_index,
)
from msau_tpu_torch.ops.morphology import packed_closing

INT_MAX = torch.iinfo(torch.int32).max
INT_MIN = torch.iinfo(torch.int32).min


# ---------------------------------------------------------------------------
# Device side
# ---------------------------------------------------------------------------
def _first_arg(vals: torch.Tensor, largest: bool) -> torch.Tensor:
    """int32 index of the first max (min) along the last axis, whatever
    order the backend's argmax would break ties in: the extreme, then the
    least index holding it (int32 temporaries only)."""
    n = vals.shape[-1]
    ext = (vals.amax(-1, keepdim=True) if largest
           else vals.amin(-1, keepdim=True))
    idx = torch.arange(n, dtype=torch.int32, device=vals.device)
    return torch.where(vals == ext, idx, n).amin(-1)


def decode_fields_device(
    pred: torch.Tensor,        # [H, W, n_class] or [B, H, W, n_class]
    line_id: torch.Tensor,     # [H, W] / [B, H, W] int32, 1-based line ids
    char_id: torch.Tensor,     # [H, W] / [B, H, W] int32, 1-based char pos.
    multiline_classes: Tuple[int, ...] = (),
    *,
    n_class: int,
    num_lines: int,
    k: int = 8,
    min_area: int = 5,
) -> Dict[str, torch.Tensor]:
    """Per-class component selection + line/char reductions on the device.

    Returns (leading dim n_class): active [C], main_bbox [C, 4] (x1, y1, x2,
    y2), alt_bbox [C, K, 4], alt_valid [C, K], line_overlap [C, L+1],
    comp_per_line [C, L+1], char_min / char_max [C, L+1], and chosen_class
    [H, W], as ``msau_tpu.infer.decode.decode_fields_device``.  With a
    leading page axis on the inputs every table has a leading B, as
    ``jax.vmap`` of that function gives: one closing, one labelling launch
    and one set of segment reductions for all pages.
    """
    if line_id.ndim == 2:
        out = _decode_pages(pred[None], line_id[None], char_id[None],
                            multiline_classes, n_class=n_class,
                            num_lines=num_lines, k=k, min_area=min_area)
        return {key: v[0] for key, v in out.items()}
    return _decode_pages(pred, line_id, char_id, multiline_classes,
                         n_class=n_class, num_lines=num_lines, k=k,
                         min_area=min_area)


def _decode_pages(pred, line_id, char_id, multiline_classes, *, n_class,
                  num_lines, k, min_area):
    """``decode_fields_device`` on [B, ...] inputs.  Per-page tables of H*W
    + 1 roots are reduced as one flat table, each page's ids offset by
    b * (H*W + 1) (and the (slot, line) ids by b * the page's segment
    count), so that no reduction mixes pages."""
    b, h, w = line_id.shape
    dev = line_id.device
    hw = h * w
    hw1 = hw + 1
    c2 = n_class - 2          # classes 0/1 are never decoded
    if c2 > 32:
        raise ValueError("packed closing supports up to 32 decodable classes")
    i32 = torch.int32
    pred_class = torch.argmax(pred, dim=-1).to(i32)
    lid_flat = line_id.reshape(b, hw)
    cid_flat = char_id.reshape(b, hw)
    nl = num_lines + 1
    pages = torch.arange(b, dtype=torch.int64, device=dev)[:, None]

    one = torch.ones((), dtype=i32, device=dev)
    bits = torch.where(
        pred_class >= 2,
        torch.bitwise_left_shift(one, torch.clamp(pred_class - 2, min=0)),
        torch.zeros_like(pred_class))
    closed_bits = packed_closing(bits, (1, 3))
    # owner = lowest set bit: the lowest class wins overlapping closings
    owner = torch.full_like(closed_bits, c2)
    for bit in range(c2 - 1, -1, -1):
        owner = torch.where(((closed_bits >> bit) & 1) != 0,
                            torch.full_like(owner, bit), owner)
    cls_map = torch.where(closed_bits != 0, owner + 2, torch.zeros_like(owner))
    del bits, closed_bits, owner
    labels = connected_components_multiclass(cls_map)   # page-local labels

    # a root IS its component's raster-first pixel: existence is
    # labels.flat[r-1] == r and y1 = (r-1) // W
    lbl_flat = labels.reshape(b, hw)
    ar = torch.arange(hw1, dtype=i32, device=dev)
    exists = torch.cat([torch.zeros((b, 1), dtype=torch.bool, device=dev),
                        lbl_flat == ar[1:]], 1)                  # [B, HW+1]
    y1 = torch.where(exists, torch.div(ar - 1, w, rounding_mode="floor"),
                     torch.zeros_like(ar))
    pix = torch.arange(hw, dtype=i32, device=dev)
    rows_flat = torch.div(pix, w, rounding_mode="floor").expand(b, hw)
    cols_flat = (pix % w).expand(b, hw)
    root_seg = (lbl_flat + pages * hw1).reshape(-1)

    def per_root(src, reduce, identity):
        return segment_reduce(src.reshape(-1), root_seg, b * hw1, reduce,
                              identity).view(b, hw1)

    y2 = per_root(rows_flat, "amax", INT_MIN) + 1
    x1 = per_root(cols_flat, "amin", INT_MAX)
    x2 = per_root(cols_flat, "amax", INT_MIN) + 1
    area = torch.where(exists, (y2 - y1) * (x2 - x1), torch.zeros_like(y1))
    cls_of = torch.cat([torch.zeros((b, 1), dtype=i32, device=dev),
                        cls_map.reshape(b, hw)], 1)

    def select(cs: List[int], multiline: bool):
        nc = len(cs)
        ct = torch.tensor(cs, dtype=i32, device=dev)
        # [B, nc, HW+1] masks and int32 keys, freed when this returns
        in_c = exists[:, None] & (cls_of[:, None] == ct[None, :, None])
        if multiline:
            # topmost center (2*ycenter is monotone)
            main = _first_arg(torch.where(in_c, (y1 + y2)[:, None], INT_MAX),
                              largest=False)
        else:
            main = _first_arg(torch.where(in_c, area[:, None], -1),
                              largest=True)
        main_l = main.long()                                    # [B, nc]
        take = lambda t: torch.gather(t, 1, main_l)
        active = (torch.gather(in_c, 2, main_l[..., None])[..., 0]
                  & (take(area) >= min_area))
        main_bbox = torch.stack([take(x1), take(y1), take(x2), take(y2)], -1)
        main_bbox = torch.where(active[..., None], main_bbox,
                                torch.zeros_like(main_bbox))
        if not multiline:
            zk = torch.zeros((b, nc, k), dtype=i32, device=dev)
            return {
                "active": active,
                "main_bbox": main_bbox,
                "alt_bbox": torch.zeros((b, nc, k, 4), dtype=i32, device=dev),
                "alt_valid": zk.bool(),
                "roots": torch.cat([main[..., None], zk], -1),
                "roots_valid": torch.cat([active[..., None], zk.bool()], -1),
            }
        is_alt = (in_c & (area > min_area)[:, None]
                  & (ar[None, None] != main[..., None]))
        del in_c
        alt_vals, alt_roots = top_k_lower_index(
            torch.where(is_alt, area[:, None], 0), k)           # [B, nc, k]
        del is_alt
        alt_valid = (alt_vals > 0) & active[..., None]
        take_k = lambda t: torch.gather(t, 1, alt_roots.reshape(b, -1)
                                        ).reshape(b, nc, k)
        alt_bbox = torch.stack([take_k(x1), take_k(y1), take_k(x2),
                                take_k(y2)], -1)
        alt_bbox = torch.where(alt_valid[..., None], alt_bbox,
                               torch.zeros_like(alt_bbox))
        return {
            "active": active,
            "main_bbox": main_bbox,
            "alt_bbox": alt_bbox,
            "alt_valid": alt_valid,
            "roots": torch.cat([main[..., None], alt_roots.to(i32)], -1),
            "roots_valid": torch.cat([active[..., None], alt_valid], -1),
        }

    ml_ids = sorted(c for c in set(multiline_classes) if 2 <= c < n_class)
    simple_ids = [c for c in range(2, n_class) if c not in ml_ids]
    parts = []
    if simple_ids:
        parts.append((simple_ids, select(simple_ids, False)))
    if ml_ids:
        parts.append((ml_ids, select(ml_ids, True)))
    sel = {}
    for key in ("active", "main_bbox", "alt_bbox", "alt_valid", "roots",
                "roots_valid"):
        proto = parts[0][1][key]
        out = torch.zeros((b, c2) + tuple(proto.shape[2:]), dtype=proto.dtype,
                          device=dev)
        for ids, part in parts:
            out[:, torch.tensor([c - 2 for c in ids], device=dev)] = part[key]
        sel[key] = out

    # slot table: root -> global slot ci*(K+1)+j; sentinel = C2*(K+1); a
    # page's table is H*W+1 roots and one slot for the invalid ones
    n_slots = c2 * (k + 1)
    flat_slots = torch.arange(n_slots, dtype=i32, device=dev).expand(b, n_slots)
    idxs = torch.where(sel["roots_valid"].reshape(b, n_slots),
                       sel["roots"].reshape(b, n_slots),
                       torch.full((b, n_slots), hw1, dtype=i32, device=dev))
    slot_of_root = segment_reduce(
        flat_slots.reshape(-1), (idxs + pages * (hw1 + 1)).reshape(-1),
        b * (hw1 + 1), "amin", n_slots).view(b, hw1 + 1)[:, :hw1].clone()
    slot_of_root[:, 0] = n_slots
    slot_pix = torch.gather(slot_of_root, 1, lbl_flat.long())    # [B, HW]
    chosen_flat = slot_pix < n_slots
    class_ix = torch.div(slot_pix, k + 1, rounding_mode="floor")

    seg_slot = torch.where(chosen_flat, slot_pix * nl + lid_flat,
                           torch.full_like(slot_pix, n_slots * nl))
    nseg = n_slots * nl + 1
    seg_all = (seg_slot + pages * nseg).reshape(-1)

    def per_slot_line(src, reduce, identity):
        """[B, C2, K+1, L+1] reductions over each page's (slot, line)."""
        out = segment_reduce(src.reshape(-1), seg_all, b * nseg, reduce,
                             identity).view(b, nseg)
        return out[:, : n_slots * nl].reshape(b, c2, k + 1, nl)

    # a scatter-add, not bincount: CUDA bincount reads max() back to the host
    present = per_slot_line(torch.ones_like(seg_slot), "sum", 0) > 0
    comp_per_line = present.sum(2).to(i32)
    comp_per_line[:, :, 0] = 0
    line_overlap = present.any(2)
    line_overlap[:, :, 0] = False

    cid_min_src = torch.where(chosen_flat & (cid_flat > 0), cid_flat,
                              torch.full_like(cid_flat, INT_MAX))
    char_min = per_slot_line(cid_min_src, "amin", INT_MAX).amin(2)
    char_min = torch.where(char_min == INT_MAX, torch.zeros_like(char_min),
                           char_min)
    char_min[:, :, 0] = 0
    cmax_src = torch.where(chosen_flat, cid_flat, torch.zeros_like(cid_flat))
    char_max = per_slot_line(cmax_src, "amax", INT_MIN).amax(2)
    char_max[:, :, 0] = 0

    chosen_class = torch.where(chosen_flat, class_ix + 2,
                               torch.zeros_like(class_ix)).reshape(b, h, w)

    def pad_front(x):
        return torch.cat([torch.zeros((b, 2) + tuple(x.shape[2:]),
                                      dtype=x.dtype, device=dev), x], 1)

    return {
        "active": pad_front(sel["active"]),
        "main_bbox": pad_front(sel["main_bbox"]),
        "alt_bbox": pad_front(sel["alt_bbox"]),
        "alt_valid": pad_front(sel["alt_valid"]),
        "line_overlap": pad_front(line_overlap),
        "comp_per_line": pad_front(comp_per_line),
        "char_min": pad_front(char_min),
        "char_max": pad_front(char_max),
        "chosen_class": chosen_class.to(i32),
    }


# ---------------------------------------------------------------------------
# Packing: one device->host transfer for all decode tables
# ---------------------------------------------------------------------------
_PACK_KEYS = (
    "active", "main_bbox", "alt_bbox", "alt_valid",
    "line_overlap", "comp_per_line", "char_min", "char_max",
)


def _pack_shapes(n_class: int, k: int, num_lines: int):
    nl = num_lines + 1
    return {
        "active": (n_class,),
        "main_bbox": (n_class, 4),
        "alt_bbox": (n_class, k, 4),
        "alt_valid": (n_class, k),
        "line_overlap": (n_class, nl),
        "comp_per_line": (n_class, nl),
        "char_min": (n_class, nl),
        "char_max": (n_class, nl),
    }


def pack_decode_out(dev: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Flatten the host-bound decode tables into one int32 vector, or into
    [B, L] where the tables have a page axis."""
    lead = tuple(dev["active"].shape[:-1])   # () or (B,)
    return torch.cat([dev[key].to(torch.int32).reshape(lead + (-1,))
                      for key in _PACK_KEYS], -1)


def unpack_decode_out(
    vec: np.ndarray, n_class: int, k: int, num_lines: int
) -> Dict[str, np.ndarray]:
    shapes = _pack_shapes(n_class, k, num_lines)
    out: Dict[str, np.ndarray] = {}
    pos = 0
    for key in _PACK_KEYS:
        shape = shapes[key]
        size = int(np.prod(shape))
        out[key] = np.asarray(vec[pos : pos + size]).reshape(shape)
        pos += size
    assert pos == vec.size, (pos, vec.size)
    return out


# ---------------------------------------------------------------------------
# Host side (copy of msau_tpu.infer.decode's host half)
# ---------------------------------------------------------------------------
class FieldValue(NamedTuple):
    text: str
    boxes: Optional[List[List[int]]]
    intersect_box: Optional[List[int]]
    union_box: Optional[List[int]]


def _union(boxes):
    if not boxes:
        return None
    arr = np.asarray(boxes)
    return [int(arr[:, 0].min()), int(arr[:, 1].min()), int(arr[:, 2].max()), int(arr[:, 3].max())]


def _intersect(boxes):
    if not boxes:
        return None
    arr = np.asarray(boxes)
    return [int(arr[:, 0].max()), int(arr[:, 1].max()), int(arr[:, 2].min()), int(arr[:, 3].min())]


def extract_values(
    device_out: Dict[str, np.ndarray],
    scaled_lines: Sequence,         # Line records with scaled boxes, 1-based ids
    schema: FieldSchema,
) -> List[FieldValue]:
    """Replay the reference string-assembly policy (kv_model.py:220-261) over
    the per-class device outputs."""
    n_class = schema.n_class
    active = np.asarray(device_out["active"])
    overlap = np.asarray(device_out["line_overlap"])
    comp_per_line = np.asarray(device_out["comp_per_line"])
    char_min = np.asarray(device_out["char_min"])
    char_max = np.asarray(device_out["char_max"])
    main_bbox = np.asarray(device_out["main_bbox"])
    alt_bbox = np.asarray(device_out["alt_bbox"])
    alt_valid = np.asarray(device_out["alt_valid"])

    num_lines = len(scaled_lines)
    values: List[FieldValue] = [FieldValue("", None, None, None)] * n_class

    # line_used_count: one per selected component overlapping the line
    # (kv_model.py:214-216), summed over counted classes
    line_used = np.zeros(overlap.shape[1], np.int64)
    for c in range(2, n_class):
        if not active[c] or c in schema.non_count_overlap_fields:
            continue
        line_used += comp_per_line[c]

    # 1-based position of each line record, for Line objects without an id
    pos_of = {id(line): i + 1 for i, line in enumerate(scaled_lines)}

    for c in range(2, n_class):
        if not active[c]:
            continue
        line_ids = [l for l in range(1, min(num_lines + 1, overlap.shape[1])) if overlap[c, l]]
        if not line_ids:
            continue
        lines = sort_box_reading_order([scaled_lines[i - 1] for i in line_ids])
        value = ""
        line_boxes = []
        for line in lines:
            lid = getattr(line, "id", None)
            if lid is None or lid < 0:
                lid = pos_of[id(line)]
            line_boxes.append(list(line.box))
            text = line.text
            if line_used[lid] <= 1:
                value += text
            else:
                cmin, cmax = int(char_min[c, lid]), int(char_max[c, lid])
                if cmax == 0:
                    continue
                if cmax > len(text) - 3:
                    cmax = len(text) + 1
                value += text[cmin - 2 if cmin >= 2 else 0 : cmax - 1]
            if c in schema.contain_one_line_fields and len(value) > 2:
                break
            if c in schema.multiple_lines_fields:
                value += "\n"
        if value.endswith("\n"):
            value = value[:-1]

        field_boxes = [list(map(int, alt_bbox[c, j])) for j in range(alt_bbox.shape[1]) if alt_valid[c, j]]
        field_boxes.append(list(map(int, main_bbox[c])))
        merged = _union(line_boxes)
        inter = _intersect(field_boxes + [merged])
        union = _union(field_boxes + [merged])
        # committed reference keeps only the main component box
        # (kv_model.py:255); all_component_boxes opts into the variant where
        # every qualifying component box is reported
        boxes_out = field_boxes if schema.all_component_boxes else [field_boxes[-1]]
        values[c] = FieldValue(value, boxes_out, inter, union)

    return values
