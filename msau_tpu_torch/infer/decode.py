"""KV decoding: on-device segmentation map -> field components, host strings.

Port of ``msau_tpu.infer.decode``.  ``decode_fields_device`` runs as torch
ops on the device of its inputs — argmax, bit-packed closing, one
multiclass labelling (``ops.ccl``, the union-find CUDA kernel on a card),
per-root stats and selection, and the component x line reductions — and only
the small per-class tables reach the host, where ``extract_values`` (a host
copy of the original, pinned by tests/test_torch_host_copies.py) replays the
reference string policy.

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
from msau_tpu_torch.ops.ccl import connected_components_multiclass
from msau_tpu_torch.ops.morphology import packed_closing

INT_MAX = torch.iinfo(torch.int32).max
INT_MIN = torch.iinfo(torch.int32).min


# ---------------------------------------------------------------------------
# Device side
# ---------------------------------------------------------------------------
def _segment(src: torch.Tensor, seg: torch.Tensor, n: int, reduce: str,
             identity: int) -> torch.Tensor:
    """jax.ops.segment_{min,max}: empty segments hold the identity."""
    out = torch.full((n,), identity, dtype=src.dtype, device=src.device)
    return out.scatter_reduce(0, seg.long(), src, reduce, include_self=True)


def _first_arg(vals: torch.Tensor, largest: bool) -> torch.Tensor:
    """Index of the first max (min) along the last axis, by a unique int64
    key, whatever order the backend's argmax would break ties in."""
    n = vals.shape[-1]
    idx = torch.arange(n, device=vals.device, dtype=torch.int64)
    v = vals.to(torch.int64) if largest else -vals.to(torch.int64)
    return torch.argmax(v * n + (n - 1 - idx), dim=-1)


def _top_k_lower_index(vals: torch.Tensor, k: int):
    """``lax.top_k`` along the last axis: descending values, ties to the
    lower index."""
    n = vals.shape[-1]
    idx = torch.arange(n, device=vals.device, dtype=torch.int64)
    key = vals.to(torch.int64) * n + (n - 1 - idx)
    top, _ = torch.topk(key, k, dim=-1)
    return (top // n).to(vals.dtype), (n - 1 - top % n)


def decode_fields_device(
    pred: torch.Tensor,        # [H, W, n_class] probs or logits
    line_id: torch.Tensor,     # [H, W] int32, 1-based line ids (0 = none)
    char_id: torch.Tensor,     # [H, W] int32, 1-based char positions
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
    [H, W], as ``msau_tpu.infer.decode.decode_fields_device``.
    """
    h, w = line_id.shape
    dev = line_id.device
    hw1 = h * w + 1
    c2 = n_class - 2          # classes 0/1 are never decoded
    if c2 > 32:
        raise ValueError("packed closing supports up to 32 decodable classes")
    i32 = torch.int32
    pred_class = torch.argmax(pred, dim=-1).to(i32)
    lid_flat = line_id.reshape(-1)
    cid_flat = char_id.reshape(-1)
    nl = num_lines + 1

    one = torch.ones((), dtype=i32, device=dev)
    bits = torch.where(
        pred_class >= 2,
        torch.bitwise_left_shift(one, torch.clamp(pred_class - 2, min=0)),
        torch.zeros_like(pred_class))
    closed_bits = packed_closing(bits, (1, 3))
    # owner = lowest set bit: the lowest class wins overlapping closings
    owner = torch.full_like(closed_bits, c2)
    for b in range(c2 - 1, -1, -1):
        owner = torch.where(((closed_bits >> b) & 1) != 0,
                            torch.full_like(owner, b), owner)
    cls_map = torch.where(closed_bits != 0, owner + 2, torch.zeros_like(owner))
    labels = connected_components_multiclass(cls_map)

    # a root IS its component's raster-first pixel: existence is
    # labels.flat[r-1] == r and y1 = (r-1) // W
    lbl_flat = labels.reshape(-1)
    ar = torch.arange(hw1, dtype=i32, device=dev)
    exists = torch.cat([torch.zeros(1, dtype=torch.bool, device=dev),
                        lbl_flat == ar[1:]])
    y1 = torch.where(exists, torch.div(ar - 1, w, rounding_mode="floor"),
                     torch.zeros_like(ar))
    pix = torch.arange(h * w, dtype=i32, device=dev)
    rows_flat = torch.div(pix, w, rounding_mode="floor")
    cols_flat = pix % w
    y2 = _segment(rows_flat, lbl_flat, hw1, "amax", INT_MIN) + 1
    x1 = _segment(cols_flat, lbl_flat, hw1, "amin", INT_MAX)
    x2 = _segment(cols_flat, lbl_flat, hw1, "amax", INT_MIN) + 1
    area = torch.where(exists, (y2 - y1) * (x2 - x1), torch.zeros_like(ar))
    cls_of = torch.cat([torch.zeros(1, dtype=i32, device=dev),
                        cls_map.reshape(-1)])

    def select(cs: List[int], multiline: bool):
        ct = torch.tensor(cs, dtype=i32, device=dev)
        in_c = exists[None] & (cls_of[None] == ct[:, None])      # [nc, HW+1]
        if multiline:
            # topmost center (2*ycenter is monotone)
            ycenter2 = torch.where(in_c, (y1 + y2)[None],
                                   torch.full_like(in_c, INT_MAX, dtype=i32))
            main = _first_arg(ycenter2, largest=False)
        else:
            main = _first_arg(torch.where(in_c, area[None],
                                          torch.full_like(in_c, -1, dtype=i32)),
                              largest=True)
        rows = torch.arange(len(cs), device=dev)
        active = in_c[rows, main] & (area[main] >= min_area)
        main_bbox = torch.stack([x1[main], y1[main], x2[main], y2[main]], -1)
        main_bbox = torch.where(active[:, None], main_bbox,
                                torch.zeros_like(main_bbox))
        if not multiline:
            zk = torch.zeros((len(cs), k), dtype=i32, device=dev)
            return {
                "active": active,
                "main_bbox": main_bbox,
                "alt_bbox": torch.zeros((len(cs), k, 4), dtype=i32, device=dev),
                "alt_valid": torch.zeros((len(cs), k), dtype=torch.bool,
                                         device=dev),
                "roots": torch.cat([main[:, None].to(i32), zk], 1),
                "roots_valid": torch.cat([active[:, None], zk.bool()], 1),
            }
        is_alt = (in_c & (area > min_area)[None]
                  & (ar[None].long() != main[:, None]))
        alt_vals, alt_roots = _top_k_lower_index(
            torch.where(is_alt, area[None], torch.zeros_like(area)[None]), k)
        alt_valid = (alt_vals > 0) & active[:, None]
        alt_bbox = torch.stack([x1[alt_roots], y1[alt_roots], x2[alt_roots],
                                y2[alt_roots]], -1)
        alt_bbox = torch.where(alt_valid[..., None], alt_bbox,
                               torch.zeros_like(alt_bbox))
        return {
            "active": active,
            "main_bbox": main_bbox,
            "alt_bbox": alt_bbox,
            "alt_valid": alt_valid,
            "roots": torch.cat([main[:, None], alt_roots], 1).to(i32),
            "roots_valid": torch.cat([active[:, None], alt_valid], 1),
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
        out = torch.zeros((c2,) + tuple(proto.shape[1:]), dtype=proto.dtype,
                          device=dev)
        for ids, part in parts:
            out[torch.tensor([c - 2 for c in ids], device=dev)] = part[key]
        sel[key] = out

    # slot table: root -> global slot ci*(K+1)+j; sentinel = C2*(K+1)
    n_slots = c2 * (k + 1)
    flat_slots = torch.arange(n_slots, dtype=i32, device=dev)
    idxs = torch.where(sel["roots_valid"].reshape(-1),
                       sel["roots"].reshape(-1),
                       torch.full((n_slots,), hw1, dtype=i32, device=dev))
    slot_of_root = _segment(flat_slots, idxs, hw1 + 1, "amin", n_slots)[:hw1]
    slot_of_root[0] = n_slots
    slot_pix = slot_of_root[lbl_flat.long()]                  # [HW]
    chosen_flat = slot_pix < n_slots
    class_ix = torch.div(slot_pix, k + 1, rounding_mode="floor")

    seg_slot = torch.where(chosen_flat, slot_pix * nl + lid_flat,
                           torch.full_like(slot_pix, n_slots * nl))
    nseg = n_slots * nl + 1
    # a scatter-add, not bincount: CUDA bincount reads max() back to the host
    bucket = torch.zeros(nseg, dtype=i32, device=dev).scatter_add_(
        0, seg_slot.long(), torch.ones_like(seg_slot))[: n_slots * nl]
    present = bucket.reshape(c2, k + 1, nl) > 0
    comp_per_line = present.sum(1).to(i32)
    comp_per_line[:, 0] = 0
    line_overlap = present.any(1)
    line_overlap[:, 0] = False

    cid_min_src = torch.where(chosen_flat & (cid_flat > 0), cid_flat,
                              torch.full_like(cid_flat, INT_MAX))
    cmin_slot = _segment(cid_min_src, seg_slot, nseg, "amin", INT_MAX)
    char_min = cmin_slot[: n_slots * nl].reshape(c2, k + 1, nl).amin(1)
    char_min = torch.where(char_min == INT_MAX, torch.zeros_like(char_min),
                           char_min)
    char_min[:, 0] = 0
    cmax_src = torch.where(chosen_flat, cid_flat, torch.zeros_like(cid_flat))
    cmax_slot = _segment(cmax_src, seg_slot, nseg, "amax", INT_MIN)
    char_max = cmax_slot[: n_slots * nl].reshape(c2, k + 1, nl).amax(1)
    char_max[:, 0] = 0

    chosen_class = torch.where(chosen_flat, class_ix + 2,
                               torch.zeros_like(class_ix)).reshape(h, w)

    def pad_front(x):
        return torch.cat([torch.zeros((2,) + tuple(x.shape[1:]),
                                      dtype=x.dtype, device=dev), x], 0)

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
    """Flatten the host-bound decode tables into one int32 vector."""
    return torch.cat([dev[key].to(torch.int32).reshape(-1)
                      for key in _PACK_KEYS])


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
