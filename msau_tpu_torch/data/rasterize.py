"""Chargrid rasterization: host-side box programs + on-device painting.

Host half of ``msau_tpu.data.rasterize`` (``BoxProgram``,
``build_chargrid_programs``, ``pad_to_bucket``, ``round_up``,
``paint_boxes_numpy``), copied because that package's ``__init__`` imports
JAX; tests/test_torch_host_copies.py pins it to the original.  The host does
only the cheap O(#chars) geometry, producing *box programs* — padded arrays
of (y1, y2, x1, x2, value) records — and ``paint_boxes`` paints one plane on
the device of its tensors (``msau_tpu_torch.ops.paint``); ``paint_planes``
paints several planes through the same kernel in one call.
``assemble_chargrid_input`` and ``rasterize_train_example`` are the train
pipeline's device half: paint, then the one-hot and the two id planes.

Painting is sequential last-write-wins, exactly matching numpy slice
assignment order; empty records (y1 >= y2 or x1 >= x2) are no-ops.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from msau_tpu_torch.data.charset import Charset
from msau_tpu_torch.data.pages import Line, Page
from msau_tpu_torch.ops.paint import paint_boxes

Array = np.ndarray


# ---------------------------------------------------------------------------
# Box program representation
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class BoxProgram:
    """A list of paint operations for one plane: grid[y1:y2, x1:x2] = value."""

    boxes: Array   # int32 [B, 4] (y1, y2, x1, x2)
    values: Array  # int32 [B]

    @classmethod
    def empty(cls) -> "BoxProgram":
        return cls(np.zeros((0, 4), np.int32), np.zeros((0,), np.int32))

    @classmethod
    def from_lists(cls, boxes: List[Tuple[int, int, int, int]], values: List[int]) -> "BoxProgram":
        if not boxes:
            return cls.empty()
        return cls(np.asarray(boxes, np.int32), np.asarray(values, np.int32))

    def clipped(self, height: int, width: int) -> "BoxProgram":
        b = self.boxes.copy()
        if len(b):
            b[:, 0] = np.clip(b[:, 0], 0, height)
            b[:, 1] = np.clip(b[:, 1], 0, height)
            b[:, 2] = np.clip(b[:, 2], 0, width)
            b[:, 3] = np.clip(b[:, 3], 0, width)
        return BoxProgram(b, self.values)

    def padded(self, capacity: int) -> "BoxProgram":
        b = np.zeros((capacity, 4), np.int32)
        v = np.zeros((capacity,), np.int32)
        n = min(len(self.values), capacity)
        b[:n] = self.boxes[:n]
        v[:n] = self.values[:n]
        return BoxProgram(b, v)


def paint_boxes_numpy(program: BoxProgram, height: int, width: int) -> Array:
    """Host golden model (used by tests to pin down device semantics)."""
    grid = np.zeros((height, width), np.int32)
    for (y1, y2, x1, x2), v in zip(program.boxes, program.values):
        y1c, y2c = max(y1, 0), max(min(y2, height), 0)
        x1c, x2c = max(x1, 0), max(min(x2, width), 0)
        grid[y1c:y2c, x1c:x2c] = v
    return grid


def paint_planes(boxes: torch.Tensor, values: torch.Tensor,
                 plane_ids: torch.Tensor, height: int, width: int,
                 num_planes: int) -> torch.Tensor:
    """Paint several planes in one call -> [num_planes, H, W] int32: box i
    paints only plane ``plane_ids[i]`` (none where that is out of range),
    last write wins within a plane.

    The planes are one [num_planes * H, W] grid for ``paint_boxes`` (the
    paint kernel on a card): each box's rows are clipped to [0, H) before
    they are offset by its plane's H, so that no box spills into the next
    plane."""
    b = boxes.to(torch.int32)
    pid = plane_ids.to(torch.int32)
    y1 = b[:, 0].clamp(0, height)
    y2 = b[:, 1].clamp(0, height)
    y2 = torch.where((pid >= 0) & (pid < num_planes), y2, y1)
    off = pid.clamp(0, max(num_planes - 1, 0)) * height
    stacked = torch.stack([y1 + off, y2 + off, b[:, 2], b[:, 3]], 1)
    grid = paint_boxes(stacked.contiguous(),
                       values.to(torch.int32).contiguous(),
                       num_planes * height, width)
    return grid.reshape(num_planes, height, width)


# ---------------------------------------------------------------------------
# Geometry shared by all chargrid variants
# ---------------------------------------------------------------------------
def _page_extent(lines: Sequence[Line]):
    xs1 = [l.box[0] for l in lines]
    ys1 = [l.box[1] for l in lines]
    xs2 = [l.box[2] for l in lines]
    ys2 = [l.box[3] for l in lines]
    return min(xs1), min(ys1), max(xs2), max(ys2)


def _median_line_height(lines: Sequence[Line]) -> float:
    return float(np.median([l.box[3] - l.box[1] for l in lines]))


@dataclasses.dataclass
class ChargridPrograms:
    """Host-side output: everything the device needs to paint one page."""

    height: int
    width: int
    char: BoxProgram          # token-id plane
    char_sep: BoxProgram      # last-column-of-char plane (token ids)
    line_mask: BoxProgram     # 1-px line underline plane (0/1)
    label: BoxProgram         # class-id plane
    line_id: BoxProgram       # line-index plane (1-based)
    char_id: BoxProgram       # char-position plane (1-based)
    scaled_lines: List[Line] = dataclasses.field(default_factory=list)
    scale: float = 1.0
    pad: float = 0.0
    extent: Tuple[float, float, float, float] = (0, 0, 0, 0)


def build_chargrid_programs(
    page: Page,
    charset: Charset,
    *,
    scale_min: float = 3.0,
    scale_max: float = 3.0,
    text_err: float = 0.0,
    normalize_digits: bool = False,
    char_w_cap_factor: float = 1.0,
    pad_factor_fixed: float = 2.0,
    label_style: str = "underline",   # "underline" (train gen) | "box" (kv)
    rng: Optional[np.random.Generator] = None,
    id_planes: bool = False,
) -> ChargridPrograms:
    """Compute all paint programs for one page.

    Geometry reproduces the reference rasterizers:
      * training generator (data_generator_funsd.py:293-395): random scale in
        [scale_min, scale_max] / median_h, v/h jitter and random pad when
        scale_min != scale_max; label plane is a 1-px underline at y2-1,
        line_mask at y2; char_w capped at (y2-y1)*1.0.
      * KV inference (kv_model.py:83-148): fixed scale 3.0/median_h, pad
        3*median_h, digits normalized to '0', char_w capped at (y2-y1)*1.2,
        box-filled line_id plane and 1-based char-position plane
        (use label_style="box", char_w_cap_factor=1.2, pad_factor_fixed=3.0,
        normalize_digits=True).

    ``id_planes`` (port only) also builds the line-mask and char-sep
    programs in the "box" style, by the training generator's rule, so
    that a model trained on those two planes is served them.
    """
    rng = rng or np.random.default_rng()
    lines = page.lines
    assert lines, "page has no lines"

    min_x, min_y, max_x, max_y = _page_extent(lines)
    extent = (min_x, min_y, max_x, max_y)
    median_h = _median_line_height(lines)

    if scale_min != scale_max:
        v_scale = rng.uniform(0.8, 1.2)
        h_scale = rng.uniform(0.9, 1.1)
        pad = float(int(rng.uniform(median_h, median_h * 3)))
    else:
        v_scale = 1.0
        h_scale = 1.0
        pad = median_h * pad_factor_fixed
        if label_style == "box":
            pad = float(int(pad))

    min_x, min_y = min_x - pad, min_y - pad
    max_x, max_y = max_x + pad, max_y + pad
    scale = rng.uniform(scale_min, scale_max) / median_h if scale_min != scale_max \
        else scale_min / median_h

    w, h = max_x - min_x, max_y - min_y
    height = int(h * scale * v_scale)
    width = int(w * scale * h_scale)

    # scale all line boxes (vectorized), encode texts, then build the
    # per-char records in one vectorized pass
    from msau_tpu_torch.data.native import char_records

    scaled_lines: List[Line] = []
    sb = np.empty((len(lines), 4), np.int32)
    ids_parts: List[np.ndarray] = []
    offsets = np.zeros(len(lines) + 1, np.int32)
    for line_idx, line in enumerate(lines):
        x1, y1, x2, y2 = line.box
        x1 = int((x1 - min_x) * scale * h_scale)
        y1 = int((y1 - min_y) * scale * v_scale)
        x2 = int((x2 - min_x) * scale * h_scale)
        y2 = int((y2 - min_y) * scale * v_scale)
        sb[line_idx] = (x1, y1, x2, y2)
        scaled_lines.append(dataclasses.replace(line, box=(x1, y1, x2, y2)))
        text = line.text
        if normalize_digits:
            text = "".join("0" if c.isdigit() else c for c in text)
        ids = charset.encode(text)
        if text_err > 0 and len(ids):
            hit = rng.random(len(ids)) < text_err
            ids = np.where(
                hit, rng.integers(0, charset.n_token, len(ids)), ids
            ).astype(np.int32)
        ids_parts.append(ids)
        offsets[line_idx + 1] = offsets[line_idx] + len(ids)
    all_ids = (
        np.concatenate(ids_parts).astype(np.int32)
        if ids_parts
        else np.zeros(0, np.int32)
    )

    rec, rec_line, rec_pos = char_records(sb, offsets, all_ids, char_w_cap_factor)
    char_prog = BoxProgram(rec[:, :4].copy(), rec[:, 4].copy())

    lens = np.diff(offsets)
    has_text = lens > 0
    lx1, ly1, lx2, ly2 = sb[:, 0], sb[:, 1], sb[:, 2], sb[:, 3]
    labels_arr = np.asarray([l.label for l in lines], np.int32)

    def prog_arr(b, v):
        return BoxProgram(
            np.asarray(b, np.int32).reshape(-1, 4), np.asarray(v, np.int32)
        ).clipped(height, width)

    empty = BoxProgram.empty()

    def id_plane_programs():
        # line mask 1 px under each line (data_generator_funsd.py:368-371)
        # and each char's last column, valued by its token id
        lm = prog_arr(
            np.stack([ly2, ly2 + 1, lx1, lx2], -1)[has_text],
            np.ones(int(has_text.sum()), np.int32),
        )
        sep = BoxProgram(
            np.stack([rec[:, 0], rec[:, 1], rec[:, 3] - 1, rec[:, 3]], -1),
            rec[:, 4].copy(),
        ).clipped(height, width)
        return lm, sep

    if label_style == "underline":
        # 1-px label underline + line mask (data_generator_funsd.py:368-371)
        lab = prog_arr(
            np.stack([ly2 - 1, ly2, lx1, lx2], -1)[has_text], labels_arr[has_text]
        )
        lm, sep = id_plane_programs()
        lid = cid = empty
    else:
        # box-filled label + line-id planes (kv_model.py:136)
        lab = prog_arr(
            np.stack([ly1, ly2, lx1, lx2], -1)[has_text], labels_arr[has_text]
        )
        lm, sep = id_plane_programs() if id_planes else (empty, empty)
        # line_id plane interleaves each line's box fill with its char boxes
        # (paint order matters across overlapping lines) — stable sort on
        # (line, is_char, char_pos)
        fill_boxes = np.stack([ly1, ly2, lx1, lx2], -1)[has_text]
        fill_vals = (np.nonzero(has_text)[0] + 1).astype(np.int32)
        lid_boxes = np.concatenate([fill_boxes, rec[:, :4]], 0)
        lid_vals = np.concatenate([fill_vals, rec_line])
        key_line = np.concatenate([fill_vals, rec_line])
        key_char = np.concatenate(
            [np.zeros(len(fill_vals), np.int64), rec_pos.astype(np.int64)]
        )
        order = np.lexsort((key_char, key_line))
        lid = BoxProgram(lid_boxes[order], lid_vals[order]).clipped(height, width)
        cid = BoxProgram(rec[:, :4].copy(), rec_pos.copy()).clipped(height, width)

    return ChargridPrograms(
        height=height,
        width=width,
        char=char_prog.clipped(height, width),
        char_sep=sep,
        line_mask=lm,
        label=lab,
        line_id=lid,
        char_id=cid,
        scaled_lines=scaled_lines,
        scale=scale,
        pad=pad,
        extent=extent,
    )


# ---------------------------------------------------------------------------
# Static-shape bucketing
# ---------------------------------------------------------------------------
def bucket_dim(size: int, buckets: Sequence[int]) -> int:
    """Smallest bucket >= size (largest bucket if none fits)."""
    for b in sorted(buckets):
        if size <= b:
            return b
    return max(buckets)


def pad_to_bucket(h: int, w: int, buckets: Sequence[int]) -> Tuple[int, int]:
    return bucket_dim(h, buckets), bucket_dim(w, buckets)


def round_up(x: int, mult: int) -> int:
    return ((x + mult - 1) // mult) * mult


# ---------------------------------------------------------------------------
# Assembled device-side rasterization (the train pipeline's input)
# ---------------------------------------------------------------------------
def assemble_chargrid_input(
    char_boxes: torch.Tensor,
    char_values: torch.Tensor,
    sep_boxes: torch.Tensor,
    sep_values: torch.Tensor,
    lm_boxes: torch.Tensor,
    lm_values: torch.Tensor,
    height: int,
    width: int,
    n_token: int,
) -> torch.Tensor:
    """Paint char/sep/line planes and assemble the [H, W, n_token+2] input,
    on the device of the box programs.

    Matches the training generator's channel layout
    (data_generator_funsd.py:388-389): one-hot token grid, then the line
    mask, then the char-separator plane (one-hot is NOT applied to the
    extra planes; they carry raw values cast to float).
    """
    ids = paint_boxes(char_boxes, char_values, height, width)
    sep = paint_boxes(sep_boxes, sep_values, height, width)
    lm = paint_boxes(lm_boxes, lm_values, height, width)
    tokens = torch.arange(n_token, dtype=torch.int32, device=ids.device)
    onehot = (ids[..., None] == tokens).to(torch.float32)
    return torch.cat(
        [onehot, lm[..., None].to(torch.float32), sep[..., None].to(torch.float32)],
        dim=-1,
    )


def upload_programs(programs: Sequence[BoxProgram], device) -> List[torch.Tensor]:
    """Box programs -> [boxes, values, boxes, values, ...] tensors on
    ``device`` from ONE host->device copy of a packed int32 buffer.  Each
    program's capacity must be a multiple of 4, so that every boxes view
    starts 16-byte aligned, as the paint kernel requires."""
    parts, shapes = [], []
    for p in programs:
        if len(p.values) % 4:
            raise ValueError(f"program capacity {len(p.values)} is not a "
                             "multiple of 4")
        parts += [np.asarray(p.boxes, np.int32).ravel(),
                  np.asarray(p.values, np.int32)]
        shapes += [(len(p.values), 4), (len(p.values),)]
    buf = torch.from_numpy(np.concatenate(parts)).to(device)
    out, o = [], 0
    for shape in shapes:
        n = int(np.prod(shape))
        out.append(buf[o:o + n].view(shape))
        o += n
    return out


def rasterize_train_example(
    page: Page,
    charset: Charset,
    n_classes: int,
    *,
    buckets: Sequence[int] = (256, 512, 1024),
    max_chars: int = 8192,
    scale_min: float = 3.0,
    scale_max: float = 3.0,
    text_err: float = 0.0,
    rng: Optional[np.random.Generator] = None,
    device,
) -> Dict[str, torch.Tensor]:
    """Full train-pipeline rasterization of one page to static bucket
    shapes, painted on ``device`` (4 paint calls: char, sep, line mask,
    label).

    Returns dict with:
      input  [H, W, n_token+2] float32
      label  [H, W] int32 class ids (0 = background/ignore)
      valid  [H, W] bool (True inside the un-padded page area)
    """
    del n_classes  # the label plane carries the class ids as painted
    progs = build_chargrid_programs(
        page, charset, scale_min=scale_min, scale_max=scale_max,
        text_err=text_err, label_style="underline", rng=rng,
    )
    hb, wb = pad_to_bucket(progs.height, progs.width, buckets)
    cap = round_up(max(len(progs.char.values), 1), 512)
    cap = min(cap, max_chars)
    lcap = round_up(max(len(progs.line_mask.values), 1), 128)
    cb, cv, sb, sv, lb, lv, ab, av = upload_programs(
        [progs.char.padded(cap), progs.char_sep.padded(cap),
         progs.line_mask.padded(lcap), progs.label.padded(lcap)], device)
    inp = assemble_chargrid_input(cb, cv, sb, sv, lb, lv, hb, wb,
                                  charset.n_token)
    label = paint_boxes(ab, av, hb, wb)
    dev = inp.device
    rows = torch.arange(hb, device=dev)[:, None]
    cols = torch.arange(wb, device=dev)[None, :]
    valid = (rows < progs.height) & (cols < progs.width)
    return {"input": inp, "label": label, "valid": valid}
