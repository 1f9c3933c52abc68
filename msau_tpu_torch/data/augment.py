"""Geometric augmentation for chargrid stacks: warps on the tensor's device.

Port of ``msau_tpu.data.augment``.  Reference behavior
(utils/image_util.py:22-90, applied to the concatenated input/target stack
in data_generator_text.py:303-344):

* random affine: 3-point correspondence jittered by alpha_affine px;
* elastic (Simard2003): coarse (H//25, W//25) random fields, gaussian
  smoothed, upsampled bicubic, scaled by elastic_value * min(H, W);
* after warping, channels are re-binarized and one-hot consistency is
  restored with a dominating channel.

The warps reproduce the JAX package's arithmetic, since the results are
thresholded at 0.25 and 0.5 and a moved ulp can flip a pixel:

* sampling is ``jax.scipy.ndimage.map_coordinates`` with ``cval`` 0:
  nearest (``order=0``) rounds half away from zero (``torch.round`` and
  ``grid_sample`` round half to even), linear (``order=1``) sums four
  gathered taps, each tested for validity, in the JAX order; the source
  coordinates are computed as ``m00 * gy + m01 * gx + m02`` in f32, not
  through ``grid_sample``'s [-1, 1] mapping.  Where the JAX package's
  compiled CPU program fuses a multiply into an add of a coordinate (its
  second product, the elastic displacement), the port rounds once too
  (``_fma``, in f64 on the [H, W] coordinates only), on every device; the
  taps are summed in f32 as separate products and sums, so every device
  gives the same values, within a few ulps of JAX's fused sums;
* the elastic fields are upsampled as ``jax.image.resize(method="cubic")``
  does: the Keys kernel with a = -0.5, half-pixel centres, taps outside
  the input dropped and the weights renormalised (``F.interpolate``'s
  bicubic takes a = -0.75 with clamped borders), applied as two products.

Randomness is drawn on the host from a numpy Generator (the same draws as
the JAX package for the same seed); ``random_affine_matrix``,
``elastic_fields``, ``rotated_canvas``, ``rotation_matrix`` and
``sample_rotation`` are host copies, pinned to the originals by
tests/test_torch_host_copies.py.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

BINARIZE_THRESHOLD = 0.25


def random_affine_matrix(
    shape: Tuple[int, int], affine_value: float, rng: np.random.Generator
) -> np.ndarray:
    """3-point-correspondence affine, jitter ~ U(-a, a) with
    a = min(H, W) * affine_value (image_util.py:38-50).  Returns the 2x3
    output->input matrix."""
    h, w = shape
    alpha = min(h, w) * affine_value
    center = np.array([h // 2, w // 2], np.float32)
    sq = min(h, w) // 3
    pts1 = np.float32(
        [center + sq, [center[0] + sq, center[1] - sq], center - sq]
    )
    pts2 = pts1 + rng.uniform(-alpha, alpha, pts1.shape).astype(np.float32)
    # least squares for x' = A x + b
    a_rows, b_vals = [], []
    for src, dst in zip(pts1, pts2):
        a_rows.append([src[0], 0, src[1], 0, 1, 0])
        a_rows.append([0, src[0], 0, src[1], 0, 1])
        b_vals.extend(dst)
    sol, *_ = np.linalg.lstsq(np.asarray(a_rows), np.asarray(b_vals), rcond=None)
    a0, a1, a2, a3, a4, a5 = sol
    return np.float32([[a0, a2, a4], [a1, a3, a5]])


def _round_half_away(x: torch.Tensor) -> torch.Tensor:
    """Round to the nearest integer, halves away from zero (``lax.round``);
    ``x - trunc(x)`` is exact, so no half is misread."""
    t = torch.trunc(x)
    step = torch.where((x - t).abs() >= 0.5, torch.sign(x),
                       torch.zeros((), dtype=x.dtype, device=x.device))
    return t + step


def _fma(a, b, c: torch.Tensor) -> torch.Tensor:
    """f32 ``a * b + c`` with one rounding, as the JAX package's compiled
    CPU program computes the source coordinates (its multiply-adds are
    fused): the f64 product of two f32 values is exact, so only the sum
    is rounded, then rounded again to f32 (the two roundings disagree
    only on exact f32 ties of the f64 sum)."""
    f64 = lambda t: torch.as_tensor(t).to(device=c.device, dtype=torch.float64)
    return (f64(a) * f64(b) + f64(c)).to(torch.float32)


def _map_coordinates(stack: torch.Tensor, src_y: torch.Tensor,
                     src_x: torch.Tensor, order: int) -> torch.Tensor:
    """``map_coordinates`` of every channel of [H, W, C] ``stack`` at
    ([oh, ow] f32) ``src_y``, ``src_x``, mode constant, cval 0 ->
    [oh, ow, C]."""
    h, w = stack.shape[:2]
    zero = torch.zeros((), dtype=stack.dtype, device=stack.device)

    def tap(iy, ix):
        valid = (iy >= 0) & (iy < h) & (ix >= 0) & (ix < w)
        v = stack[iy.clamp(0, h - 1), ix.clamp(0, w - 1)]
        return torch.where(valid[..., None], v, zero)

    if order == 0:
        iy = _round_half_away(src_y).to(torch.int64)
        ix = _round_half_away(src_x).to(torch.int64)
        return tap(iy, ix)
    if order != 1:
        raise NotImplementedError("map_coordinates: order must be 0 or 1")
    ly, lx = torch.floor(src_y), torch.floor(src_x)
    wy1, wx1 = src_y - ly, src_x - lx
    wy0, wx0 = 1 - wy1, 1 - wx1
    iy, ix = ly.to(torch.int64), lx.to(torch.int64)
    # itertools.product order of the JAX taps, summed left to right
    out = (wy0 * wx0)[..., None] * tap(iy, ix)
    out = out + (wy0 * wx1)[..., None] * tap(iy, ix + 1)
    out = out + (wy1 * wx0)[..., None] * tap(iy + 1, ix)
    return out + (wy1 * wx1)[..., None] * tap(iy + 1, ix + 1)


def _grid(h: int, w: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    gy = torch.arange(h, dtype=torch.float32, device=device)[:, None]
    gx = torch.arange(w, dtype=torch.float32, device=device)[None, :]
    return gy.expand(h, w), gx.expand(h, w)


def apply_affine(
    stack: torch.Tensor,
    matrix,
    order: int = 1,
    out_shape: Optional[Tuple[int, int]] = None,
) -> torch.Tensor:
    """Warp [H, W, C] with a 2x3 output->input affine (cval 0), on the
    stack's device.

    ``order=0`` (nearest) preserves id-valued planes; ``order=1`` for
    one-hot/soft planes.  ``out_shape`` renders onto a different canvas
    (used by rotation, whose bounding box grows).
    """
    oh, ow = out_shape or stack.shape[:2]
    m = torch.as_tensor(np.asarray(matrix, np.float32)
                        if not isinstance(matrix, torch.Tensor) else matrix,
                        dtype=torch.float32).to(stack.device)
    gy, gx = _grid(oh, ow, stack.device)
    src_y = _fma(m[0, 1], gx, m[0, 0] * gy) + m[0, 2]
    src_x = _fma(m[1, 1], gx, m[1, 0] * gy) + m[1, 2]
    return _map_coordinates(stack, src_y, src_x, order)


def elastic_fields(
    shape: Tuple[int, int],
    elastic_value_x: float,
    elastic_value_y: float,
    rng: np.random.Generator,
) -> Tuple[np.ndarray, np.ndarray]:
    """Host-side coarse random displacement fields (image_util.py:67-87)."""
    h, w = shape
    ny, nx = max(h // 25, 1), max(w // 25, 1)
    sigma = min(h, w) * 0.0025
    coarse_dx = rng.random((ny, nx)) * 2 - 1
    coarse_dy = rng.random((ny, nx)) * 2 - 1
    if sigma > 0:
        from scipy.ndimage import gaussian_filter

        coarse_dx = gaussian_filter(coarse_dx, sigma)
        coarse_dy = gaussian_filter(coarse_dy, sigma)
    return coarse_dx.astype(np.float32), coarse_dy.astype(np.float32)


def _keys_cubic(x: torch.Tensor) -> torch.Tensor:
    """The Keys cubic kernel, a = -0.5 (``jax.image``'s)."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(x), out)


def _cubic_weights(in_size: int, out_size: int, device) -> torch.Tensor:
    """[in_size, out_size] f32 weights of ``jax.image.resize(method=
    "cubic")`` along one axis (``compute_weight_mat``, upsampling or
    equal size, no translation)."""
    inv_scale = np.float32(1.0 / (out_size / in_size))
    kernel_scale = max(float(inv_scale), 1.0)
    sample = (torch.arange(out_size, dtype=torch.float32, device=device)
              + 0.5) * torch.tensor(inv_scale, device=device) - 0.5
    src = torch.arange(in_size, dtype=torch.float32, device=device)
    x = (sample[None, :] - src[:, None]).abs() / kernel_scale
    weights = _keys_cubic(x)
    total = weights.sum(0, keepdim=True)
    ok = total.abs() > 1000.0 * float(np.finfo(np.float32).eps)
    weights = torch.where(
        ok, weights / torch.where(total != 0, total, torch.ones_like(total)),
        torch.zeros_like(weights))
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return torch.where(inside[None, :], weights, torch.zeros_like(weights))


def resize_cubic(field: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """``jax.image.resize(field, out_hw, method="cubic")`` of a 2-D f32
    field, as two products with the per-axis f32 weight matrices."""
    (ih, iw), (oh, ow) = field.shape, out_hw
    wy = _cubic_weights(ih, oh, field.device).double()
    wx = _cubic_weights(iw, ow, field.device).double()
    # summed in f64 and rounded once, so that every device's GEMM gives
    # the same f32 field
    return (wy.t() @ (field.double() @ wx)).float()


def apply_elastic(
    stack: torch.Tensor,
    coarse_dx,
    coarse_dy,
    alpha_x,
    alpha_y,
    order: int = 1,
) -> torch.Tensor:
    """Upsample coarse fields (cubic) and warp [H, W, C], on the stack's
    device."""
    h, w = stack.shape[:2]
    dev = stack.device
    as_f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32)
                                       if not isinstance(a, torch.Tensor)
                                       else a, dtype=torch.float32).to(dev)
    rx = resize_cubic(as_f32(coarse_dx), (h, w))
    ry = resize_cubic(as_f32(coarse_dy), (h, w))
    gy, gx = _grid(h, w, dev)
    return _map_coordinates(stack, _fma(ry, as_f32(alpha_y), gy),
                            _fma(rx, as_f32(alpha_x), gx), order)


def rebinarize_one_hot(
    tgt: torch.Tensor, dominating_channel: int = 1
) -> torch.Tensor:
    """Restore exclusive one-hot after warping (data_generator_text.py:334-344):
    the dominating channel wins overlaps, channel 0 becomes the complement."""
    b = tgt > BINARIZE_THRESHOLD
    c = tgt.shape[-1]
    claimed = b[..., dominating_channel]
    planes = [None] * c
    planes[dominating_channel] = b[..., dominating_channel]
    for ch in range(1, c):
        if ch == dominating_channel:
            continue
        tmap = b[..., ch] & ~claimed
        claimed = claimed | tmap
        planes[ch] = tmap
    planes[0] = ~claimed
    return torch.stack(planes, dim=-1).to(tgt.dtype)


def rotated_canvas(h: int, w: int, angle_deg: float) -> Tuple[int, int]:
    """Bounding-box size of an h x w page rotated by angle (like
    scipy ndimage.rotate with reshape=True, data_generator_text.py:332)."""
    th = np.deg2rad(angle_deg)
    c, s = abs(np.cos(th)), abs(np.sin(th))
    eps = 1e-6  # right angles hit exact integers up to fp error
    return int(np.ceil(h * c + w * s - eps)), int(np.ceil(w * c + h * s - eps))


def rotation_matrix(
    page_hw: Tuple[int, int], rot_hw: Tuple[int, int], angle_deg: float
) -> np.ndarray:
    """2x3 output->input affine rotating the page region about its center,
    re-centered on the rotated bounding box (top-left origin)."""
    th = np.deg2rad(angle_deg)
    c, s = np.cos(th), np.sin(th)
    cy_in, cx_in = (page_hw[0] - 1) / 2.0, (page_hw[1] - 1) / 2.0
    cy_out, cx_out = (rot_hw[0] - 1) / 2.0, (rot_hw[1] - 1) / 2.0
    # output coords -> input coords; positive angle rotates the image
    # counterclockwise in array space (scipy.ndimage.rotate convention,
    # +90 == np.rot90)
    return np.float32(
        [[c, s, cy_in - c * cy_out - s * cx_out],
         [-s, c, cx_in + s * cy_out - c * cx_out]]
    )


def sample_rotation(
    rng: np.random.Generator, *, rotate: bool, rotate_mod90: bool
) -> Tuple[Optional[float], int]:
    """(angle_deg or None, rot90_k).  Reference: rotate draws U(-20, 20)
    degrees (data_generator_text.py:308); rotateMod90 constrains rotation
    to right angles (the committed snapping at :310-318 is bitrot that
    always yields -45 — the intended mod-90 semantics are implemented
    here as an exact k*90 rot)."""
    if rotate_mod90:
        return None, int(rng.integers(0, 4))
    if rotate:
        return float(rng.uniform(-20.0, 20.0)), 0
    return None, 0


def augment_example(
    inp: torch.Tensor,
    label: torch.Tensor,
    valid: torch.Tensor,
    n_classes: int,
    rng: np.random.Generator,
    *,
    affine: bool = False,
    affine_value: float = 0.025,
    elastic: bool = False,
    elastic_value_x: float = 0.0002,
    elastic_value_y: float = 0.0002,
    rotate_angle: Optional[float] = None,
    rot90_k: int = 0,
    page_hw: Optional[Tuple[int, int]] = None,
    out_hw: Optional[Tuple[int, int]] = None,
    n_id_planes: int = 2,
):
    """Jointly augment a rasterized training example, on the device of
    ``inp``.

    Mirrors the reference's whole-stack warp of concatenated
    input/target/aux maps followed by re-binarization and dominating-channel
    one-hot cleanup (data_generator_text.py:303-344).  The last
    ``n_id_planes`` input channels carry raw ids (line mask / char-sep) and
    are warped with nearest-neighbor so ids survive; one-hot planes are
    warped bilinearly and re-binarized; the integer label is warped as
    one-hot with the dominating-channel rule; ``valid`` tracks the page
    region through every transform.

    Args:
      inp:   [H, W, C] float32, last ``n_id_planes`` channels id-valued.
      label: [H, W] int32 class ids (0 = background/ignore).
      valid: [H, W] bool.
      rotate_angle: degrees, or None.  When set, ``page_hw`` (true content
        size) and ``out_hw`` (canvas, >= rotated bbox) must be given.
      rot90_k: exact multiple-of-90 rotation applied last (lossless).
    Returns:
      (inp, label, valid) tuple with the same dtypes; spatial dims change
      only via ``out_hw``/``rot90_k``.
    """
    soft, hard = warp_example(
        inp, label, valid, n_classes, rng, affine=affine,
        affine_value=affine_value, elastic=elastic,
        elastic_value_x=elastic_value_x, elastic_value_y=elastic_value_y,
        rotate_angle=rotate_angle, rot90_k=rot90_k, page_hw=page_hw,
        out_hw=out_hw, n_id_planes=n_id_planes)
    n_soft = inp.shape[-1] - n_id_planes
    new_inp = torch.cat(
        [
            (soft[..., :n_soft] > BINARIZE_THRESHOLD).to(inp.dtype),
            hard.to(inp.dtype),
        ],
        dim=-1,
    )
    label_oh = rebinarize_one_hot(soft[..., n_soft:n_soft + n_classes])
    new_label = torch.argmax(label_oh, dim=-1).to(label.dtype)
    new_valid = soft[..., -1] > 0.5
    return new_inp, new_label, new_valid


def warp_example(
    inp: torch.Tensor,
    label: torch.Tensor,
    valid: torch.Tensor,
    n_classes: int,
    rng: np.random.Generator,
    *,
    affine: bool = False,
    affine_value: float = 0.025,
    elastic: bool = False,
    elastic_value_x: float = 0.0002,
    elastic_value_y: float = 0.0002,
    rotate_angle: Optional[float] = None,
    rot90_k: int = 0,
    page_hw: Optional[Tuple[int, int]] = None,
    out_hw: Optional[Tuple[int, int]] = None,
    n_id_planes: int = 2,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``augment_example``'s warps before the thresholds -> (soft [H', W',
    C - n_id_planes + n_classes + 1]: the one-hot planes, the label's
    one-hot and valid, bilinear; hard [H', W', n_id_planes]: the id
    planes, nearest)."""
    c = inp.shape[-1]
    n_soft = c - n_id_planes
    classes = torch.arange(n_classes, dtype=label.dtype, device=label.device)
    soft = torch.cat(
        [
            inp[..., :n_soft],
            (label[..., None] == classes).to(torch.float32),
            valid[..., None].to(torch.float32),
        ],
        dim=-1,
    )
    hard = inp[..., n_soft:]

    h, w = soft.shape[:2]
    if affine:
        m = random_affine_matrix((h, w), affine_value, rng)
        soft = apply_affine(soft, m, order=1)
        hard = apply_affine(hard, m, order=0)
    if elastic:
        cdx, cdy = elastic_fields((h, w), elastic_value_x, elastic_value_y, rng)
        ax = np.float32(elastic_value_x * min(h, w))
        ay = np.float32(elastic_value_y * min(h, w))
        soft = apply_elastic(soft, cdx, cdy, ax, ay, order=1)
        hard = apply_elastic(hard, cdx, cdy, ax, ay, order=0)
    if rotate_angle is not None:
        if page_hw is None or out_hw is None:
            raise ValueError("rotate_angle needs page_hw and out_hw")
        rot_hw = rotated_canvas(page_hw[0], page_hw[1], rotate_angle)
        m = rotation_matrix(page_hw, rot_hw, rotate_angle)
        soft = apply_affine(soft, m, order=1, out_shape=out_hw)
        hard = apply_affine(hard, m, order=0, out_shape=out_hw)
    if rot90_k:
        soft = torch.rot90(soft, rot90_k, dims=(0, 1))
        hard = torch.rot90(hard, rot90_k, dims=(0, 1))
    return soft, hard


def augment_stack(
    stack: torch.Tensor,
    rng: np.random.Generator,
    *,
    affine: bool = False,
    affine_value: float = 0.025,
    elastic: bool = False,
    elastic_value_x: float = 0.0002,
    elastic_value_y: float = 0.0002,
) -> torch.Tensor:
    """Apply the configured warps to an [H, W, C] stack and binarize, on
    the stack's device."""
    h, w = stack.shape[:2]
    out = stack
    if affine:
        m = random_affine_matrix((h, w), affine_value, rng)
        out = apply_affine(out, m)
    if elastic:
        cdx, cdy = elastic_fields((h, w), elastic_value_x, elastic_value_y, rng)
        ax = elastic_value_x * min(h, w)
        ay = elastic_value_y * min(h, w)
        out = apply_elastic(out, cdx, cdy, np.float32(ax), np.float32(ay))
    if affine or elastic:
        out = (out > BINARIZE_THRESHOLD).to(stack.dtype)
    return out
