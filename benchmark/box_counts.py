"""Operations and bytes of the box-convolution MSAU (BMSAU), from shapes.

Like ``counts``, whatever implements the work: a later change to the
program cannot move them.  A box convolution of x [N, C, H, W] with B boxes
a channel gives [N, C*B, H, W].  Its operations are the integral image's
(two additions an input element) and, per output, the four corner samples
of it, each a blend of two rows and two columns (16 multiply-adds, 32
operations); the backward does both twice (the input's gradient, the
transposed filter, and the coordinates' edge integrals).  Its bytes, f32:
the forward reads x and writes the C*B outputs; the backward reads the
cotangent and x and writes dx (the coordinates, [2, C, B] each way, are
counted too).  Neither reaches the FP32 pipes' rate before the memory's:
a box convolution is bound by its bytes.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

from benchmark import counts

Shape = Tuple[int, int, int, int, int]   # (N, C, B, H, W) of one call


def _sizes(h: int, w: int, scales: int) -> List[Tuple[int, int]]:
    out = [(h, w)]
    for _ in range(scales - 1):
        out.append(((out[-1][0] + 1) // 2, (out[-1][1] + 1) // 2))
    return out


def box_calls(model: dict, n: int, h: int, w: int) -> List[Shape]:
    """The shape of every box convolution of one forward, in order: per
    stage, the down path's scales, then the up path's, ``num_box_convs``
    at each."""
    S, root = model["scale_space_num"], model["featRoot"]
    nb, convs = model["num_box_per_channels"], model["num_box_convs"]
    sizes = _sizes(h, w, S)
    calls: List[Shape] = []
    for _ in range(model["num_blocks"]):
        for l in list(range(S)) + list(range(S - 2, -1, -1)):
            calls.extend([(n, root * 2 ** l, nb, *sizes[l])] * convs)
    return calls


def box_flops(kind: str, shape: Shape) -> int:
    """Operations of one call's forward ("fwd") or backward ("bwd")."""
    n, c, b, h, w = shape
    fwd = 2 * n * c * h * w + 32 * n * c * b * h * w
    return fwd if kind == "fwd" else 2 * fwd


def box_bytes(kind: str, shape: Shape) -> int:
    """Bytes one call must move, each input read once, each output written
    once, f32."""
    n, c, b, h, w = shape
    x, y, coords = n * c * h * w, n * c * b * h * w, 2 * 2 * c * b
    if kind == "fwd":
        return 4 * (x + y + coords)
    return 4 * (y + 2 * x + 3 * coords)


def box_bound_ms(kind: str, shape: Shape) -> Tuple[float, str]:
    """The least time one call could take on the card, the FP32 pipes' rate
    for its operations (it uses no tensor core)."""
    return counts.bound_ms(box_flops(kind, shape), box_bytes(kind, shape),
                           counts.PEAK_FP32_PIPES_FLOPS)


def bmsau_flops(model: dict, n: int, h: int, w: int) -> Dict[str, int]:
    """Operations of one BMSAU training step (``counts.msau_flops``' terms):
    the MSAU's convolutions, transposed convolutions and attention without
    the residual 3x3 convs, plus each box convolution's 1x1 projection (C*B
    -> C, with its input's and its weight's gradients) and the box
    convolutions themselves, forward and backward."""
    base = counts.msau_flops(dict(model, res_depth=0), n, h, w)
    fwd, train = base["forward"], base["train"]
    for shape in box_calls(model, n, h, w):
        nn, c, b, hh, ww = shape
        proj = 2 * nn * c * b * c * hh * ww
        fwd += proj + box_flops("fwd", shape)
        train += 3 * proj + box_flops("fwd", shape) + box_flops("bwd", shape)
    return {"forward": fwd, "train": train}
