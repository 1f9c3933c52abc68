"""The benchmark's own operation and byte counts, and the card's peaks.

Counts come from shapes alone, whatever implements the work, so a later
change to the program cannot move them.

Peaks (NVIDIA H100 SXM data sheet, dense): 989 TFLOP/s in bf16 on the
tensor cores, 67 TFLOP/s in float32 outside them, 3.35 TB/s of HBM.  The
f32 peak that shares of a peak are taken against is the bf16 rate over
three: the program computes float32 products on the tensor cores as three
bf16 parts, the cheapest f32-accurate product it uses, so against the
FP32 pipes' 67 TFLOP/s a sound tensor-core kernel could read over 100 %.
"""

from __future__ import annotations

from typing import Dict, Tuple

PEAK_BF16_FLOPS = 989e12
PEAK_FP32_PIPES_FLOPS = 67e12
PEAK_F32_FLOPS = PEAK_BF16_FLOPS / 3
PEAK_BYTES_PER_S = 3.35e12


def _conv(n: int, cin: int, cout: int, k: int, h: int, w: int) -> int:
    """Multiply-adds of a stride-1 conv, counted as 2 operations each."""
    return 2 * n * cin * cout * k * k * h * w


def _half(x: int) -> int:
    return (x + 1) // 2


def msau_flops(model: dict, n: int, h: int, w: int) -> Dict[str, int]:
    """Operations of one MSAU training step on ``n`` images of ``h`` x
    ``w``: every convolution, transposed convolution and attention product
    of the forward (``forward``), and of the forward and the backward
    (``train``): a product's backward forms the input's gradient (where the
    input needs one) and the weight's, each as many operations as the
    forward.  The last stage's attention feeds nothing and is not counted;
    nothing is counted twice for recomputation.  ``model``: the
    configuration's ``model`` section."""
    S, depth = model["scale_space_num"], model["res_depth"]
    blocks, root, k = model["num_blocks"], model["featRoot"], model["filter_size"]
    fwd = train = 0

    def add(ops: int, input_grad: bool = True) -> None:
        nonlocal fwd, train
        fwd += ops
        train += ops * (3 if input_grad else 2)

    sizes = [(h, w)]
    for _ in range(S - 1):
        sizes.append((_half(sizes[-1][0]), _half(sizes[-1][1])))
    for b in range(blocks):
        cin = model["img_channels"] if b == 0 else model["n_class"]
        for l in range(S):
            hh, ww = sizes[l]
            feats = root * 2 ** l
            add(_conv(n, cin, feats, k, hh, ww), input_grad=b > 0 or l > 0)
            for _ in range(depth):
                add(_conv(n, feats, feats, k, hh, ww))
            if b:
                add(_conv(n, 2 * feats, feats, 1, hh, ww))
            if l == S - 1 and b < blocks - 1:
                t, cb = hh * ww, max(feats // 8, 1)
                add(_conv(n, feats, 2 * cb + feats, 1, hh, ww))
                # two products, each with both operands' gradients
                add(2 * n * t * t * (cb + feats))
            cin = feats
        for l in range(S - 2, -1, -1):
            hh, ww = sizes[l]
            feats = root * 2 ** l
            # the transposed conv: each input pixel against the whole kernel
            add(_conv(n, 2 * feats, feats, k, *sizes[l + 1]))
            add(_conv(n, 2 * feats, feats, k, hh, ww))
            for _ in range(depth):
                add(_conv(n, feats, feats, k, hh, ww))
            if b:
                add(_conv(n, 2 * feats, feats, 1, hh, ww))
        add(_conv(n, root, model["n_class"], 4, h, w))
    return {"forward": fwd, "train": train}


def attention_shape(model: dict, n: int, h: int, w: int) -> Tuple[int, int, int, int]:
    """(N, T, Cb, C) of the deepest scale's attention."""
    S = model["scale_space_num"]
    for _ in range(S - 1):
        h, w = _half(h), _half(w)
    c = model["featRoot"] * 2 ** (S - 1)
    return n, h * w, max(c // 8, 1), c


def attention_flops(kind: str, n: int, t: int, cb: int, c: int) -> int:
    """Operations one attention call's algorithm needs.  Forward: the
    scores and A^T h.  Backward (A recomputed from the saved statistics):
    the scores, dh = A dout, h dout^T, dg = ds f and df = ds^T g."""
    if kind == "fwd":
        return 2 * n * t * t * (cb + c)
    return 2 * n * t * t * (3 * cb + 2 * c)


def attention_bytes(kind: str, n: int, t: int, cb: int, c: int,
                    itemsize: int = 4, out_size: int = 4) -> int:
    """Bytes one attention call must move, each input read once and each
    output written once.  Forward: f, g, h in, out and the row statistics
    m, l (f32) out.  Backward: f, g, h, dout, m, l in, df, dg, dh out."""
    if kind == "fwd":
        return n * t * ((2 * cb + c) * itemsize + c * out_size) + n * t * 8
    return n * t * (4 * cb + 3 * c) * itemsize + n * t * 8


def bound_ms(flops: float, nbytes: float,
             peak_flops: float = PEAK_F32_FLOPS) -> Tuple[float, str]:
    """The least time the card could take -> (ms, "operations" | "bytes")."""
    t_ops = flops / peak_flops * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def attention_bound_ms(kind: str, n: int, t: int, cb: int, c: int,
                       itemsize: int = 4) -> Tuple[float, str]:
    """Bound of one f32 attention call at the f32 tensor-core peak."""
    return bound_ms(attention_flops(kind, n, t, cb, c),
                    attention_bytes(kind, n, t, cb, c, itemsize))
