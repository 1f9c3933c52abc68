"""Plain PyTorch BMSAU training step: the yardstick the port's box-convolution
MSAU is held to.

The box-convolution MSAU of datvo06/MSAU (``model/model_box.py:313-406``,
``BMSAUWrapper``): the MSAU's topology (``reference/msau.py``) with every
residual block made of ``num_box_convs`` x [box convolution (C -> C*B
area-normalised box averages, each box learning its 4 coordinates) -> 1x1
conv (C*B -> C)], relu between them, inside the residual connection.  The
box convolution is written from its definition: an exclusive integral
image by ``cumsum``, then the four corner samples of each box, each a
linear blend of two rows and two columns chosen by explicit floor and
fraction index arithmetic (``gather``).  Float32, TF32 off.  The
convolutions and the deepest scale's attention are ``reference/msau.py``'s,
handed in as arguments (``ar``, its ``Arith``: ``Arith(tf32=True)`` is the
control; ``attention``, its ``attention``), so this file imports nothing
but torch, and nothing of the program.

Parameters are a dict keyed by the port's names
(``net.bmsau.block_{b}.down.res_block_{l}.box_conv_{i}.ybox``, ...): box
coordinates [2, C, B], min and max stacked.

Departures from shrubb/box-convolutions (Burkov & Lempitsky, NeurIPS
2018), which the reference's ``BoxConv2d`` calls, as the JAX package
takes them:

* The box ends are blended: the box sum is the integral image sampled at
  the fractional corners (y_max + 1, y_min and the columns alike), each a
  linear blend of its two neighbouring rows and columns, so a coordinate's
  gradient is the integral of the input along that edge.  The original
  splits each box into its integer part and fractional border strips.
* Samples past the image repeat the integral image's edge (replicate
  padding): zeros above and to the left, the full sums below and to the
  right, so the input counts as zero outside the image.
* Coordinates are ordered (min, max) and clipped to +-``max_box_sizes`` in
  the forward pass; the original reparametrises them and clamps the
  parameters after each update.  The area is ``max(area, 1)``.
* Initialisation: a centre ~ U(-max/4, max/4) and a half-size ~ U(1,
  max/2) per coordinate pair, drawn by the benchmark (``kinds/
  train_box.py``).

At 512 x 512 and batch 16 the step runs image by image and sums the
gradients (``loss_and_grads``), the masked CE of each image over the
batch's count of labelled pixels, so that its autograd graph fits: its
peak with the cell's weights, Adam state and three input batches is 13.69
GiB on an H100 (the control's runs), where the port's batched step peaks
at 32.53 GiB.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

# float32 stays float32: no TF32 in cuDNN's convolutions or in matmuls
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False

BOX_LEAVES = (".ybox", ".xbox")


def is_box_leaf(name: str) -> bool:
    return name.endswith(BOX_LEAVES)


def param_shapes(model: dict) -> List[Tuple[str, Tuple[int, ...]]]:
    """Every parameter of the network as (name, shape), in the port's
    order."""
    S, root, k = model["scale_space_num"], model["featRoot"], model["filter_size"]
    convs, boxes = model["num_box_convs"], model["num_box_per_channels"]
    out: List[Tuple[str, Tuple[int, ...]]] = []

    def conv(name, cin, cout, kk):
        out.extend([(name + ".weight", (cout, cin, kk, kk)),
                    (name + ".bias", (cout,))])

    def box_block(pre, feats):
        for i in range(convs):
            out.extend([(f"{pre}box_conv_{i}.ybox", (2, feats, boxes)),
                        (f"{pre}box_conv_{i}.xbox", (2, feats, boxes))])
            conv(f"{pre}proj_conv_{i}.Conv_0", feats * boxes, feats, 1)

    for b in range(model["num_blocks"]):
        pre = f"net.bmsau.block_{b}."
        cin = model["img_channels"] if b == 0 else model["n_class"]
        for l in range(S):
            feats = root * 2 ** l
            conv(f"{pre}down.dil_conv_{l}.Conv_0", cin, feats, k)
            box_block(f"{pre}down.res_block_{l}.", feats)
            if b:
                conv(f"{pre}down.couple_conv_{l}.Conv_0", 2 * feats, feats, 1)
            if l == S - 1:
                cb = max(feats // 8, 1)
                for name, cout in (("f", cb), ("g", cb), ("h", feats)):
                    conv(f"{pre}down.attention_{l}.{name}", feats, cout, 1)
            cin = feats
        for l in range(S - 2, -1, -1):
            feats = root * 2 ** l
            out.extend([(f"{pre}up.deconv_{l}.weight", (2 * feats, feats, k, k)),
                        (f"{pre}up.deconv_{l}.bias", (feats,))])
            conv(f"{pre}up.merge_conv_{l}.Conv_0", 2 * feats, feats, k)
            box_block(f"{pre}up.res_block_{l}.", feats)
            if b:
                conv(f"{pre}up.couple_conv_{l}.Conv_0", 2 * feats, feats, 1)
        conv(f"net.bmsau.end_conv_{b}.Conv_0", root, model["n_class"], 4)
    return out


def _clip(t: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """Clip with half the gradient at a bound (``torch.minimum`` /
    ``torch.maximum``)."""
    return torch.minimum(torch.maximum(t, t.new_full((), lo)), t.new_full((), hi))


def _ordered(box: torch.Tensor, bound: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """[2, C, B] raw coordinates -> (lower, upper), clipped to +-bound."""
    lo = torch.minimum(box[0], box[1])
    hi = torch.maximum(box[0], box[1])
    return _clip(lo, -bound, bound), _clip(hi, -bound, bound)


def _blend_index(d: torch.Tensor, n: int, pad: int):
    """Sample positions i + d of i = 0 .. n - 1 for offsets d [C, B]:
    (the two integral-image indices [C, B, n] each side of it, clamped to
    the image's edge rows 0 .. n, and the fraction f [C, B] that weighs the
    upper one)."""
    d = _clip(d, -pad, pad - 1)
    k = torch.floor(d)
    f = d - k
    i = torch.arange(n, device=d.device)
    lower = i + k.to(torch.int64)[..., None]
    return lower.clamp(0, n), (lower + 1).clamp(0, n), f


def box_filter(x: torch.Tensor, ybox: torch.Tensor, xbox: torch.Tensor,
               max_h: int, max_w: int) -> torch.Tensor:
    """[N, C, H, W] -> [N, C*B, H, W] (channel c*B + b): the average of
    x over box b of channel c placed at every pixel."""
    n, c, h, w = x.shape
    b = ybox.shape[2]
    pad = max(max_h, max_w) + 2
    y1, y2 = _ordered(ybox, max_h)
    x1, x2 = _ordered(xbox, max_w)
    ii = F.pad(torch.cumsum(torch.cumsum(x, 2), 3), (1, 0, 1, 0))
    chan = torch.arange(c, device=x.device)[:, None, None]

    def rows(d):   # [N, C, B, H, W + 1]: ii blended at rows i + d
        r0, r1, f = _blend_index(d, h, pad)
        f = f[None, :, :, None, None]
        return (1 - f) * ii[:, chan, r0] + f * ii[:, chan, r1]

    def cols(t, d):   # [N, C, B, H, W]: t blended at columns j + d
        q0, q1, f = _blend_index(d, w, pad)
        shape = (n, c, b, h, w)
        f = f[None, :, :, None, None]
        return ((1 - f) * torch.gather(t, 4, q0[None, :, :, None].expand(shape))
                + f * torch.gather(t, 4, q1[None, :, :, None].expand(shape)))

    edge = rows(y2 + 1.0) - rows(y1)
    total = cols(edge, x2 + 1.0) - cols(edge, x1)
    area = (y2 - y1 + 1.0) * (x2 - x1 + 1.0)
    area = torch.maximum(area, area.new_full((), 1.0))
    return (total / area[None, :, :, None, None]).reshape(n, c * b, h, w)


def _conv(ar, p, name: str, x: torch.Tensor, dilation: int = 1):
    return ar.conv(x, p[name + ".weight"], p[name + ".bias"], dilation)


def _box_block(ar, p, pre, x, model):
    """relu(x) -> num_box_convs x [box filter -> 1x1 conv (relu but
    after the last)] -> + x -> relu."""
    m, convs = model["max_box_sizes"], model["num_box_convs"]
    y = F.relu(x)
    for i in range(convs):
        y = box_filter(y, p[f"{pre}box_conv_{i}.ybox"],
                       p[f"{pre}box_conv_{i}.xbox"], m, m)
        y = _conv(ar, p, f"{pre}proj_conv_{i}.Conv_0", y)
        if i < convs - 1:
            y = F.relu(y)
    return F.relu(y + x)


def _couple(ar, p, name, prev, y):
    return F.relu(_conv(ar, p, name, torch.cat([prev, y], 1)))


def forward(p: Dict[str, torch.Tensor], model: dict, x: torch.Tensor, ar,
            attention: Callable):
    """NHWC input -> (logits, aux_logits), NCHW f32; the last stage's
    attention, which feeds nothing, is not computed.  ``ar``: the
    products (``reference/msau.py``'s ``Arith``), ``attention``: the
    deepest scale's (``reference/msau.py``'s ``attention``)."""
    S, blocks, root = model["scale_space_num"], model["num_blocks"], model["featRoot"]
    if model["pool_size"] != 2 or model["activation_name"] != "relu":
        raise ValueError("the reference takes pool 2 and relu")
    out = x.permute(0, 3, 1, 2)
    prev_dw = prev_up = None
    aux = None
    for b in range(blocks):
        pre = f"net.bmsau.block_{b}."
        h = out
        dws: List[Optional[torch.Tensor]] = []
        for l in range(S):
            y = _conv(ar, p, f"{pre}down.dil_conv_{l}.Conv_0", h, 2 ** l)
            if model["use_lrn"]:
                y = F.local_response_norm(y, size=root * 2 ** l, alpha=1e-4,
                                          beta=0.75, k=1.0)
            y = _box_block(ar, p, f"{pre}down.res_block_{l}.", y, model)
            if b:
                y = _couple(ar, p, f"{pre}down.couple_conv_{l}.Conv_0",
                            prev_dw[l], y)
            if l == S - 1:
                dws.append(attention(ar, p, f"{pre}down.attention_{l}.", y)
                           if b < blocks - 1 else None)
                h = y
            else:
                dws.append(y)
                h = F.max_pool2d(y, 2, 2, ceil_mode=True)
        ups: List[Optional[torch.Tensor]] = [None] * (S - 1)
        for l in range(S - 2, -1, -1):
            skip = dws[l]
            q = f"{pre}up."
            y = ar.deconv(h, p[f"{q}deconv_{l}.weight"], p[f"{q}deconv_{l}.bias"],
                          tuple(skip.shape[-2:]))
            y = _conv(ar, p, f"{q}merge_conv_{l}.Conv_0", torch.cat([skip, y], 1))
            y = _box_block(ar, p, f"{q}res_block_{l}.", y, model)
            if b:
                y = _couple(ar, p, f"{q}couple_conv_{l}.Conv_0", prev_up[l], y)
            ups[l] = y
            h = y
        out = _conv(ar, p, f"net.bmsau.end_conv_{b}.Conv_0", h)
        if b == blocks - 2:
            aux = out
        prev_dw, prev_up = dws, ups
    return out, (out if aux is None else aux)


def _ce_sum(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Cross-entropy summed over the pixels whose label is not 0."""
    logp = torch.log_softmax(logits, dim=1)
    ce = -logp.gather(1, labels.long().unsqueeze(1)).squeeze(1)
    return torch.where(labels != 0, ce, torch.zeros_like(ce)).sum()


def loss_fn(p, model, batch, ar, attention, count=None) -> torch.Tensor:
    """Entry-A loss: masked CE of the final logits plus that of the aux
    logits, unweighted, each summed over the batch's labelled pixels and
    divided by ``count`` (by default the batch's count of them)."""
    logits, aux = forward(p, model, batch["input"], ar, attention)
    if count is None:
        count = (batch["label"] != 0).sum().clamp(min=1)
    return (_ce_sum(logits, batch["label"]) + _ce_sum(aux, batch["label"])) / count


def loss_and_grads(p: Dict[str, torch.Tensor], model: dict, batch, ar,
                   attention: Callable):
    """The batch's ``loss_fn`` and its gradient to every leaf of ``p`` (in
    its order), formed image by image: each image's loss over the whole
    batch's count, the losses and the gradients summed in image order."""
    leaves = list(p.values())
    count = (batch["label"] != 0).sum().clamp(min=1)
    loss, grads = None, None
    for i in range(batch["input"].shape[0]):
        one = {k: v[i:i + 1] for k, v in batch.items()}
        li = loss_fn(p, model, one, ar, attention, count)
        gi = torch.autograd.grad(li, leaves, materialize_grads=True)
        li = li.detach()
        if grads is None:
            loss, grads = li, list(gi)
        else:
            loss = loss + li
            for g, a in zip(grads, gi):
                g.add_(a)
        del gi
    return loss, grads
