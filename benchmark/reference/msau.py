"""Plain PyTorch MSAU training step: the yardstick the port's step is held to.

The multi-stage attention U-Net of datvo06/MSAU (``model/model.py``), its
masked cross-entropy and optax's clip-then-Adam update, written with
``F.conv2d``, ``F.conv_transpose2d``, ``F.local_response_norm``,
``F.max_pool2d`` and ``torch.bmm`` only, in float32 with TF32 off.  It
imports nothing of the program: the weights and batches it is given are the
benchmark's, and it derives everything else itself.

Parameters are a dict keyed by the reference checkpoint's layer names
(``net.block_{b}.down.dil_conv_{l}.Conv_0.weight``, ...), conv weights OIHW
and deconv weights [in, out, kh, kw], as the benchmark makes them.

One departure from a literal forward: the last stage's attention output
feeds only a next stage, which does not exist, so it is not computed; its
parameters get zero gradients.

``Arith(tf32=True)`` is the control: every convolution and matrix product takes
its operands rounded to TF32's 10-bit mantissa, in the forward and in both
products of its backward, and accumulates in float32, as the tensor cores
do when TF32 is allowed.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

# float32 stays float32: no TF32 in cuDNN's convolutions or in matmuls
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False

# attention score blocks are held to this many elements (1 GiB of f32)
SCORE_BLOCK_ELEMENTS = 1 << 28
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


def tf32_round(t: torch.Tensor) -> torch.Tensor:
    """``t`` (f32) rounded to nearest even at TF32's 10 mantissa bits."""
    i = t.contiguous().view(torch.int32)
    i = (i + 0x0FFF + ((i >> 13) & 1)) & -8192
    return i.view(torch.float32)


class _Round(torch.autograd.Function):
    """TF32 rounding of an operand; the gradient passes unchanged."""

    @staticmethod
    def forward(ctx, x):
        return tf32_round(x)

    @staticmethod
    def backward(ctx, g):
        return g


class _RoundGrad(torch.autograd.Function):
    """Identity whose incoming gradient is rounded to TF32, so the two
    products of the backward behind it see TF32 operands too."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return tf32_round(g)


class Arith:
    """The products of the step: float32, or TF32 operands (``tf32``)."""

    def __init__(self, tf32: bool = False):
        self.tf32 = tf32

    def _in(self, t):
        return _Round.apply(t) if self.tf32 else t

    def _out(self, t):
        return _RoundGrad.apply(t) if self.tf32 and t.requires_grad else t

    def conv(self, x, w, b, dilation: int = 1):
        """TF-SAME stride-1 convolution: the extra padding pixel goes to the
        bottom and right."""
        kh, kw = w.shape[-2:]
        th, tw = (kh - 1) * dilation, (kw - 1) * dilation
        x = F.pad(x, (tw // 2, tw - tw // 2, th // 2, th - th // 2))
        y = F.conv2d(self._in(x), self._in(w), dilation=dilation)
        return self._out(y) + b[:, None, None]

    def deconv(self, x, w, b, target):
        """Stride-2 transposed convolution with padding k // 2, cut to the
        skip connection's size ``target``."""
        kh, kw = w.shape[-2:]
        h, wd = x.shape[-2:]
        oph = target[0] - ((h - 1) * 2 - 2 * (kh // 2) + kh)
        opw = target[1] - ((wd - 1) * 2 - 2 * (kw // 2) + kw)
        y = F.conv_transpose2d(self._in(x), self._in(w), stride=2,
                               padding=(kh // 2, kw // 2),
                               output_padding=(oph, opw))
        return self._out(y) + b[:, None, None]

    def bmm(self, a, b):
        return self._out(torch.bmm(self._in(a), self._in(b)))


def param_shapes(model: dict) -> List[Tuple[str, Tuple[int, ...]]]:
    """Every parameter of the network as (name, shape), in a fixed order."""
    S, depth = model["scale_space_num"], model["res_depth"]
    root, k = model["featRoot"], model["filter_size"]
    out: List[Tuple[str, Tuple[int, ...]]] = []

    def conv(name, cin, cout, kk):
        out.extend([(name + ".weight", (cout, cin, kk, kk)),
                    (name + ".bias", (cout,))])

    for b in range(model["num_blocks"]):
        pre = f"net.block_{b}."
        cin = model["img_channels"] if b == 0 else model["n_class"]
        for l in range(S):
            feats = root * 2 ** l
            conv(f"{pre}down.dil_conv_{l}.Conv_0", cin, feats, k)
            for i in range(depth):
                conv(f"{pre}down.res_block_{l}.ConvBnLrnDrop_{i}.Conv_0",
                     feats, feats, k)
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
            for i in range(depth):
                conv(f"{pre}up.res_block_{l}.ConvBnLrnDrop_{i}.Conv_0",
                     feats, feats, k)
            if b:
                conv(f"{pre}up.couple_conv_{l}.Conv_0", 2 * feats, feats, 1)
        conv(f"net.end_conv_{b}.Conv_0", root, model["n_class"], 4)
    return out


def attention(ar: Arith, p: Dict[str, torch.Tensor], pre: str,
              x: torch.Tensor) -> torch.Tensor:
    """SAGAN-style residual self-attention over the flattened grid:
    s_ij = g_i . f_j, A = softmax over j, out_j = sum_i A_ij h_i, y = out + x
    (no scaling, no output projection).  Rows of A are formed in blocks
    so that the scores fit."""
    n, c, hh, ww = x.shape
    t = hh * ww

    def tokens(name):
        y = ar.conv(x, p[pre + name + ".weight"], p[pre + name + ".bias"])
        return y.flatten(2).transpose(1, 2)          # [N, T, C']

    f, g, h = tokens("f"), tokens("g"), tokens("h")
    rows = max(1, min(t, SCORE_BLOCK_ELEMENTS // (n * t)))
    out = None
    for r0 in range(0, t, rows):
        s = ar.bmm(g[:, r0:r0 + rows], f.transpose(1, 2))      # [N, R, T]
        a = torch.softmax(s, dim=-1)
        part = ar.bmm(a.transpose(1, 2), h[:, r0:r0 + rows])   # [N, T, C]
        out = part if out is None else out + part
    return out.transpose(1, 2).reshape(n, c, hh, ww) + x


def _res_block(ar, p, pre, x, depth):
    y = F.relu(x)
    for i in range(depth):
        q = f"{pre}ConvBnLrnDrop_{i}.Conv_0."
        y = ar.conv(y, p[q + "weight"], p[q + "bias"])
        if i < depth - 1:
            y = F.relu(y)
    return F.relu(y + x)


def _couple(ar, p, pre, prev, y):
    q = pre + "Conv_0."
    return F.relu(ar.conv(torch.cat([prev, y], 1), p[q + "weight"],
                          p[q + "bias"]))


def forward(p: Dict[str, torch.Tensor], model: dict, x: torch.Tensor,
            ar: Optional[Arith] = None):
    """NHWC input -> (logits, aux_logits), NCHW f32.  ``model``: the
    configuration's ``model`` section (reference ``model_kwargs`` names)."""
    ar = ar or Arith()
    S, depth = model["scale_space_num"], model["res_depth"]
    blocks, root = model["num_blocks"], model["featRoot"]
    if model["pool_size"] != 2 or model["activation_name"] != "relu":
        raise ValueError("the reference takes pool 2 and relu")
    out = x.permute(0, 3, 1, 2)
    prev_dw = prev_up = None
    aux = None
    for b in range(blocks):
        pre = f"net.block_{b}."
        h = out
        dws: List[Optional[torch.Tensor]] = []
        for l in range(S):
            q = f"{pre}down.dil_conv_{l}.Conv_0."
            y = ar.conv(h, p[q + "weight"], p[q + "bias"], dilation=2 ** l)
            if model["use_lrn"]:
                y = F.local_response_norm(y, size=root * 2 ** l, alpha=1e-4,
                                          beta=0.75, k=1.0)
            y = _res_block(ar, p, f"{pre}down.res_block_{l}.", y, depth)
            if b:
                y = _couple(ar, p, f"{pre}down.couple_conv_{l}.", prev_dw[l], y)
            if l == S - 1:
                # the attention output goes to the next stage only
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
            y = ar.deconv(h, p[f"{q}deconv_{l}.weight"],
                          p[f"{q}deconv_{l}.bias"], tuple(skip.shape[-2:]))
            y = ar.conv(torch.cat([skip, y], 1),
                        p[f"{q}merge_conv_{l}.Conv_0.weight"],
                        p[f"{q}merge_conv_{l}.Conv_0.bias"])
            y = _res_block(ar, p, f"{q}res_block_{l}.", y, depth)
            if b:
                y = _couple(ar, p, f"{q}couple_conv_{l}.", prev_up[l], y)
            ups[l] = y
            h = y
        q = f"net.end_conv_{b}.Conv_0."
        out = ar.conv(h, p[q + "weight"], p[q + "bias"])
        if b == blocks - 2:
            aux = out
        prev_dw, prev_up = dws, ups
    return out, (out if aux is None else aux)


def masked_ce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy over the pixels whose label is not 0."""
    logp = torch.log_softmax(logits, dim=1)
    ce = -logp.gather(1, labels.long().unsqueeze(1)).squeeze(1)
    mask = labels != 0
    return torch.where(mask, ce, torch.zeros_like(ce)).sum() / mask.sum().clamp(min=1)


def loss_fn(p, model, batch, ar=None) -> torch.Tensor:
    """Entry-A loss: masked CE of the final logits plus that of the aux
    logits, unweighted."""
    logits, aux = forward(p, model, batch["input"], ar)
    return masked_ce(logits, batch["label"]) + masked_ce(aux, batch["label"])


class Adam:
    """optax's clip_by_global_norm -> adam: g * max / norm where norm >=
    max; mu_hat / (sqrt(nu_hat) + eps) with the bias corrections formed in
    f32; lr constant."""

    def __init__(self, lr: float, clip_norm: float):
        self.lr, self.clip_norm = lr, clip_norm
        self.count = 0
        self.mu = self.nu = None

    def clip(self, grads: List[torch.Tensor]) -> List[torch.Tensor]:
        norm = torch.linalg.vector_norm(
            torch.stack([torch.linalg.vector_norm(g) for g in grads]))
        if not self.clip_norm:
            return grads
        coef = torch.where(norm < self.clip_norm, torch.ones_like(norm),
                           self.clip_norm / norm)
        return [g * coef for g in grads]

    @torch.no_grad()
    def update(self, params: List[torch.Tensor], grads: List[torch.Tensor]):
        if self.mu is None:
            self.mu = [torch.zeros_like(q) for q in params]
            self.nu = [torch.zeros_like(q) for q in params]
        t = torch.tensor(self.count + 1, dtype=torch.float32)
        bc1 = float(1 - torch.tensor(ADAM_B1, dtype=torch.float32) ** t)
        bc2 = float(1 - torch.tensor(ADAM_B2, dtype=torch.float32) ** t)
        for q, g, m, v in zip(params, grads, self.mu, self.nu):
            m.mul_(ADAM_B1).add_(g, alpha=1 - ADAM_B1)
            v.mul_(ADAM_B2).addcmul_(g, g, value=1 - ADAM_B2)
            q.sub_(self.lr * (m / bc1) / ((v / bc2).sqrt() + ADAM_EPS))
        self.count += 1


def leaf_norms(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """Each tensor's 2-norm, summed in float64 -> [L] float64."""
    return torch.stack([torch.linalg.vector_norm(t.double()) for t in tensors])

