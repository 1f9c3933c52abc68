"""The port's box convolution (msau_tpu_torch.ops.boxconv) against the JAX
package's on the CPU: the integral image, ``box_conv2d``'s forward, and its
gradients to the input and to all four coordinate arrays against
``jax.grad``, on coordinates that are fractional, negative, swapped
(``y_min > y_max``), tied (``y_min == y_max``) and on the clamps
(+-``max_h``, where the band's clip also ties), with and without the area
normalisation.

Tolerances (f32 on both sides): the forward within atol 2e-5 (two banded
products over ~40 padded rows and columns of prefix sums of values in
[0, 1), in another summation order); each gradient within 1e-4 of its
largest |value|.  The ties and clamps are exact points of ``jnp.clip`` /
``jnp.minimum`` / ``jnp.maximum``, whose gradient there is 0.5: a clip
built from ``torch.clamp`` would pass 1 and miss by half a gradient.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msau_tpu.ops import boxconv as jbox
from msau_tpu_torch.ops import boxconv

MAX_H = MAX_W = 5
KINDS = ("fractional", "swapped", "tied", "clamped")


def _coords(rng, c, b, kind):
    """[C, B] float32 y_min, y_max, x_min, x_max of one kind of case."""
    if kind == "fractional":
        lo = rng.uniform(-4, 1, (4, c, b))
        return [v.astype(np.float32) for v in
                (lo[0], lo[0] + rng.uniform(0.3, 3, (c, b)),
                 lo[1], lo[1] + rng.uniform(0.3, 3, (c, b)))]
    if kind == "swapped":
        y1 = rng.uniform(-3, 3, (c, b)).astype(np.float32)
        x1 = rng.uniform(-3, 3, (c, b)).astype(np.float32)
        return [y1 + 2.5, y1, x1 + 1.25, x1 - 0.5]
    if kind == "tied":
        y = rng.uniform(-3, 3, (c, b)).astype(np.float32)
        x = rng.uniform(-3, 3, (c, b)).astype(np.float32)
        return [y, y.copy(), x - 1.5, x + 0.75]
    if kind == "clamped":
        # on and past +-max: the coordinate clip ties on the bound, and
        # y_max + 1 = max_h + 1 = pad - 1 ties the band's clip too
        y_min = np.full((c, b), -MAX_H, np.float32)
        y_max = np.full((c, b), MAX_H, np.float32)
        x_min = np.where(rng.random((c, b)) < 0.5, -MAX_W, -MAX_W - 2.5)
        x_max = np.where(rng.random((c, b)) < 0.5, MAX_W, 1.25)
        return [y_min, y_max, x_min.astype(np.float32), x_max.astype(np.float32)]
    raise ValueError(kind)


def test_integral_image_matches_jax():
    x = np.random.default_rng(0).random((2, 7, 9, 3)).astype(np.float32)
    want = np.asarray(jbox.integral_image(jnp.asarray(x)))
    got = boxconv.integral_image(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("normalize", [True, False])
@pytest.mark.parametrize("kind", KINDS)
def test_box_conv2d_forward_and_grads_match_jax(kind, normalize):
    rng = np.random.default_rng(KINDS.index(kind))
    n, h, w, c, b = 2, 16, 12, 3, 2
    x = rng.random((n, h, w, c)).astype(np.float32)
    coords = _coords(rng, c, b, kind)
    cot = rng.standard_normal((n, h, w, c * b)).astype(np.float32)
    kw = dict(max_h=MAX_H, max_w=MAX_W, normalize=normalize)

    def jloss(x, *cs):
        return jnp.sum(jbox.box_conv2d(x, *cs, **kw) * cot)

    jout = np.asarray(jbox.box_conv2d(jnp.asarray(x),
                                      *map(jnp.asarray, coords), **kw))
    jgrads = jax.grad(jloss, argnums=(0, 1, 2, 3, 4))(
        jnp.asarray(x), *map(jnp.asarray, coords))

    tx = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_()
    tcs = [torch.from_numpy(v).requires_grad_() for v in coords]
    out = boxconv.box_conv2d(tx, *tcs, **kw)
    assert out.shape == (n, c * b, h, w) and out.dtype == torch.float32
    np.testing.assert_allclose(out.detach().permute(0, 2, 3, 1).numpy(), jout,
                               rtol=0, atol=2e-5)
    (out * torch.from_numpy(cot).permute(0, 3, 1, 2)).sum().backward()
    got = [tx.grad.permute(0, 2, 3, 1)] + [t.grad for t in tcs]
    for name, g, want in zip(("x", "y_min", "y_max", "x_min", "x_max"), got,
                             jgrads):
        want = np.asarray(want)
        np.testing.assert_allclose(
            g.numpy(), want, rtol=0, atol=1e-4 * max(np.abs(want).max(), 1e-6),
            err_msg=name)


def test_box_conv_module_init_and_shape():
    m = boxconv.BoxConv2d(4, 3, 28, 28, gen=torch.Generator().manual_seed(0))
    assert m.ybox.shape == m.xbox.shape == (2, 4, 3)
    center = (m.ybox[0] + m.ybox[1]) / 2
    half = (m.ybox[1] - m.ybox[0]) / 2
    assert float(center.abs().max()) <= 7.0 + 1e-5
    assert 1.0 - 1e-5 <= float(half.min()) and float(half.max()) <= 14.0 + 1e-5
    out = m(torch.rand(2, 4, 9, 11))
    assert out.shape == (2, 12, 9, 11)


@pytest.mark.parametrize("kind", KINDS)
def test_box_conv_function_on_the_cpu_is_the_plain_version(kind):
    """``box_conv`` (the entry the kernels sit behind on a card) on a CPU
    tensor: the plain version's output, and its gradients to the input and
    to the raw [2, C, B] coordinates, ties and clamps included, to the bit
    (the same torch ops on both sides)."""
    rng = np.random.default_rng(10 + KINDS.index(kind))
    coords = [torch.from_numpy(v) for v in _coords(rng, 3, 2, kind)]
    x = torch.from_numpy(rng.random((2, 3, 13, 10)).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal((2, 6, 13, 10)).astype(np.float32))
    kw = dict(max_h=MAX_H, max_w=MAX_W)
    outs = []
    for fn in ("function", "plain"):
        leaves = [x.clone().requires_grad_(),
                  torch.stack(coords[:2]).requires_grad_(),
                  torch.stack(coords[2:]).requires_grad_()]
        if fn == "function":
            out = boxconv.box_conv(*leaves, **kw)
        else:
            out = boxconv.box_conv2d(leaves[0], leaves[1][0], leaves[1][1],
                                     leaves[2][0], leaves[2][1], **kw)
        outs.append([out.detach(), *torch.autograd.grad(out, leaves, g)])
    for got, want in zip(*outs):
        assert torch.equal(got, want)


def test_box_conv_kernel_wrappers_refuse_cpu_tensors():
    x = torch.zeros(1, 2, 8, 8)
    box = torch.zeros(2, 2, 3)
    with pytest.raises(ValueError, match="CUDA"):
        boxconv.box_conv_fwd_cuda(x, box, box, max_h=4, max_w=4)
    with pytest.raises(ValueError, match="CUDA"):
        boxconv.box_conv_bwd_cuda(x, box, box, torch.zeros(1, 6, 8, 8),
                                  max_h=4, max_w=4)


def test_box_conv_bf16_on_the_cpu_is_the_plain_version():
    """A bf16 CPU input takes the plain version too: its f32 output and
    its bf16 dx to the bit."""
    rng = np.random.default_rng(20)
    coords = [torch.from_numpy(v) for v in _coords(rng, 3, 2, "fractional")]
    x = torch.from_numpy(rng.random((2, 3, 9, 12)).astype(np.float32))
    x = x.to(torch.bfloat16)
    kw = dict(max_h=MAX_H, max_w=MAX_W)
    outs = []
    for fn in ("entry", "plain"):
        leaf = x.clone().requires_grad_()
        ybox, xbox = torch.stack(coords[:2]), torch.stack(coords[2:])
        if fn == "entry":
            out = boxconv.box_conv(leaf, ybox, xbox, **kw)
        else:
            out = boxconv.box_conv2d(leaf, *coords, **kw)
        (dx,) = torch.autograd.grad(out.sum(), [leaf])
        outs.append((out.detach(), dx))
    assert outs[0][0].dtype == torch.float32 and outs[0][1].dtype == torch.bfloat16
    for got, want in zip(*outs):
        assert torch.equal(got, want)
