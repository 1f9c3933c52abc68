"""Fused masked CE parity: the port's ``fused_masked_ce_sum`` (value, correct
count and dlogits through torch.autograd; the plain versions on the CPU)
against ``msau_tpu.ops.ce_loss.fused_masked_ce_sum``, whose Pallas kernels
run in interpret mode off the TPU.

Tolerances: ``correct`` exact (sums of 0/1 masks); ``ce_sum`` rel 1e-5
(f32 sums over 8192 pixels in another order); dlogits atol 1e-6 (f32
values <= 1 times g).  bf16 logits are read as bf16 on both sides and the
arithmetic is f32; their dlogits are bf16, so 1 bf16 ulp of a value <= 1
(4e-3) bounds the difference.

The JAX kernel does not clamp labels (an out-of-range label matches no
class, ``ce_loss.py:55``) while the JAX loss's other branch does
(``loss.py:41``); the port clamps in both, so the JAX kernel gets the
clamped labels and the port the raw ones.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msau_tpu.ops.ce_loss import fused_masked_ce_sum as jax_fused_ce
from msau_tpu.train.loss import _per_pixel_ce as jax_per_pixel_ce
from msau_tpu_torch.ops.ce_loss import (
    fused_masked_ce_sum,
    masked_ce_bwd_cuda,
    masked_ce_fwd_cuda,
)
from msau_tpu_torch.utils.kernel_inputs import ce_inputs

N, C, L = 2, 17, 4096
G = 0.37  # upstream cotangent of ce_sum


def _jax_ce(logits, labels, maskf):
    """JAX value and dlogits for cotangent G."""
    (s, c), vjp = jax.vjp(
        lambda l: jax_fused_ce(l, jnp.asarray(labels), jnp.asarray(maskf)),
        jnp.asarray(logits))
    (dl,) = vjp((jnp.float32(G), jnp.float32(0.0)))
    return float(s), float(c), np.asarray(dl)


def _port_ce(logits, labels, maskf, dtype):
    lt = torch.from_numpy(logits).to(dtype).requires_grad_()
    s, c = fused_masked_ce_sum(lt, torch.from_numpy(labels),
                               torch.from_numpy(maskf))
    (s * G).backward()
    assert s.dtype == c.dtype == torch.float32 and not c.requires_grad
    return float(s.detach()), float(c), lt.grad


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("out_of_range", [False, True])
def test_fused_ce_matches_pallas(dtype, out_of_range):
    logits, labels, maskf = ce_inputs(np.random.default_rng(1), N, C, L,
                                      out_of_range=out_of_range)
    if dtype == torch.bfloat16:  # both sides read the same bf16 values
        logits_j = jnp.asarray(logits).astype(jnp.bfloat16)
    else:
        logits_j = logits
    js, jc, jdl = _jax_ce(logits_j, np.clip(labels, 0, C - 1), maskf)
    ts, tc, tdl = _port_ce(logits, labels, maskf, dtype)
    assert tc == jc
    assert abs(ts - js) <= 1e-5 * abs(js)
    assert tdl.dtype == dtype
    atol = 1e-6 if dtype == torch.float32 else 4e-3
    np.testing.assert_allclose(tdl.float().numpy(), np.asarray(jdl, np.float32),
                               rtol=0, atol=atol)


def test_clamped_labels_match_the_xla_branch():
    """With out-of-range labels the port's fused sum equals the JAX
    per-pixel CE (which clamps) summed under the mask."""
    logits, labels, maskf = ce_inputs(np.random.default_rng(2), N, C, L,
                                      out_of_range=True)
    want = float(jnp.sum(jax_per_pixel_ce(jnp.asarray(logits),
                                          jnp.asarray(labels), 1)
                         * jnp.asarray(maskf)))
    ts, _, _ = _port_ce(logits, labels, maskf, torch.float32)
    assert abs(ts - want) <= 1e-5 * abs(want)


def test_all_zero_mask():
    logits, labels, _ = ce_inputs(np.random.default_rng(3), N, C, L)
    maskf = np.zeros((N, L), np.float32)
    js, jc, jdl = _jax_ce(logits, labels, maskf)
    ts, tc, tdl = _port_ce(logits, labels, maskf, torch.float32)
    assert ts == js == 0.0 and tc == jc == 0.0
    assert not tdl.any() and not np.asarray(jdl).any()


def test_ties_count_as_correct():
    """A label logit equal to the max is correct even when another class
    ties (the kernel's rule; argmax would pick the first)."""
    logits = np.zeros((1, 3, 4), np.float32)
    labels = np.array([[2, 1, 0, 2]], np.int32)
    maskf = np.array([[1, 1, 0, 1]], np.float32)
    logits[0, :, 3] = [5.0, 1.0, 2.0]
    js, jc, _ = _jax_ce(logits, labels, maskf)
    ts, tc, _ = _port_ce(logits, labels, maskf, torch.float32)
    assert tc == jc == 2.0
    assert abs(ts - js) <= 1e-6 * abs(js)


def test_cuda_wrappers_reject_cpu_tensors():
    logits, labels, maskf = map(torch.from_numpy,
                                ce_inputs(np.random.default_rng(0), 1, 3, 8))
    with pytest.raises(ValueError, match="CUDA"):
        masked_ce_fwd_cuda(logits, labels, maskf)
    with pytest.raises(ValueError, match="CUDA"):
        masked_ce_bwd_cuda(logits, labels, maskf, torch.ones(()))
