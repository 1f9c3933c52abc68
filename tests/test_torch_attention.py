"""Attention parity: the port's resident_attention against the TPU kernel
(resident_attention in interpret mode) and the SelfAttentionBlock module
against flax with bridged weights.

Tolerance rtol/atol 1e-5: f32 on both sides; the residue is the softmax
sum order over T = 256..512 keys.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msau_tpu.models.attention import SelfAttentionBlock as JaxSelfAttention
from msau_tpu.models.attention import add_timing_signal_2d as jax_timing
from msau_tpu.ops.pallas_attn import resident_attention as jax_resident
from msau_tpu_torch.models.attention import SelfAttentionBlock, add_timing_signal_2d
from msau_tpu_torch.ops.attention import (
    resident_attention,
    resident_attention_cuda,
    resident_attention_plain,
)
from msau_tpu_torch.utils.kernel_inputs import attention_inputs
from msau_tpu_torch.utils.transplant import flax_to_torch

TOL = dict(rtol=1e-5, atol=1e-5)


def _inputs(seed, n, t, cb, c, scale=1.0):
    return attention_inputs(np.random.default_rng(seed), n, t, cb, c, scale)


@pytest.mark.parametrize("t,scale", [(256, 1.0), (512, 1.0), (256, 6.0)])
def test_resident_attention_matches_pallas(t, scale):
    """scale 6 gives logits of several hundred: the softmax must stay
    exact (max-subtracted) there."""
    f, g, h = _inputs(t, 2, t, 8, 64, scale)
    want = np.asarray(jax_resident(jnp.asarray(f), jnp.asarray(g),
                                   jnp.asarray(h), interpret=True))
    got = resident_attention(*map(torch.from_numpy, (f, g, h)))
    assert got.dtype == torch.float32 and got.shape == (2, t, 64)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_plain_keeps_h_dtype():
    f, g, h = _inputs(0, 1, 64, 8, 64)
    out = resident_attention_plain(*(torch.from_numpy(a).bfloat16()
                                     for a in (f, g, h)))
    assert out.dtype == torch.bfloat16


def test_self_attention_block_matches_flax():
    x = np.random.default_rng(3).normal(size=(1, 16, 16, 64)).astype(np.float32)
    jm = JaxSelfAttention(input_channels=64, impl="xla")
    params = jm.init(jax.random.PRNGKey(1), jnp.asarray(x))
    want = np.asarray(jm.apply(params, jnp.asarray(x)))
    tm = SelfAttentionBlock(64, gen=torch.Generator().manual_seed(0))
    tm.load_state_dict(flax_to_torch(jax.tree_util.tree_map(np.asarray,
                                                            params)))
    with torch.no_grad():
        got = tm(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_projection_init_is_lecun_with_zero_bias():
    tm = SelfAttentionBlock(64, gen=torch.Generator().manual_seed(0)).requires_grad_(False)
    assert torch.count_nonzero(tm.h.bias) == 0
    std = float(tm.h.weight.std())
    assert 0.8 * (1 / 64) ** 0.5 < std < 1.2 * (1 / 64) ** 0.5
    assert float(tm.h.weight.abs().max()) <= 2 * (1 / 64) ** 0.5 / 0.8796 + 1e-6


def test_timing_signal_matches_flax():
    x = np.random.default_rng(4).normal(size=(2, 5, 7, 16)).astype(np.float32)
    want = np.asarray(jax_timing(jnp.asarray(x)))
    got = add_timing_signal_2d(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_cuda_wrapper_rejects_cpu_tensor():
    f, g, h = map(torch.from_numpy, _inputs(0, 1, 16, 8, 64))
    with pytest.raises(ValueError, match="CUDA"):
        resident_attention_cuda(f, g, h)
