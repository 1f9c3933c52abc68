"""Attention parity: the port's resident_attention against the TPU kernel
(resident_attention in interpret mode), forward and backward, and the
SelfAttentionBlock module against flax with bridged weights.

Tolerance rtol/atol 1e-5: f32 on both sides; the residue is the softmax
sum order over T = 256..512 keys.  The forward holds the port and the
Pallas kernel each against a float64 reference, within 1e-5 and 2e-5 of
the output's scale, so the check does not depend on which executable the
JAX compilation cache hands the kernel.  The backward's atol is 1e-5 scaled by the
gradient's largest magnitude: df and dg reach 90 at scale 6, where two f32
summation orders differ by about 1e-6 of that (and each is as far from an
f64 reference as from the other).

The bf16 cases hold the port to the TPU kernels with bf16 operands: both
sides round A (and, in the backward, ds) to bf16 where
``_res_fwd_kernel`` / ``_res_bwd_kernel`` do and sum in f32, so what is
left is the sum order and a bf16 rounding of the output that the order can
flip: within 1e-3 of max(1, max |JAX|) forward and 2e-3 backward (the
plain versions that kept A and ds in f32 were 4.7e-3 to 7.6e-3 away).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from msau_tpu.models.attention import SelfAttentionBlock as JaxSelfAttention
from msau_tpu.models.attention import add_timing_signal_2d as jax_timing
from msau_tpu.ops.pallas_attn import resident_attention as jax_resident
from msau_tpu_torch.models.attention import SelfAttentionBlock, add_timing_signal_2d
from msau_tpu_torch.ops import attention as attn_ops
from msau_tpu_torch.ops import cuda_lib
from msau_tpu_torch.ops.attention import (
    resident_attention,
    resident_attention_bwd_cuda,
    resident_attention_bwd_plain,
    resident_attention_cuda,
    resident_attention_plain,
    resident_attention_plain_stats,
)
from msau_tpu_torch.utils.kernel_inputs import attention_inputs
from msau_tpu_torch.utils.transplant import flax_to_torch

TOL = dict(rtol=1e-5, atol=1e-5)
BF16_FWD_REL, BF16_BWD_REL = 1e-3, 2e-3


@pytest.fixture
def kernels_run(monkeypatch):
    seen = []
    real = pl.pallas_call

    def spy(kernel, *args, **kwargs):
        seen.append(getattr(kernel, "func", kernel).__name__)
        return real(kernel, *args, **kwargs)

    monkeypatch.setattr(pl, "pallas_call", spy)
    return seen


def _inputs(seed, n, t, cb, c, scale=1.0):
    return attention_inputs(np.random.default_rng(seed), n, t, cb, c, scale)


def _attention_f64(f, g, h):
    """out_j = sum_i h_i softmax_j(g_i . f_j) in float64 numpy."""
    f, g, h = (a.astype(np.float64) for a in (f, g, h))
    s = np.einsum("nic,njc->nij", g, f)
    p = np.exp(s - s.max(-1, keepdims=True))
    return np.einsum("nij,nic->njc", p / p.sum(-1, keepdims=True), h)


# bounds against f64 as a share of max(1, max |out|): the port's is 1e-5
# (f32 logits of several hundred at scale 6 alone put both f32 results
# 2.7e-5 from f64 at scale 11); the Pallas kernel's interpret-mode
# executable comes from the JAX compilation cache, and one built elsewhere
# gave 5.3e-5 at scale 5.6 where a fresh one gives 2e-6
PORT_REL, PALLAS_REL = 1e-5, 2e-5


@pytest.mark.parametrize("t,scale", [(256, 1.0), (512, 1.0), (256, 6.0)])
def test_resident_attention_matches_pallas(t, scale):
    """The port and the Pallas kernel, each against the float64
    reference; scale 6 gives logits of several hundred: the softmax must
    stay exact (max-subtracted) there."""
    f, g, h = _inputs(t, 2, t, 8, 64, scale)
    want = _attention_f64(f, g, h)
    pallas = np.asarray(jax_resident(jnp.asarray(f), jnp.asarray(g),
                                     jnp.asarray(h), interpret=True))
    got = resident_attention(*map(torch.from_numpy, (f, g, h)))
    assert got.dtype == torch.float32 and got.shape == (2, t, 64)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=PORT_REL * scale)
    np.testing.assert_allclose(pallas, want, rtol=0, atol=PALLAS_REL * scale)


@pytest.mark.parametrize("t,scale", [(256, 1.0), (512, 1.0), (256, 6.0)])
def test_resident_attention_backward_matches_pallas(t, scale):
    """(df, dg, dh) through torch.autograd (the plain backward) against
    jax.vjp of the Pallas pair, whose backward is _res_bwd_kernel."""
    rng = np.random.default_rng(t + 1)
    f, g, h = _inputs(t, 2, t, 8, 64, scale)
    dout = rng.normal(size=(2, t, 64)).astype(np.float32)
    _, vjp = jax.vjp(lambda a, b, c: jax_resident(a, b, c, interpret=True),
                     *map(jnp.asarray, (f, g, h)))
    want = vjp(jnp.asarray(dout))
    ft, gt, ht = (torch.from_numpy(a).requires_grad_() for a in (f, g, h))
    resident_attention(ft, gt, ht).backward(torch.from_numpy(dout))
    for got, w in zip((ft.grad, gt.grad, ht.grad), want):
        w = np.asarray(w)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), w, rtol=1e-5,
                                   atol=1e-5 * max(1.0, np.abs(w).max()))


def _err_beyond_ulp(got, want):
    """max over elements of (|got - want| - one bf16 ulp of want), floored
    at 0, over max(1, max |want|); in float64."""
    got, want = (np.asarray(a, dtype=np.float64) for a in (got, want))
    mag = np.maximum(np.abs(want), 2.0 ** -126)
    ulp = 2.0 ** (np.floor(np.log2(mag)) - 7)
    beyond = np.maximum(np.abs(got - want) - ulp, 0.0)
    return float(beyond.max() / max(1.0, np.abs(want).max()))


@pytest.mark.parametrize("t", [256, 512])
def test_resident_attention_bf16_matches_pallas(t, kernels_run):
    """bf16 operands: the plain forward (A rounded to bf16 before Aᵀh)
    against _res_fwd_kernel in interpret mode."""
    f, g, h = _inputs(t, 2, t, 8, 64)
    pallas = jax_resident(*(jnp.asarray(a).astype(jnp.bfloat16)
                            for a in (f, g, h)), interpret=True)
    assert kernels_run == ["_res_fwd_kernel"]
    got = resident_attention(*(torch.from_numpy(a).bfloat16()
                               for a in (f, g, h)))
    assert got.dtype == torch.bfloat16 and pallas.dtype == jnp.bfloat16
    assert _err_beyond_ulp(got.float().numpy(),
                           np.asarray(pallas.astype(jnp.float32))) <= BF16_FWD_REL


@pytest.mark.parametrize("t", [256, 512])
def test_resident_attention_bf16_backward_matches_pallas(t, kernels_run):
    """bf16 operands and cotangent: (df, dg, dh) through torch.autograd
    (the plain backward, A and ds rounded to bf16 before their products)
    against jax.vjp of the Pallas pair."""
    rng = np.random.default_rng(t + 1)
    f, g, h = _inputs(t, 2, t, 8, 64)
    dout = rng.normal(size=(2, t, 64)).astype(np.float32)
    _, vjp = jax.vjp(lambda a, b, c: jax_resident(a, b, c, interpret=True),
                     *(jnp.asarray(a).astype(jnp.bfloat16) for a in (f, g, h)))
    want = vjp(jnp.asarray(dout).astype(jnp.bfloat16))
    assert kernels_run == ["_res_fwd_kernel", "_res_bwd_kernel"]
    leaves = [torch.from_numpy(a).bfloat16().requires_grad_()
              for a in (f, g, h)]
    resident_attention(*leaves).backward(torch.from_numpy(dout).bfloat16())
    for name, x, w in zip(("df", "dg", "dh"), leaves, want):
        assert x.grad.dtype == torch.bfloat16 and w.dtype == jnp.bfloat16
        err = _err_beyond_ulp(x.grad.float().numpy(),
                              np.asarray(w.astype(jnp.float32)))
        assert err <= BF16_BWD_REL, (name, err)


def test_bwd_plain_keeps_input_dtypes():
    f, g, h = (torch.from_numpy(a).bfloat16() for a in _inputs(0, 1, 64, 8, 64))
    _, m, l = resident_attention_plain_stats(f, g, h)
    grads = resident_attention_bwd_plain(f, g, h, m, l, h)
    assert [t.dtype for t in grads] == [torch.bfloat16] * 3
    assert [t.shape for t in grads] == [f.shape, g.shape, h.shape]


def test_plain_stats_are_row_max_and_sum_exp():
    f, g, h = map(torch.from_numpy, _inputs(5, 1, 40, 8, 64))
    out, m, l = resident_attention_plain_stats(f, g, h)
    s = torch.einsum("nic,njc->nij", g, f)
    torch.testing.assert_close(m, s.amax(-1))
    torch.testing.assert_close(l, torch.exp(s - m[..., None]).sum(-1))
    torch.testing.assert_close(out, resident_attention_plain(f, g, h), **TOL)


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


def test_bwd_cuda_wrapper_rejects_cpu_tensor():
    f, g, h = map(torch.from_numpy, _inputs(0, 1, 16, 8, 64))
    m = l = torch.ones(1, 16)
    with pytest.raises(ValueError, match="CUDA"):
        resident_attention_bwd_cuda(f, g, h, m, l, h)


@pytest.mark.parametrize("n,t,cb,c,slots,shape", [
    # the flagship train step's backward at 4 and 2 blocks per SM
    (16, 4096, 8, 64, 528, (32, 16, 4096, 8)),
    (16, 4096, 8, 64, 264, (16, 16, 4096, 8)),
    # config 5's streaming backward (N 2, T 16384) at 2 blocks per SM
    (2, 16384, 8, 64, 264, (128, 2, 16384, 8)),
    (1, 4096, 8, 64, 528, (32, 1, 4096, 8)),
    (3, 66, 8, 64, 528, (1, 3, 66, 8)),
    (1, 300, 16, 128, 132, (5, 1, 300, 16)),   # C = 128: 64-row tiles
])
@pytest.mark.parametrize("dtype,dout_f32", [(torch.float32, False),
                                            (torch.bfloat16, False),
                                            (torch.bfloat16, True)])
def test_bwd_scratch_shapes(monkeypatch, n, t, cb, c, slots, shape, dtype,
                            dout_f32):
    """The backward wrappers' df scratch: one f32 [N, T, Cb] slice per block
    of an image, the blocks from the slots the card reports."""
    calls = []

    class Lib:
        def msau_attention_bwd_slots(self, *args):
            calls.append(args)
            return slots

    monkeypatch.setattr(cuda_lib, "library", Lib)
    f = torch.zeros((n, t, cb), dtype=dtype)
    partial, per_image = attn_ops._bwd_scratch(f, c, dout_f32)
    assert partial.shape == shape and partial.dtype == torch.float32
    assert per_image == shape[0]
    assert calls == [(cb, c, int(dtype == torch.bfloat16), int(dout_f32))]


def test_bwd_scratch_raises_on_a_failed_slot_query(monkeypatch):
    class Lib:
        def msau_attention_bwd_slots(self, *args):
            return -98

    monkeypatch.setattr(cuda_lib, "library", Lib)
    with pytest.raises(RuntimeError, match="98"):
        attn_ops._bwd_scratch(torch.zeros((1, 64, 8)), 64, False)


def test_self_attention_block_grads_match_flax():
    """Parameter and input gradients of the block (projections + the
    autograd attention op) against jax.grad of the flax block."""
    x = np.random.default_rng(6).normal(size=(2, 16, 16, 64)).astype(np.float32)
    w = np.random.default_rng(7).normal(size=x.shape).astype(np.float32)
    jm = JaxSelfAttention(input_channels=64, impl="xla")
    params = jm.init(jax.random.PRNGKey(2), jnp.asarray(x))
    loss = lambda p, xx: jnp.sum(jm.apply(p, xx) * jnp.asarray(w))
    jp, jx = jax.grad(loss, argnums=(0, 1))(params, jnp.asarray(x))
    tm = SelfAttentionBlock(64, gen=torch.Generator().manual_seed(0))
    tm.load_state_dict(flax_to_torch(jax.tree_util.tree_map(np.asarray,
                                                            params)))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_()
    (tm(xt).permute(0, 2, 3, 1) * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(xt.grad.permute(0, 2, 3, 1).numpy(),
                               np.asarray(jx), rtol=1e-4, atol=1e-4)
    want = flax_to_torch(jax.tree_util.tree_map(np.asarray, jp))
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(),
                                   rtol=1e-4, atol=1e-4, err_msg=name)
