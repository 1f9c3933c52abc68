"""Streaming attention parity: the port's ``fused_attention`` (its blockwise
plain versions on the CPU) against the JAX package's ``fused_attention`` with
its Pallas bodies in interpret mode (forward: ``_stats_kernel`` and
``_accum_kernel``, asserted by a spy on ``pl.pallas_call``; backward:
``_fused_bwd`` through ``jax.grad``), the block's dispatch by ``impl`` and
token count, and a two-stage model with ``attention_impl="pallas"`` against
the JAX model with the same setting.

Tolerances (f32 on both sides unless said):
  * forward against JAX rtol 2e-4 / atol 2e-5 (the interpret-mode executable
    may come from the JAX compilation cache, and one built elsewhere sums in
    another order), and each side within 1e-5 / 2e-5 of the output's scale
    from a float64 reference, as for the resident pair;
  * gradients against ``jax.grad`` rtol 2e-3 / atol 2e-4 scaled by the
    gradient's largest magnitude (sums over T keys in two block orders; rho
    cancels against h . dout);
  * blockwise against materialised plain versions 1e-5 of the scale (the
    same f32 formula in another sum order);
  * the model: loss and metrics rel 1e-5, each gradient within 1e-4 of that
    tensor's largest |gradient| plus 1e-6 of the model's, as in
    ``test_torch_train.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from msau_tpu.config import ModelConfig
from msau_tpu.models.msau import build_model as jax_build_model
from msau_tpu.ops.pallas_attn import fused_attention as jax_fused
from msau_tpu.train import loss as jloss
from msau_tpu_torch import ops
from msau_tpu_torch.data.synth import make_structured_batch
from msau_tpu_torch.models import attention as attn_module
from msau_tpu_torch.models.attention import SelfAttentionBlock
from msau_tpu_torch.models.msau import build_model
from msau_tpu_torch.ops import attention as attn_ops
from msau_tpu_torch.ops.attention import (
    fused_attention,
    fused_attention_bwd_cuda,
    fused_attention_bwd_plain,
    fused_attention_cuda,
    fused_attention_plain_stats,
    resident_attention_bwd_plain,
    resident_attention_plain_stats,
)
from msau_tpu_torch.train.trainer import make_loss_and_grad
from msau_tpu_torch.utils.kernel_inputs import attention_inputs
from msau_tpu_torch.utils.transplant import flax_to_torch

PORT_REL, PALLAS_REL = 1e-5, 2e-5


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
    f, g, h = (a.astype(np.float64) for a in (f, g, h))
    s = np.einsum("nic,njc->nij", g, f)
    p = np.exp(s - s.max(-1, keepdims=True))
    return np.einsum("nij,nic->njc", p / p.sum(-1, keepdims=True), h)


def _jax_fused(f, g, h):
    return jax_fused(jnp.asarray(f), jnp.asarray(g), jnp.asarray(h),
                     block=256, interpret=True)


@pytest.mark.parametrize("t,cb,c", [(512, 8, 64), (256, 4, 16)])
def test_fused_attention_matches_pallas(kernels_run, t, cb, c):
    f, g, h = _inputs(t, 2, t, cb, c)
    pallas = np.asarray(_jax_fused(f, g, h))
    assert {"_stats_kernel", "_accum_kernel"} <= set(kernels_run)
    got = fused_attention(*map(torch.from_numpy, (f, g, h)))
    assert got.dtype == torch.float32 and got.shape == (2, t, c)
    np.testing.assert_allclose(got.numpy(), pallas, rtol=2e-4, atol=2e-5)
    want = _attention_f64(f, g, h)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=PORT_REL * scale)
    np.testing.assert_allclose(pallas, want, rtol=0, atol=PALLAS_REL * scale)


def test_fused_attention_grads_match_jax(kernels_run):
    """(df, dg, dh) through torch.autograd (the blockwise plain backward)
    against jax.grad through the Pallas forward and ``_fused_bwd``."""
    t, cb, c = 512, 4, 8
    f, g, h = _inputs(7, 2, t, cb, c)
    w = np.random.default_rng(8).normal(size=(2, t, c)).astype(np.float32)
    loss = lambda a, b, d: jnp.sum(_jax_fused(a, b, d) * jnp.asarray(w))
    want = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (f, g, h)))
    assert {"_stats_kernel", "_accum_kernel"} <= set(kernels_run)
    leaves = [torch.from_numpy(a).requires_grad_() for a in (f, g, h)]
    (fused_attention(*leaves) * torch.from_numpy(w)).sum().backward()
    for name, leaf, jw in zip("fgh", leaves, want):
        jw = np.asarray(jw)
        assert leaf.grad.dtype == torch.float32
        np.testing.assert_allclose(
            leaf.grad.numpy(), jw, rtol=2e-3,
            atol=2e-4 * max(1.0, np.abs(jw).max()), err_msg=f"d{name}")


def test_large_logits_stay_finite():
    """Logits x30 (scores of several thousand): the online max keeps every
    exponent at or below 0."""
    f, g, h = _inputs(3, 1, 300, 8, 64, scale=30.0)
    leaves = [torch.from_numpy(a).requires_grad_() for a in (f, g, h)]
    out = fused_attention(*leaves)
    out.sum().backward()
    assert torch.isfinite(out).all()
    assert all(torch.isfinite(x.grad).all() for x in leaves)
    want = _attention_f64(f, g, h)
    np.testing.assert_allclose(out.detach().numpy(), want, rtol=0,
                               atol=1e-4 * np.abs(want).max())


@pytest.mark.parametrize("t", [66, 300])
def test_ragged_t_matches_einsum(t):
    """T no multiple of the block: the last block is short."""
    f, g, h = _inputs(t, 2, t, 8, 64)
    got = fused_attention(*map(torch.from_numpy, (f, g, h)))
    want = _attention_f64(f, g, h)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=PORT_REL * max(1.0, np.abs(want).max()))


def test_bf16_operands_give_f32_output_equal_to_jax():
    f, g, h = _inputs(4, 2, 256, 8, 64)
    tb = [torch.from_numpy(a).bfloat16() for a in (f, g, h)]
    jb = [jnp.asarray(a).astype(jnp.bfloat16) for a in (f, g, h)]
    want = jax_fused(*jb, block=256, interpret=True)
    assert want.dtype == jnp.float32
    got = fused_attention(*tb)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                               atol=2e-5)


def test_bf16_operands_get_bf16_gradients_equal_to_jax():
    """Gradients are cast to the operands' dtypes on both sides; bf16 keeps
    8 bits, so one rounding of nearly equal f32 values: 2e-2 of the scale."""
    f, g, h = _inputs(5, 1, 256, 8, 64)
    w = np.random.default_rng(6).normal(size=(1, 256, 64)).astype(np.float32)
    jb = [jnp.asarray(a).astype(jnp.bfloat16) for a in (f, g, h)]
    loss = lambda a, b, d: jnp.sum(
        jax_fused(a, b, d, block=256, interpret=True) * jnp.asarray(w))
    want = jax.grad(loss, argnums=(0, 1, 2))(*jb)
    leaves = [torch.from_numpy(a).bfloat16().requires_grad_() for a in (f, g, h)]
    (fused_attention(*leaves) * torch.from_numpy(w)).sum().backward()
    for leaf, jw in zip(leaves, want):
        assert leaf.grad.dtype == torch.bfloat16 and jw.dtype == jnp.bfloat16
        jw = np.asarray(jw.astype(jnp.float32))
        np.testing.assert_allclose(leaf.grad.float().numpy(), jw, rtol=0,
                                   atol=2e-2 * max(1.0, np.abs(jw).max()))


@pytest.mark.parametrize("t,block", [(66, 256), (300, 256), (512, 256),
                                     (300, 64)])
def test_blockwise_plain_equals_materialised(t, block):
    f, g, h = map(torch.from_numpy, _inputs(t + block, 2, t, 8, 64, 2.0))
    out, m, l = fused_attention_plain_stats(f, g, h, block)
    wout, wm, wl = resident_attention_plain_stats(f, g, h)
    torch.testing.assert_close(m, wm, rtol=0, atol=0)
    torch.testing.assert_close(l, wl, rtol=1e-5, atol=0)
    scale = max(1.0, float(wout.abs().max()))
    torch.testing.assert_close(out, wout, rtol=0, atol=PORT_REL * scale)
    dout = torch.from_numpy(np.random.default_rng(t).normal(
        size=(2, t, 64)).astype(np.float32))
    got = fused_attention_bwd_plain(f, g, h, m, l, dout, block)
    want = resident_attention_bwd_plain(f, g, h, wm, wl, dout)
    for a, b in zip(got, want):
        torch.testing.assert_close(
            a, b, rtol=0, atol=PORT_REL * max(1.0, float(b.abs().max())))


def test_float64_operands_stay_float64():
    f, g, h = (torch.from_numpy(a).double() for a in _inputs(9, 1, 130, 8, 64))
    out, m, l = fused_attention_plain_stats(f, g, h, 64)
    assert out.dtype == m.dtype == l.dtype == torch.float64
    np.testing.assert_allclose(out.numpy(), _attention_f64(
        *(x.numpy() for x in (f, g, h))), rtol=0, atol=1e-12)
    grads = fused_attention_bwd_plain(f, g, h, m, l, out, 64)
    assert all(x.dtype == torch.float64 for x in grads)


# ------------------------------------------------------------- dispatch
@pytest.fixture
def ops_called(monkeypatch):
    """Replace the two autograd ops the block dispatches to by recorders."""
    called = []

    def recorder(name, dtype_of):
        def op(f, g, h):
            called.append(name)
            return torch.zeros(h.shape, dtype=dtype_of(h))
        return op

    monkeypatch.setattr(attn_module, "resident_attention",
                        recorder("resident", lambda h: h.dtype))
    monkeypatch.setattr(attn_module, "fused_attention",
                        recorder("streaming", lambda h: torch.float32))
    return called


@pytest.mark.parametrize("impl,hw,want", [
    ("auto", (8, 8), "resident"), ("auto", (64, 128), "streaming"),
    ("resident", (8, 8), "resident"), ("resident", (64, 128), "streaming"),
    ("pallas", (8, 8), "streaming"), ("pallas", (64, 128), "streaming"),
    ("xla", (8, 8), "resident"), ("xla", (64, 128), "streaming"),
])
def test_block_dispatch_follows_impl_and_tokens(ops_called, impl, hw, want):
    """T = 64 and T = 8192 under each ``impl``: the JAX block's rule
    (``models/attention.py``: blockwise for "pallas" or from 8192 tokens)."""
    block = SelfAttentionBlock(8, impl=impl, gen=torch.Generator().manual_seed(0))
    x = torch.zeros((1, 8, *hw))
    with torch.no_grad():
        y = block(x)
    assert ops_called == [want]
    assert y.shape == x.shape


def test_block_rejects_unknown_impl():
    with pytest.raises(ValueError, match="impl"):
        SelfAttentionBlock(8, impl="flash", gen=torch.Generator().manual_seed(0))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32,
                                   torch.float64])
def test_streaming_block_keeps_the_activation_dtype(dtype):
    """The streaming op returns f32; the block adds x in f32 and casts the
    sum once, so the layers after it keep the configured dtype."""
    block = SelfAttentionBlock(16, impl="pallas",
                               gen=torch.Generator().manual_seed(0)).to(dtype)
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=(1, 16, 6, 5)).astype(np.float32)).to(dtype)
    with torch.no_grad():
        y = block(x)
        ref = SelfAttentionBlock(16, impl="resident",
                                 gen=torch.Generator().manual_seed(0)).to(dtype)
        ref.load_state_dict(block.state_dict())
        want = ref(x)
    assert y.dtype == dtype
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-5
    torch.testing.assert_close(y.float(), want.float(), rtol=tol, atol=tol)


# ---------------------------------------------------------------- model
CFG = dict(img_channels=6, n_class=5, scale_space_num=3, res_depth=2,
           feat_root=4, num_blocks=2, final_act="softmax",
           attention_impl="pallas")


@pytest.fixture(scope="module")
def jax_and_port():
    """A two-stage model on 64 x 128 pages: T = 512 at the deepest scale,
    a multiple of the JAX CPU path's block (``self_attention_pallas``, 512;
    it falls to the einsum at any other T), so both sides stream blocks."""
    cfg = ModelConfig(**CFG)
    x, y = make_structured_batch(np.random.default_rng(0), 2, 128,
                                 cfg.n_class, cfg.img_channels, n_rects=6)
    x, y = x[:, :64], y[:, :64]
    valid = np.ones(y.shape, bool)
    valid[:, :, -5:] = False
    jm = jax_build_model(cfg)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(x[:1]))
    tm = build_model(cfg, torch.Generator().manual_seed(0))
    tm.load_state_dict(flax_to_torch(jax.tree_util.tree_map(np.asarray, params)))
    return cfg, jm, params, tm, {"input": x, "label": y, "valid": valid}


def test_pallas_model_matches_jax(jax_and_port, ops_called_passthrough):
    cfg, jm, params, tm, batch = jax_and_port
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    _, jlogits, _ = jm.apply(params, jb["input"])
    with torch.no_grad():
        _, tlogits, _ = tm(torch.from_numpy(batch["input"]))
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits),
                               rtol=1e-4, atol=1e-4)

    def jax_loss(p):
        _, logits, aux = jm.apply(p, jb["input"], train=True)
        return jloss.masked_cross_entropy(logits, aux, jb["label"], jb["valid"])

    (_, jmet), jgrads = jax.value_and_grad(jax_loss, has_aux=True)(params)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    _, tmet, tgrads = make_loss_and_grad(tm)(tb)
    assert set(ops_called_passthrough) == {"streaming"}
    for k in ("loss", "loss_final", "loss_aux", "accuracy"):
        assert abs(float(tmet[k]) - float(jmet[k])) <= 1e-5 * abs(float(jmet[k])), k
    want = flax_to_torch(jax.tree_util.tree_map(np.asarray, jgrads))
    assert set(want) == set(tgrads)
    scale = max(float(w.abs().max()) for w in want.values())
    for name, g in tgrads.items():
        w = want[name].numpy()
        np.testing.assert_allclose(
            g.numpy(), w, rtol=0, atol=1e-4 * np.abs(w).max() + 1e-6 * scale,
            err_msg=name)


@pytest.fixture
def ops_called_passthrough(monkeypatch):
    """Record which attention op the block runs, and run it."""
    called = []
    for name, attr in (("resident", "resident_attention"),
                       ("streaming", "fused_attention")):
        real = getattr(attn_module, attr)

        def op(f, g, h, real=real, name=name):
            called.append(name)
            return real(f, g, h)

        monkeypatch.setattr(attn_module, attr, op)
    return called


def test_pallas_model_under_remat_gives_the_same_gradients(jax_and_port):
    """``torch.utils.checkpoint`` around a stage whose attention is the
    streaming autograd op: the same gradients, bit for bit."""
    cfg, _, _, tm, batch = jax_and_port
    tr = build_model(dataclasses.replace(cfg, remat=True),
                     torch.Generator().manual_seed(0))
    tr.load_state_dict(tm.state_dict())
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    l0, _, g0 = make_loss_and_grad(tm)(tb)
    l1, _, g1 = make_loss_and_grad(tr)(tb)
    assert torch.equal(l0, l1)
    for name in g0:
        assert torch.equal(g0[name], g1[name]), name


def test_bf16_pallas_model_keeps_bf16_activations(jax_and_port):
    """A bf16 model with the streaming op: f32 logits, finite, near the f32
    model's (bf16 activations through 2 stages: 0.25 abs on logits of a few
    units), and f32 parameter gradients."""
    cfg, _, _, tm, batch = jax_and_port
    tb = build_model(dataclasses.replace(cfg, dtype="bfloat16"),
                     torch.Generator().manual_seed(0))
    tb.load_state_dict(tm.state_dict())
    seen = []
    hook = tb.net.block_1.down.dil_conv_0.register_forward_pre_hook(
        lambda mod, args: seen.append(args[0].dtype))
    x = torch.from_numpy(batch["input"])
    _, logits, _ = tb(x)
    hook.remove()
    assert seen == [torch.bfloat16]
    with torch.no_grad():
        _, want, _ = tm(x)
    assert logits.dtype == torch.float32 and torch.isfinite(logits).all()
    assert float((logits.detach() - want).abs().max()) < 0.25
    logits.sum().backward()
    assert all(p.grad.dtype == torch.float32 for p in tb.parameters()
               if p.grad is not None)


# ------------------------------------------------------- wrappers, sizing
def test_cuda_wrapper_rejects_cpu_tensor():
    f, g, h = map(torch.from_numpy, _inputs(0, 1, 16, 8, 64))
    with pytest.raises(ValueError, match="CUDA"):
        fused_attention_cuda(f, g, h)


def test_bwd_cuda_wrapper_rejects_cpu_tensor():
    f, g, h = map(torch.from_numpy, _inputs(0, 1, 16, 8, 64))
    m = l = torch.ones(1, 16)
    with pytest.raises(ValueError, match="CUDA"):
        fused_attention_bwd_cuda(f, g, h, m, l, h)


def test_launch_counters_are_registered():
    assert ops.KERNEL_WRAPPERS["fused_attention_fwd"] is fused_attention_cuda
    assert ops.KERNEL_WRAPPERS["fused_attention_bwd"] is fused_attention_bwd_cuda
    fused_attention_cuda.launches = 5
    ops.reset_launch_counts()
    assert ops.launch_counts()["fused_attention_fwd"] == 0
    # the CPU path launches nothing
    fused_attention(*map(torch.from_numpy, _inputs(0, 1, 16, 8, 64)))
    assert ops.launch_counts()["fused_attention_fwd"] == 0


@pytest.mark.parametrize("n,t,blocks", [
    (2, 16384, 128),   # the 1024^2 train step: 128 blocks per image
    (1, 16384, 128),   # one 1024^2 page
    (16, 4096, 16),
    (1, 66, 1),
])
def test_bwd_grid_sizing_on_a_132_sm_card(n, t, blocks):
    """The backward's blocks per image at two blocks per SM of a 132-SM
    card (its f32 path's shared memory at C = 64), from the shapes and the
    slots alone."""
    assert attn_ops.bwd_blocks_per_image(n, t, 64, 2 * 132) == blocks


# The streaming forward's bf16-operand instance on the card
# (csrc/attention.cu, AccShape with PA = 3, PH = 1) keeps A in f32 as three
# bf16 parts and multiplies them by h's one part; attention_mma.cuh:split2
# rounds each remainder to nearest even, as a cast to bf16 does.  Its
# arithmetic, emulated here with torch casts.
def _bf16_parts(x: torch.Tensor, parts: int):
    """x (f32) as ``parts`` bf16 tensors, the largest first, each the
    rounded remainder of the ones before (attention_mma.cuh:split2)."""
    out, r = [], x
    for _ in range(parts):
        b = r.to(torch.bfloat16)
        out.append(b)
        r = r - b.float()
    return out


def _a_like(rng, size):
    """Values in the range A takes: exp(s - m) / l over many binades."""
    return torch.from_numpy(
        np.exp(rng.uniform(-60.0, 0.0, size)).astype(np.float32))


@pytest.mark.parametrize("kind", ["softmax weights", "normals x 1e3"])
def test_f32_splits_into_three_bf16_parts_exactly(kind):
    rng = np.random.default_rng(0)
    x = (_a_like(rng, 100_000) if kind == "softmax weights" else
         torch.from_numpy((rng.normal(size=100_000) * 1e3).astype(np.float32)))
    parts = _bf16_parts(x, 3)
    total = sum(p.double() for p in parts)
    assert torch.equal(total, x.double())
    # two parts carry 16 bits: they miss some values by more than f32's
    # half ulp, so the kernel takes three
    two = parts[0].double() + parts[1].double()
    assert float(((two - x.double()).abs() / x.double().abs()).max()) > 2.0**-24


def test_bf16_value_has_zero_second_and_third_parts():
    rng = np.random.default_rng(1)
    h = torch.from_numpy(rng.normal(size=100_000).astype(np.float32)).to(
        torch.bfloat16)
    parts = _bf16_parts(h.float(), 3)
    assert torch.equal(parts[0], h)
    assert not parts[1].float().any() and not parts[2].float().any()


@pytest.mark.parametrize("k", [1, 16])
def test_three_a_parts_times_bf16_h_carry_the_f32_product(k):
    """sum over qa of A_qa h (the three products (qa, 0) of mma_parts<3, 1>),
    each product of bf16 values exact and summed in float64, is A h (one
    term: exactly; k > 1 terms, a k step of one mma: to float64's
    rounding), so it lies within f32's rounding, 2^-24 of |A h| per term,
    of the f32 products."""
    rng = np.random.default_rng(2)
    a = _a_like(rng, (4096, k))
    h = torch.from_numpy(rng.normal(size=(4096, k)).astype(np.float32)).to(
        torch.bfloat16)
    parts = _bf16_parts(a, 3)
    got = sum((p.double() * h.double()).sum(-1) for p in parts)
    magnitude = (a.double() * h.double()).abs().sum(-1)
    exact = (a.double() * h.double()).sum(-1)
    if k == 1:
        assert torch.equal(got, exact)
    assert bool(((got - exact).abs() <= 2.0**-50 * magnitude).all())
    f32 = (a * h.float()).double().sum(-1)
    assert bool(((got - f32).abs() <= 2.0**-24 * magnitude).all())
