"""The attention at every width the JAX block takes.  The port's plain
versions (what its ops run on the CPU; on the card the general kernels of
``csrc/attention_general.cuh`` run every (Cb, C) outside
``SPECIALISED_WIDTHS``) against the JAX package's Pallas bodies in
interpret mode: ``resident_attention`` (``_res_fwd_kernel``,
``_res_bwd_kernel``) and ``fused_attention`` (``_stats_kernel``,
``_accum_kernel``, then ``_fused_bwd``), forward with m and l, and the VJP,
at widths the model builds (feat_root 12: C 96; pool 3: C 216; 6 scales at
feat_root 16: C 512; 32 at 6: C 1024) and odd ones (C 4, 20, 24).  A ragged
T (not a multiple of 8) runs on the port alone, against float64.  Then one
model per new configuration, 1 stage in f32, the port's seeded parameters
carried over to the JAX model by ``utils/transplant.py`` (``torch_to_flax``;
its gradients come back by ``flax_to_torch``): logits and the loss
gradient.  Last, the wiring the card run relies on: the general backward's
scratch and column blocks, every C entry point's ctypes signature, and
phase 9a's flat launches per request (``chip_smoke.P9_SERVE_FS3``).

Tolerances, as in ``test_torch_attention.py``: f32 on both sides, forward
rtol = atol = 1e-5 (sum orders), m the same (logits reach 40 at Cb 128,
where one f32 ulp is 3.8e-6) and l rtol 1e-5; gradients
1e-5 x max(1, max |gradient|) with rtol 1e-5.  The models: logits 1e-4,
loss rel 1e-5 and each gradient within 1e-4 of that tensor's largest
|gradient| plus 1e-6 of the model's, as in ``test_torch_fused_attention.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from msau_tpu.config import ModelConfig as JaxModelConfig
from msau_tpu.models.msau import build_model as jax_build_model
from msau_tpu.ops import pallas_attn
from msau_tpu.train import loss as jloss
from msau_tpu_torch.config import ModelConfig
from msau_tpu_torch.data.synth import make_structured_batch
from msau_tpu_torch.models.msau import build_model
from msau_tpu_torch.ops import attention as attn_ops
from msau_tpu_torch.ops import cuda_lib
from msau_tpu_torch.ops.attention import (
    fused_attention,
    fused_attention_bwd_plain,
    fused_attention_plain_stats,
    resident_attention,
    resident_attention_bwd_plain,
    resident_attention_cuda,
    resident_attention_plain_stats,
)
from msau_tpu_torch.train.trainer import make_loss_and_grad
from msau_tpu_torch.utils.kernel_inputs import attention_inputs
from msau_tpu_torch.utils.transplant import flax_to_torch, torch_to_flax

# (Cb, C, T) with T a multiple of 8 (the Pallas kernels' blocks divide it)
WIDTHS = [(1, 4, 64), (2, 20, 128), (3, 24, 64), (12, 96, 256),
          (27, 216, 128), (48, 384, 64), (64, 512, 64), (128, 1024, 32)]
RAGGED_T = 37
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def kernels_run(monkeypatch):
    seen = []
    real = pl.pallas_call

    def spy(kernel, *args, **kwargs):
        seen.append(getattr(kernel, "func", kernel).__name__)
        return real(kernel, *args, **kwargs)

    monkeypatch.setattr(pl, "pallas_call", spy)
    return seen


def _inputs(cb, c, t, n=2):
    rng = np.random.default_rng(cb * 1000 + c + t)
    f, g, h = attention_inputs(rng, n, t, cb, c)
    dout = rng.normal(size=(n, t, c)).astype(np.float32)
    return f, g, h, dout


def _assert_grads(got, want):
    for name, a, w in zip(("df", "dg", "dh"), got, want):
        w = np.asarray(w, dtype=np.float64)
        np.testing.assert_allclose(
            a.double().numpy(), w, rtol=1e-5,
            atol=1e-5 * max(1.0, float(np.abs(w).max())), err_msg=name)


@pytest.mark.parametrize("cb,c,t", WIDTHS)
def test_resident_forward_and_stats_match_pallas(cb, c, t, kernels_run):
    f, g, h, _ = _inputs(cb, c, t)
    out, m, l = pallas_attn._resident_forward(
        *map(jnp.asarray, (f, g, h)), True)
    assert kernels_run == ["_res_fwd_kernel"]
    got, gm, gl = resident_attention_plain_stats(*map(torch.from_numpy,
                                                      (f, g, h)))
    assert got.shape == (2, t, c) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(out), **TOL)
    np.testing.assert_allclose(gm.numpy(), np.asarray(m)[..., 0], **TOL)
    np.testing.assert_allclose(gl.numpy(), np.asarray(l)[..., 0], rtol=1e-5,
                               atol=0)


@pytest.mark.parametrize("cb,c,t", WIDTHS)
def test_resident_vjp_matches_pallas(cb, c, t, kernels_run):
    """(df, dg, dh) through the port's autograd op (the plain backward)
    against jax.vjp of the Pallas pair."""
    f, g, h, dout = _inputs(cb, c, t)
    _, vjp = jax.vjp(
        lambda a, b, d: pallas_attn.resident_attention(a, b, d,
                                                       interpret=True),
        *map(jnp.asarray, (f, g, h)))
    want = vjp(jnp.asarray(dout))
    assert kernels_run == ["_res_fwd_kernel", "_res_bwd_kernel"]
    leaves = [torch.from_numpy(a).requires_grad_() for a in (f, g, h)]
    resident_attention(*leaves).backward(torch.from_numpy(dout))
    _assert_grads([x.grad for x in leaves], want)


@pytest.mark.parametrize("cb,c,t", WIDTHS)
def test_fused_forward_and_stats_match_pallas(cb, c, t, kernels_run):
    """The blockwise plain forward (blocks of 16 keys, so several) against
    the streaming Pallas pair in blocks of T / 2."""
    f, g, h, _ = _inputs(cb, c, t)
    out, m, l = pallas_attn._fused_forward(
        *map(jnp.asarray, (f, g, h)), t // 2, True)
    assert kernels_run == ["_stats_kernel", "_accum_kernel"]
    got, gm, gl = fused_attention_plain_stats(
        *map(torch.from_numpy, (f, g, h)), block=16)
    np.testing.assert_allclose(got.numpy(), np.asarray(out), **TOL)
    np.testing.assert_allclose(gm.numpy(), np.asarray(m)[..., 0], **TOL)
    np.testing.assert_allclose(gl.numpy(), np.asarray(l)[..., 0], rtol=1e-5,
                               atol=0)


@pytest.mark.parametrize("cb,c,t", WIDTHS)
def test_fused_vjp_matches_jax(cb, c, t, kernels_run):
    """The port's streaming op against jax.vjp of ``fused_attention``
    (forward in interpret mode, backward ``_fused_bwd``)."""
    f, g, h, dout = _inputs(cb, c, t)
    _, vjp = jax.vjp(
        lambda a, b, d: pallas_attn.fused_attention(a, b, d, block=t // 2,
                                                    interpret=True),
        *map(jnp.asarray, (f, g, h)))
    want = vjp(jnp.asarray(dout))
    assert kernels_run == ["_stats_kernel", "_accum_kernel"]
    leaves = [torch.from_numpy(a).requires_grad_() for a in (f, g, h)]
    fused_attention(*leaves, block=16).backward(torch.from_numpy(dout))
    _assert_grads([x.grad for x in leaves], want)


def _f64_reference(f, g, h, dout):
    """out, m, l and the gradients in float64 (the plain versions' formula
    at float64: the exact answer)."""
    f, g, h, dout = (torch.from_numpy(a).double() for a in (f, g, h, dout))
    out, m, l = resident_attention_plain_stats(f, g, h)
    return (out, m, l), resident_attention_bwd_plain(f, g, h, m, l, dout)


@pytest.mark.parametrize("cb,c", [w[:2] for w in WIDTHS])
def test_ragged_t_port_alone(cb, c):
    """T = 37 (no multiple of 8): the resident and the streaming plain
    versions, forward and backward, against float64."""
    f, g, h, dout = _inputs(cb, c, RAGGED_T)
    (want, wm, wl), wgrads = _f64_reference(f, g, h, dout)
    ft, gt, ht, dt = map(torch.from_numpy, (f, g, h, dout))
    for name, (out, m, l) in (
            ("resident", resident_attention_plain_stats(ft, gt, ht)),
            ("streaming", fused_attention_plain_stats(ft, gt, ht, block=16))):
        np.testing.assert_allclose(out.double().numpy(), want.numpy(), **TOL,
                                   err_msg=name)
        np.testing.assert_allclose(m.double().numpy(), wm.numpy(), **TOL,
                                   err_msg=name)
        np.testing.assert_allclose(l.double().numpy(), wl.numpy(), rtol=1e-5,
                                   atol=0, err_msg=name)
        grads = (resident_attention_bwd_plain if name == "resident" else
                 lambda *a: fused_attention_bwd_plain(*a, block=16))(
            ft, gt, ht, m, l, dt)
        _assert_grads(grads, [w.numpy() for w in wgrads])


@pytest.mark.parametrize("cb,c", [w[:2] for w in WIDTHS] + [(8, 64),
                                                              (300, 2400)])
def test_every_width_passes_the_operand_check(cb, c):
    """No width is refused, a Cb past the general kernels' staged columns
    (300) among them: the check stops a CPU tensor at its device, not at
    its width."""
    f, g, h = map(torch.from_numpy, attention_inputs(
        np.random.default_rng(0), 1, 16, cb, c))
    with pytest.raises(ValueError, match="CUDA"):
        resident_attention_cuda(f, g, h)


@pytest.mark.parametrize("c,groups", [(1, 1), (4, 1), (20, 1), (96, 1),
                                      (128, 1), (129, 1), (216, 1), (256, 1),
                                      (257, 2), (512, 2), (1024, 4),
                                      (1025, 5), (2400, 10)])
def test_general_bwd_rho_groups(c, groups):
    """Column groups of the general dh kernel: one covers C up to 256
    columns (16 n8 tiles up to 128, 32 above), so rho needs one partial
    slice per 256 columns past 256."""
    assert attn_ops.general_bwd_rho_groups(c) == groups


@pytest.mark.parametrize("f32,slots", [(True, 132), (False, 264)])
def test_general_bwd_slots(f32, slots):
    """The general ds kernel's blocks on the H100 at once, without asking
    the card: one an SM with f32 operands, two with bf16."""
    assert attn_ops.general_bwd_slots(f32) == slots


@pytest.mark.parametrize("n,t,cb,c,per_image,per_image_f32", [
    # 9a's train step: 32 tiles an image, 2 a block (f32: 4 on 132 slots)
    (16, 4096, 12, 96, 16, 8),
    (2, 16384, 12, 96, 128, 64),    # 9c's streaming backward
    (1, 4096, 12, 96, 32, 32),      # one image: a tile a block
    (4, 256, 64, 512, 2, 4),        # 9b: two rho slices; f32 64-row tiles
    (4, 324, 27, 216, 3, 3),        # 9d: a ragged last tile
    (2, 70, 128, 1024, 1, 2),       # four rho slices
    (1, 64, 300, 2400, 1, 1),       # Cb past the staged columns, ten slices
    (2, 37, 1, 4, 1, 1),            # one tile
])
@pytest.mark.parametrize("dtype,dout_f32", [(torch.bfloat16, False),
                                            (torch.bfloat16, True),
                                            (torch.float32, False)])
def test_general_bwd_scratch(monkeypatch, n, t, cb, c, per_image,
                             per_image_f32, dtype, dout_f32):
    """Outside SPECIALISED_WIDTHS the backward's scratch is the general
    kernels' rho slices [groups, N, T] then one df slice [N, T, Cb] per
    block of an image, flat f32, sized without asking the card: the
    batch's row tiles (general_bwd_rows: 128, or 64 with f32 operands at
    Cb > 32) over general_bwd_slots."""
    class Lib:
        def msau_attention_bwd_slots(self, *args):
            raise AssertionError("the general backward needs no slots")

    monkeypatch.setattr(cuda_lib, "library", Lib)
    f = torch.zeros((n, t, cb), dtype=dtype)
    partial, blocks = attn_ops._bwd_scratch(f, c, dout_f32)
    f32 = dtype == torch.float32
    assert blocks == (per_image_f32 if f32 else per_image)
    assert blocks <= -(-t // attn_ops.general_bwd_rows(cb, f32))
    groups = attn_ops.general_bwd_rho_groups(c)
    assert partial.shape == (groups * n * t + blocks * n * t * cb,)
    assert partial.dtype == torch.float32


# ---------------------------------------------------------------- models
# one per new configuration: feat_root 12 at 4 scales (C 96, Cb 12),
# feat_root 16 at 6 scales (C 512, Cb 64), pool 3 at 4 scales (C 216,
# Cb 27); 1 stage, f32
MODELS = {
    "feat_root12_4_scales": (dict(feat_root=12, scale_space_num=4), 64),
    "feat_root16_6_scales": (dict(feat_root=16, scale_space_num=6), 128),
    "pool3_4_scales": (dict(feat_root=8, scale_space_num=4, pool_size=3),
                       162),
}
BASE = dict(img_channels=5, n_class=4, res_depth=1, num_blocks=1,
            final_act="softmax")


@pytest.mark.parametrize("name", sorted(MODELS))
def test_model_at_new_width_matches_jax(name):
    kwargs, side = MODELS[name]
    kwargs = dict(BASE, **kwargs)
    jcfg, tcfg = JaxModelConfig(**kwargs), ModelConfig(**kwargs)
    x, y = make_structured_batch(np.random.default_rng(1), 1, side,
                                 tcfg.n_class, tcfg.img_channels, n_rects=4)
    valid = np.ones(y.shape, bool)
    valid[:, :, -3:] = False
    jm = jax_build_model(jcfg)
    tm = build_model(tcfg, torch.Generator().manual_seed(0))
    params = jax.tree_util.tree_map(jnp.asarray,
                                    torch_to_flax(tm.state_dict()))
    last = f"attention_{tcfg.scale_space_num - 1}"
    block = next(m for n, m in tm.named_modules() if n.endswith(last))
    c = tcfg.feat_root * tcfg.pool_size ** (tcfg.scale_space_num - 1)
    assert block.h.weight.shape[0] == c
    assert block.f.weight.shape[0] == max(c // 8, 1)
    jb = {"input": jnp.asarray(x), "label": jnp.asarray(y),
          "valid": jnp.asarray(valid)}
    _, jlogits, _ = jax.jit(jm.apply)(params, jb["input"])
    with torch.no_grad():
        _, tlogits, _ = tm(torch.from_numpy(x))
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits),
                               rtol=1e-4, atol=1e-4)

    def jax_loss(p):
        _, logits, aux = jm.apply(p, jb["input"], train=True)
        return jloss.masked_cross_entropy(logits, aux, jb["label"],
                                          jb["valid"])

    (_, jmet), jgrads = jax.jit(jax.value_and_grad(jax_loss, has_aux=True))(
        params)
    tb = {"input": torch.from_numpy(x), "label": torch.from_numpy(y),
          "valid": torch.from_numpy(valid)}
    _, tmet, tgrads = make_loss_and_grad(tm)(tb)
    assert abs(float(tmet["loss"]) - float(jmet["loss"])) <= 1e-5 * abs(
        float(jmet["loss"]))
    want = flax_to_torch(jax.tree_util.tree_map(np.asarray, jgrads))
    assert set(want) == set(tgrads)
    scale = max(float(w.abs().max()) for w in want.values())
    for pname, gr in tgrads.items():
        w = want[pname].numpy()
        np.testing.assert_allclose(
            gr.numpy(), w, rtol=0, atol=1e-4 * np.abs(w).max() + 1e-6 * scale,
            err_msg=pname)


# ---------------------------------------------------------------- the card run
def test_every_c_entry_point_has_a_signature():
    """Each ``extern "C"`` function of ``csrc/*.cu`` has its argument types
    in ``cuda_lib.SIGNATURES``, and nothing else is there."""
    import re

    names = set()
    for src in cuda_lib.CSRC.glob("*.cu"):
        names |= set(re.findall(r'extern "C" \w+\s+(\w+)\(', src.read_text()))
    assert names == set(cuda_lib.SIGNATURES)


def test_phase9_serve_launches_at_feat_root_12(monkeypatch):
    """``chip_smoke.P9_SERVE_FS3``: a feat_root-12 request at flat_scales 3
    (9a) launches the flat kernels it lists; the residual blocks, at 12,
    24 and 48 channels outside ``FUSED_CHANNELS``, run as two flat convs
    each.  Every flat wrapper is replaced by a counter over its plain
    version."""
    import chip_smoke
    from msau_tpu_torch.ops import flatconv, flatres

    counts = {}
    for mod in (flatconv, flatres):
        monkeypatch.setattr(mod, "on_cuda", lambda name, t: True)
        for attr in dir(mod):
            if attr.endswith("_cuda") and hasattr(mod, attr[:-5] + "_plain"):
                name, plain = attr[:-5], getattr(mod, attr[:-5] + "_plain")

                def counted(*a, _name=name, _plain=plain, **k):
                    counts[_name] = counts.get(_name, 0) + 1
                    return _plain(*a, **k)

                monkeypatch.setattr(mod, attr, counted)
    model = build_model(ModelConfig(**dict(chip_smoke.P9_FLAGSHIP,
                                           img_channels=8, flat_scales=3)),
                        torch.Generator().manual_seed(0))
    x = torch.from_numpy(np.random.default_rng(0).random(
        (1, 64, 64, 8)).astype(np.float32))
    with torch.no_grad():
        model(x)
    want = {k: v for k, v in chip_smoke.P9_SERVE_FS3.items()
            if k not in ("paint", "resident_attention_fwd", "ccl_multiclass")}
    assert {k: v for k, v in counts.items() if v} == {
        k: v for k, v in want.items() if v}
