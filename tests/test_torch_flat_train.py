"""Training at flat_scales > 0 on the CPU (the flat ops' plain versions and
their backward): the port's loss, metrics and every parameter's gradient
against the JAX package, at flat_scales 0 and against its flat model, whose
Pallas backward kernels run in interpret mode; one Trainer step at
flat_scales 2 against flat_scales 0; remat; and feat_root 16 at flat_scales
3 (an LRN over 64 channels), all at 64x64 from the same weights; and in
float64, where nothing is rounded to f32, the flat step equals the fs=0
step.

Tolerances (f32 on both sides): loss and metrics rel 1e-5, grad_norm rel
1e-4, each parameter's gradient within 1e-4 of that tensor's largest
|gradient| plus 1e-6 of the model's largest (the attention's f-projection
bias has an exact gradient of 0, where both sides carry f32 noise): the
same bounds as tests/test_torch_train.py.  Parameters after one Adam step
(each moves by about the learning rate, 1e-4) within 1e-6 plus rel 1e-6:
where a gradient is near Adam's eps, its step depends on the gradient's
last digits.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from msau_tpu.config import ModelConfig as JaxModelConfig
from msau_tpu.models.msau import build_model as jax_build_model
from msau_tpu.train import loss as jloss
from msau_tpu_torch.config import ModelConfig, TrainConfig
from msau_tpu_torch.data.synth import make_structured_batch
from msau_tpu_torch.models.msau import build_model
from msau_tpu_torch.train.optimizer import global_norm
from msau_tpu_torch.train.trainer import Trainer, make_loss_and_grad
from msau_tpu_torch.utils.transplant import flax_to_torch, torch_to_flax

CFG = dict(img_channels=6, n_class=5, scale_space_num=3, res_depth=2,
           feat_root=4, num_blocks=2, final_act="softmax")


def _rel(a, b):
    return abs(float(a) - float(b)) / max(abs(float(b)), 1e-12)


def _batch(n, seed=0, hw=64):
    x, y = make_structured_batch(np.random.default_rng(seed), n, hw, 5, 6,
                                 n_rects=6)
    valid = np.ones(y.shape, bool)
    valid[:, :, -5:] = False
    return {"input": x, "label": y, "valid": valid}


def _jax_value_and_grad(cfg, params, batch):
    """JAX's masked loss on channel-major logits and its gradients."""
    jm = jax_build_model(cfg)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def loss_fn(p):
        _, logits, aux = jm.apply(p, jb["input"], train=True,
                                  logits_layout="NCHW")
        n, c = logits.shape[:2]
        return jloss.masked_cross_entropy(
            logits.reshape(n, c, -1), aux.reshape(n, c, -1),
            jb["label"].reshape(n, -1), jb["valid"].reshape(n, -1),
            channel_axis=1)

    (loss, metrics), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
    return loss, metrics, flax_to_torch(jax.tree_util.tree_map(np.asarray,
                                                               grads))


def _check(loss, metrics, grads, want_loss, want_metrics, want_grads):
    assert _rel(loss, want_loss) <= 1e-5
    for k in ("loss", "loss_final", "loss_aux", "accuracy"):
        assert _rel(metrics[k], want_metrics[k]) <= 1e-5, k
    assert set(grads) == set(want_grads)
    scale = max(float(np.abs(np.asarray(w)).max()) for w in want_grads.values())
    for name, g in grads.items():
        w = np.asarray(want_grads[name])
        assert g.dtype == torch.float32
        np.testing.assert_allclose(
            g.numpy(), w, rtol=0, atol=1e-4 * np.abs(w).max() + 1e-6 * scale,
            err_msg=name)
    assert _rel(global_norm(list(grads.values())),
                global_norm([torch.as_tensor(np.asarray(w))
                             for w in want_grads.values()])) <= 1e-4


@pytest.fixture(scope="module")
def port_weights():
    """Weights drawn by the port (the same tree at every flat_scales)."""
    return build_model(ModelConfig(**CFG), torch.Generator().manual_seed(0)
                       ).state_dict()


def _port(fs, weights, **kw):
    m = build_model(ModelConfig(**CFG, flat_scales=fs, **kw),
                    torch.Generator().manual_seed(0))
    m.load_state_dict(weights)
    return m


def test_flat_scales_grads_match_jax_fs0(port_weights):
    """The port at flat_scales 2 against JAX's flat_scales 0 step."""
    batch = _batch(2)
    want = _jax_value_and_grad(JaxModelConfig(**CFG),
                               torch_to_flax(port_weights), batch)
    got = make_loss_and_grad(_port(2, port_weights))(
        {k: torch.from_numpy(v) for k, v in batch.items()})
    _check(*got, *want)


def test_flat_scales_grads_match_jax_flat_model(port_weights, monkeypatch):
    """The port at flat_scales 2 against JAX's flat model at flat_scales 2,
    whose flat convs, pools, upsamples, couplings and fused res blocks run
    their Pallas backward kernels (it did not fall back to NHWC)."""
    seen = set()
    real = pl.pallas_call

    def spy(kernel, *args, **kwargs):
        fn = getattr(kernel, "func", kernel)
        seen.add(f"{fn.__module__.rsplit('.', 1)[-1]}.{fn.__name__}")
        return real(kernel, *args, **kwargs)

    monkeypatch.setattr(pl, "pallas_call", spy)
    batch = _batch(1, seed=3)
    want = _jax_value_and_grad(JaxModelConfig(**CFG, flat_scales=2),
                               torch_to_flax(port_weights), batch)
    assert {"flatconv._epi_bwd_kernel", "flatconv._dw_kernel",
            "flatconv._cc_bwd_kernel", "flatconv._mp_bwd_kernel",
            "flatconv._ups_bwd_kernel", "flatres._bwd_kernel"} <= seen
    got = make_loss_and_grad(_port(2, port_weights))(
        {k: torch.from_numpy(v) for k, v in batch.items()})
    _check(*got, *want)


def test_trainer_step_at_flat_scales_matches_fs0():
    """One Trainer step (Adam, clip) at flat_scales 2 and at 0 from the
    same state: metrics and updated parameters."""
    tcfg = TrainConfig(learning_rate=1e-4, lr_decay_staircase=False, seed=5)
    batch = _batch(2, seed=1)
    out = {}
    for fs in (0, 2):
        tr = Trainer(ModelConfig(**CFG, flat_scales=fs), tcfg, device="cpu")
        tr.init_state(batch["input"])
        state, metrics = tr.train_step(tr.state, tr.put_batch(batch))
        out[fs] = (metrics, {k: v.detach().clone()
                             for k, v in state.params.items()},
                   tr.eval_step(state.params, tr.put_batch(batch)))
    (m0, p0, e0), (m2, p2, e2) = out[0], out[2]
    for k in ("loss", "accuracy"):
        assert _rel(m2[k], m0[k]) <= 1e-5, k
        assert _rel(e2[k], e0[k]) <= 1e-5, k
    assert _rel(m2["grad_norm"], m0["grad_norm"]) <= 1e-4
    for name, p in p0.items():
        torch.testing.assert_close(p2[name], p, rtol=1e-6, atol=1e-6,
                                   msg=name)


def test_remat_at_flat_scales_gives_the_same_gradients(port_weights):
    """remat re-runs each stage's flat ops in the backward: the same
    gradients, bit for bit."""
    batch = {k: torch.from_numpy(v) for k, v in _batch(1, seed=2).items()}
    l0, _, g0 = make_loss_and_grad(_port(2, port_weights))(batch)
    l1, _, g1 = make_loss_and_grad(_port(2, port_weights, remat=True))(batch)
    assert torch.equal(l0, l1)
    for name in g0:
        assert torch.equal(g0[name], g1[name]), name


def test_feat_root_16_at_flat_scales_3_serves_and_trains():
    """feat_root 16 at flat_scales 3 reaches 64 channels with an LRN at
    scale 2: the forward matches the JAX flat model (Pallas kernels in
    interpret mode), and the gradients match the port's flat_scales 0."""
    # one stage: with a second one the random feat_root-16 model's
    # gradients move by more than the bound under f32-level noise alone
    # one stage: in f32 the two-stage model's gradients, at flat_scales 0
    # and 3 alike, lie up to ~350x this bound from the exact (float64)
    # ones, so two f32 runs differ by noise alone;
    # test_float64_flat_step_equals_fs0 holds the two-stage model exactly
    cfg = dict(CFG, scale_space_num=4, feat_root=16, flat_scales=3,
               num_blocks=1)
    flat = build_model(ModelConfig(**cfg), torch.Generator().manual_seed(4))
    assert flat.net.block_0.down.dil_conv_2.Conv_0.weight.shape[0] == 64
    x = np.random.default_rng(4).normal(size=(1, 64, 64, 6)).astype(np.float32)
    jp, jl, ja = jax_build_model(JaxModelConfig(**cfg)).apply(
        torch_to_flax(flat.state_dict()), jnp.asarray(x))
    with torch.no_grad():
        tp, tl, ta = flat.eval()(torch.from_numpy(x))
    for got, want in ((tl, jl), (ta, ja), (tp, jp)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=max(1e-4, 1e-5 * np.abs(want).max()))
    plain = build_model(dataclasses.replace(ModelConfig(**cfg), flat_scales=0),
                        torch.Generator().manual_seed(0))
    plain.load_state_dict(flat.state_dict())
    batch = {k: torch.from_numpy(v) for k, v in _batch(1, seed=5).items()}
    l3, m3, g3 = make_loss_and_grad(flat.train())(batch)
    l0, m0, g0 = make_loss_and_grad(plain)(batch)
    _check(l3, m3, g3, l0, m0, {k: v.numpy() for k, v in g0.items()})


@pytest.mark.parametrize("cfg", [
    dict(CFG, flat_scales=2),
    dict(CFG, scale_space_num=4, feat_root=16, flat_scales=3)],
    ids=["feat_root_4_fs2", "feat_root_16_fs3"])
def test_float64_flat_step_equals_fs0(cfg):
    """In float64 the plain versions round nothing to f32: the two-stage
    step at flat_scales > 0 computes the fs=0 step's function, its loss,
    metrics and every gradient equal to fs=0's up to float64 sums in
    another order (1e-9 of each tensor's largest |gradient|, where f32
    runs of these models lie up to ~350x 1e-4 from them)."""
    batch = {k: torch.from_numpy(v) for k, v in _batch(1, seed=5).items()}
    batch["input"] = batch["input"].double()
    out = []
    for fs in (cfg["flat_scales"], 0):
        m = build_model(ModelConfig(**dict(cfg, flat_scales=fs),
                                    dtype="float64"),
                        torch.Generator().manual_seed(4)).double()
        out.append(make_loss_and_grad(m)(batch))
    (l_f, m_f, g_f), (l_0, m_0, g_0) = out
    assert l_f.dtype == torch.float64 and _rel(l_f, l_0) <= 1e-12
    for k in ("loss", "loss_final", "loss_aux", "accuracy"):
        assert _rel(m_f[k], m_0[k]) <= 1e-12, k
    scale = max(float(v.abs().max()) for v in g_0.values())
    for name, want in g_0.items():
        assert g_f[name].dtype == torch.float64
        torch.testing.assert_close(
            g_f[name], want, rtol=0,
            atol=1e-9 * float(want.abs().max()) + 1e-12 * scale, msg=name)
