"""Train-step parity: the port's losses, optimizer chain, schedule and
gradients against the JAX package on the CPU, and the trainer's loop and
checkpoints.

Tolerances (f32 on both sides):
  * losses and metrics rel 1e-5 (sums over a few thousand pixels in another
    order); loss gradients w.r.t. logits atol 1e-7 (values ~1/pixels);
  * optimizer: parameters after each of 3 updates rtol 1e-6, atol 1e-7,
    1e-5 of one lr-1e-2 step (elementwise f32 formulas; the global norm
    sums in another order, and the clip scales by max/norm in one product);
  * model: loss and metrics rel 1e-5, grad_norm rel 1e-4, and each
    parameter's gradient within 1e-4 of that tensor's largest |gradient|
    (~40 conv backward passes of two frameworks' CPU kernels) plus 1e-6 of
    the largest |gradient| of the model: the attention's f-projection bias
    shifts a softmax row by a constant, so its exact gradient is 0 and both
    sides carry f32 noise there;
  * remat and checkpoint resume: exact (the same CPU ops in the same order).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from msau_tpu.config import ModelConfig, TrainConfig
from msau_tpu.models.msau import build_model as jax_build_model
from msau_tpu.train import loss as jloss
from msau_tpu.train.optimizer import make_optimizer as jax_make_optimizer
from msau_tpu.train.optimizer import staircase_schedule as jax_staircase
from msau_tpu.train.trainer import TrainState as JaxTrainState
from msau_tpu.train.trainer import make_train_step as jax_make_train_step
from msau_tpu_torch.data.synth import make_structured_batch
from msau_tpu_torch.models.msau import build_model
from msau_tpu_torch.train import loss as tloss
from msau_tpu_torch.train.optimizer import make_optimizer, staircase_schedule
from msau_tpu_torch.train.trainer import (
    Trainer,
    TrainState,
    make_eval_step,
    make_loss_and_grad,
    make_train_step,
)
from msau_tpu_torch.utils.transplant import flax_to_torch

CFG = dict(img_channels=6, n_class=5, scale_space_num=3, res_depth=2,
           feat_root=4, num_blocks=2, final_act="softmax")


def _rel(a, b):
    a = a.detach() if isinstance(a, torch.Tensor) else a
    return abs(float(a) - float(b)) / max(abs(float(b)), 1e-12)


def _loss_inputs(seed=0, n=2, h=12, w=10, c=5):
    rng = np.random.default_rng(seed)
    logits = (rng.normal(size=(n, h, w, c)) * 2).astype(np.float32)
    aux = (rng.normal(size=(n, h, w, c)) * 2).astype(np.float32)
    labels = rng.integers(0, c, (n, h, w)).astype(np.int32)
    valid = np.ones((n, h, w), bool)
    valid[:, -2:, :] = False
    return logits, aux, labels, valid


# ---------------------------------------------------------------- losses
@pytest.mark.parametrize("layout", ["NHWC", "channel_major"])
def test_masked_cross_entropy_matches_jax(layout):
    """NHWC runs the torch-op branch against JAX's XLA branch; channel-major
    [N, C, L] runs the fused op against JAX's fused Pallas branch."""
    logits, aux, labels, valid = _loss_inputs()
    if layout == "NHWC":
        axis, prep = -1, (lambda a: a)
        lab_prep = prep
    else:
        n, c = logits.shape[0], logits.shape[-1]
        axis = 1
        prep = lambda a: np.ascontiguousarray(
            a.transpose(0, 3, 1, 2).reshape(n, c, -1))
        lab_prep = lambda a: a.reshape(n, -1)

    def jfn(l, a):
        return jloss.masked_cross_entropy(l, a, jnp.asarray(lab_prep(labels)),
                                          jnp.asarray(lab_prep(valid)),
                                          channel_axis=axis)

    (jl, jm), jg = jax.value_and_grad(jfn, argnums=(0, 1), has_aux=True)(
        jnp.asarray(prep(logits)), jnp.asarray(prep(aux)))
    tl_, ta = (torch.from_numpy(prep(a)).requires_grad_() for a in (logits, aux))
    loss, tm = tloss.masked_cross_entropy(
        tl_, ta, torch.from_numpy(lab_prep(labels)),
        torch.from_numpy(lab_prep(valid)), channel_axis=axis)
    loss.backward()
    for k in ("loss", "loss_final", "loss_aux", "accuracy"):
        assert _rel(tm[k], jm[k]) <= 1e-5, k
    for got, want in zip((tl_.grad, ta.grad), jg):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-7)


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("with_valid", [False, True])
def test_unet_loss_matches_jax(weighted, with_valid):
    logits, aux, labels, valid = _loss_inputs(seed=1)
    cw = np.linspace(0.5, 2.0, 5).astype(np.float32) if weighted else None
    v = valid if with_valid else None
    kw = dict(aux_weight=0.3)
    jl, jm = jloss.unet_loss(
        jnp.asarray(logits), jnp.asarray(labels), aux_logits=jnp.asarray(aux),
        valid=None if v is None else jnp.asarray(v),
        class_weights=None if cw is None else jnp.asarray(cw), **kw)
    tl_, tm = tloss.unet_loss(
        torch.from_numpy(logits), torch.from_numpy(labels),
        aux_logits=torch.from_numpy(aux),
        valid=None if v is None else torch.from_numpy(v),
        class_weights=None if cw is None else torch.from_numpy(cw), **kw)
    for k in ("loss", "loss_final", "loss_aux", "accuracy"):
        assert _rel(tm[k], jm[k]) <= 1e-5, k


def test_per_pixel_ce_clamps_labels_like_jax():
    logits, _, _, _ = _loss_inputs(seed=2)
    labels = np.random.default_rng(2).integers(-3, 9, logits.shape[:3]).astype(np.int32)
    want = np.asarray(jloss._per_pixel_ce(jnp.asarray(logits), jnp.asarray(labels)))
    got = tloss._per_pixel_ce(torch.from_numpy(logits), torch.from_numpy(labels))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


# ------------------------------------------------------------- optimizer
@pytest.mark.parametrize("name", ["adam", "rmsprop", "momentum"])
def test_optimizer_chain_matches_optax(name):
    """Clip (active on the first step, not after), weight decay and a
    staircase that drops inside the three steps."""
    cfg = TrainConfig(optimizer=name, learning_rate=1e-2, weight_decay=1e-2,
                      grad_clip_norm=1.0, lr_decay_staircase=True,
                      lr_decay_every_epochs=1, lr_decay_rate=0.5)
    rng = np.random.default_rng(0)
    shapes = {"a": (3, 4), "b": (5,), "c": (2, 2, 3)}
    params = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: (rng.normal(size=s) * sc).astype(np.float32)
              for k, s in shapes.items()} for sc in (2.0, 0.05, 0.1)]
    jopt = jax_make_optimizer(cfg, steps_per_epoch=2)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jst = jopt.init(jp)
    topt = make_optimizer(cfg, steps_per_epoch=2)
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    tst = topt.init(tp)
    for g in grads:
        upd, jst = jopt.update({k: jnp.asarray(v) for k, v in g.items()}, jst, jp)
        jp = optax.apply_updates(jp, upd)
        norm = topt.update({k: torch.from_numpy(v.copy()) for k, v in g.items()},
                           tst, tp)
        want_norm = float(optax.global_norm({k: jnp.asarray(v) for k, v in g.items()}))
        assert _rel(norm, want_norm) <= 1e-6
        for k in shapes:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                       rtol=1e-6, atol=1e-7, err_msg=k)
    assert tst["count"] == 3


def test_staircase_schedule_boundaries():
    spe, every = 7, 3
    ours = staircase_schedule(0.1, 0.9, every, spe)
    ref = jax_staircase(0.1, 0.9, every, spe)
    for step in (0, spe * every - 1, spe * every, 2 * spe * every - 1,
                 2 * spe * every, 10 * spe * every + 5):
        assert ours(step) == pytest.approx(float(ref(step)), rel=1e-6)
    assert ours(spe * every - 1) == 0.1
    assert ours(spe * every) == pytest.approx(0.09)
    assert ours(2 * spe * every) == pytest.approx(0.081)


# ------------------------------------------------- model loss + gradients
@pytest.fixture(scope="module")
def jax_and_port():
    cfg = ModelConfig(**CFG)
    x, y = make_structured_batch(np.random.default_rng(0), 2, 48,
                                 cfg.n_class, cfg.img_channels, n_rects=6)
    valid = np.ones(y.shape, bool)
    valid[:, :, -5:] = False
    jm = jax_build_model(cfg)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(x[:1]))
    tm = build_model(cfg, torch.Generator().manual_seed(0))
    tm.load_state_dict(flax_to_torch(jax.tree_util.tree_map(np.asarray, params)))
    return cfg, jm, params, tm, {"input": x, "label": y, "valid": valid}


def test_train_step_grads_match_jax(jax_and_port):
    """Loss, metrics and every parameter gradient of the port's step (fused
    CE on NCHW logits, the autograd attention op) against JAX's
    flat_scales=0 step (NHWC logits, XLA CE)."""
    cfg, jm, params, tm, batch = jax_and_port
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def jax_loss(p):
        _, logits, aux = jm.apply(p, jb["input"], train=True)
        return jloss.masked_cross_entropy(logits, aux, jb["label"], jb["valid"])

    (_, jmet), jgrads = jax.value_and_grad(jax_loss, has_aux=True)(params)
    jopt = optax.adam(1e-4)
    _, jstep_metrics = jax_make_train_step(jm, jopt, donate=False)(
        JaxTrainState.create(params, jopt), jb)

    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    _, tmet, tgrads = make_loss_and_grad(tm)(tb)
    for k in ("loss", "loss_final", "loss_aux", "accuracy"):
        assert _rel(tmet[k], jmet[k]) <= 1e-5, k
        assert _rel(tmet[k], jstep_metrics[k]) <= 1e-5, k
    want = flax_to_torch(jax.tree_util.tree_map(np.asarray, jgrads))
    assert set(want) == set(tgrads)
    scale = max(float(w.abs().max()) for w in want.values())
    for name, g in tgrads.items():
        w = want[name].numpy()
        assert g.dtype == torch.float32
        np.testing.assert_allclose(
            g.numpy(), w, rtol=0, atol=1e-4 * np.abs(w).max() + 1e-6 * scale,
            err_msg=name)

    topt = make_optimizer(TrainConfig(lr_decay_staircase=False))
    tstate = TrainState.create(tm, topt)
    before = {k: v.detach().clone() for k, v in tstate.params.items()}
    tstate, smet = make_train_step(tm, topt)(tstate, tb)
    assert _rel(smet["grad_norm"], jstep_metrics["grad_norm"]) <= 1e-4
    assert tstate.step == 1 and tstate.opt_state["count"] == 1
    moved = [k for k in before if not torch.equal(before[k], tstate.params[k])]
    assert moved and tstate.params[moved[0]] is dict(tm.named_parameters())[moved[0]]
    tm.load_state_dict(before)


def test_remat_gives_the_same_gradients(jax_and_port):
    """remat recomputes each stage in the backward: the same gradients,
    and the forward keeps far fewer activations."""
    cfg, _, _, tm, batch = jax_and_port
    tr = build_model(dataclasses.replace(cfg, remat=True),
                     torch.Generator().manual_seed(0))
    tr.load_state_dict(tm.state_dict())
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    saved = {}

    def run(model, key):
        sizes = []

        def pack(t):
            sizes.append(t.numel() * t.element_size())
            return t

        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            out = make_loss_and_grad(model)(tb)
        saved[key] = sum(sizes)
        return out

    l0, m0, g0 = run(tm, "plain")
    l1, m1, g1 = run(tr, "remat")
    assert torch.equal(l0, l1)
    for name in g0:
        assert torch.equal(g0[name], g1[name]), name
    assert saved["remat"] < 0.5 * saved["plain"]


# ------------------------------------------------------------- trainer
class _Provider:
    """Deterministic batches by call index; ``start`` skips ahead."""

    def __init__(self, cfg, start=0, hw=16, bs=2):
        self.cfg, self.i, self.hw, self.bs = cfg, start, hw, bs
        self.size_val = 1

    def _batch(self, seed):
        x, y = make_structured_batch(np.random.default_rng(seed), self.bs,
                                     self.hw, self.cfg.n_class,
                                     self.cfg.img_channels, n_rects=3)
        return {"input": x, "label": y, "valid": np.ones(y.shape, bool)}

    def next_data(self, split):
        if split == "val":
            return self._batch(1000)
        self.i += 1
        return self._batch(self.i - 1)


def test_fit_checkpoint_resume_is_exact(tmp_path):
    """2 epochs straight == 1 epoch, checkpoint, restore into a fresh
    trainer, 1 more epoch: parameters, optimizer state and step equal."""
    mcfg = ModelConfig(**CFG)
    tcfg = TrainConfig(learning_rate=1e-3, lr_decay_staircase=True,
                       lr_decay_every_epochs=1, batch_steps_per_epoch=2,
                       checkpoint_every_epochs=1, seed=3)
    logs = []
    a = Trainer(mcfg, tcfg, device="cpu")
    a.init_state(np.zeros((1, 16, 16, 6), np.float32))
    hist = a.fit(_Provider(mcfg), output_path=str(tmp_path), epochs=2,
                 log_fn=logs.append)
    assert len(hist["train_loss"]) == len(hist["val_loss"]) == 2
    assert all(np.isfinite(hist["train_loss"]))
    assert (tmp_path / "model1" / "train_state.pt").exists()
    assert any(s.startswith("VAL") for s in logs)

    b = Trainer(mcfg, tcfg, device="cpu")
    b.init_state(np.zeros((1, 16, 16, 6), np.float32), seed=99)
    b.fit(_Provider(mcfg, start=2), epochs=1,
          restore_path=str(tmp_path / "model1"), log_fn=logs.append)
    assert b.state.step == a.state.step == 4
    assert b.state.opt_state["count"] == a.state.opt_state["count"] == 4
    for k, v in a.state.params.items():
        assert torch.equal(v, b.state.params[k]), k
    for buf in ("mu", "nu"):
        for k, v in a.state.opt_state[buf].items():
            assert torch.equal(v, b.state.opt_state[buf][k]), (buf, k)


def test_trainer_rejects_a_mesh():
    """A flat model on a mesh whose spatial axis differs from its
    spatial_shards is refused with the JAX trainer's message, as
    tests/test_parallel.py refuses it on the (2, 4) mesh; the mesh is only
    read for its axes here (the multi-rank steps: test_torch_parallel)."""

    class Mesh24:
        mesh_dim_names = ("data", "spatial")

        def size(self, i):
            return (2, 4)[i]

    flat = ModelConfig(**{**CFG, "flat_scales": 2})
    with pytest.raises(ValueError, match="spatial_shards == mesh spatial "
                                         r"size \(4\); got 1"):
        Trainer(flat, mesh=Mesh24(), device="cpu")


@pytest.mark.parametrize("entry", ["make_loss_and_grad", "make_train_step",
                                   "make_eval_step"])
def test_flat_scales_train_entry_points_run(entry):
    """make_loss_and_grad, make_train_step and make_eval_step at
    flat_scales > 0 (their parity with JAX and with flat_scales 0 is in
    tests/test_torch_flat_train.py): finite loss, an f32 gradient for every
    parameter the loss reaches."""
    model = build_model(ModelConfig(**CFG, flat_scales=1),
                        torch.Generator().manual_seed(0))
    x, y = make_structured_batch(np.random.default_rng(4), 2, 24, 5, 6)
    batch = {"input": torch.from_numpy(x), "label": torch.from_numpy(y)}
    if entry == "make_loss_and_grad":
        loss, metrics, grads = make_loss_and_grad(model)(batch)
        assert torch.isfinite(loss) and set(metrics) >= {"loss", "accuracy"}
        assert all(g.dtype == torch.float32 and torch.isfinite(g).all()
                   for g in grads.values())
        assert float(grads["net.block_0.down.dil_conv_0.Conv_0.weight"]
                     .abs().max()) > 0
    elif entry == "make_train_step":
        opt = make_optimizer(TrainConfig(lr_decay_staircase=False))
        state, metrics = make_train_step(model, opt)(
            TrainState.create(model, opt), batch)
        assert state.step == 1 and torch.isfinite(metrics["grad_norm"])
    else:
        metrics = make_eval_step(model)(dict(model.named_parameters()), batch)
        assert torch.isfinite(metrics["loss"])
