"""The plain reference against the port's step, and the benchmark's
operation count against torch's flop counter, on the CPU at small sizes."""

import dataclasses
import json

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import counts, generator, weights
from benchmark.reference import msau as ref
from conftest import ROOT

CONFIGS = ("msau_funsd", "msau_default")


def _config(name):
    return json.loads((ROOT / "benchmark" / "configs" / f"{name}.json").read_text())


def _inputs(model, seed, n=2, hw=64):
    traffic = {"batch": n, "height": hw, "width": hw, "rects": 6,
               "noise": 0.1, "pool": 2}
    gen = torch.Generator().manual_seed(seed)
    params = weights.make_params(ref.param_shapes(model), gen)
    return params, generator.structured_batches(traffic, model, seed, gen)


@pytest.mark.parametrize("name", CONFIGS)
def test_reference_matches_the_port_step_in_float64(name):
    """One training step, float64 on both sides (the port's plain versions
    take float64 on the CPU): the loss, every gradient and every updated
    parameter agree to rounding."""
    from msau_tpu_torch.config import ModelConfig, TrainConfig
    from msau_tpu_torch.models.msau import build_model
    from msau_tpu_torch.train.optimizer import make_optimizer
    from msau_tpu_torch.train.trainer import TrainState, make_train_step

    config = _config(name)
    model = config["model"]
    params, batches = _inputs(model, 5)
    mc = dataclasses.replace(ModelConfig.from_model_kwargs(model),
                             use_lrn=model["use_lrn"],
                             **dict(config["program"], dtype="float64"))
    net = build_model(mc, torch.Generator().manual_seed(0)).double()
    with torch.no_grad():
        for k, p in net.named_parameters():
            p.copy_(params[k])
    t = config["train"]
    opt = make_optimizer(TrainConfig(learning_rate=t["learning_rate"],
                                     lr_decay_staircase=False,
                                     grad_clip_norm=t["grad_clip_norm"]))
    state = TrainState.create(net, opt)
    batch = {"input": batches[0]["input"].double(),
             "label": batches[0]["label"]}
    step = make_train_step(net, opt, masked=True)
    state, metrics = step(state, batch)

    names = list(params)
    p64 = [params[k].double().requires_grad_(True) for k in names]
    loss = ref.loss_fn(dict(zip(names, p64)), model, batch)
    grads = ref.Adam(t["learning_rate"], t["grad_clip_norm"]).clip(
        list(torch.autograd.grad(loss, p64, materialize_grads=True)))
    assert float(metrics["loss"]) == pytest.approx(float(loss.detach()),
                                                   rel=1e-12)
    med = float(np.median([float(g.norm()) for g in grads]))
    for k, g in zip(names, grads):
        got = state.opt_state["mu"][k] / (1 - ref.ADAM_B1)
        assert float((got - g).norm()) <= 1e-9 * max(float(g.norm()), med), k
    adam = ref.Adam(t["learning_rate"], t["grad_clip_norm"])
    adam.update(p64, grads)
    for k, q in zip(names, p64):
        assert torch.allclose(state.params[k].detach(), q.detach(),
                              rtol=0, atol=1e-12), k


@pytest.mark.parametrize("name", CONFIGS)
@pytest.mark.parametrize("n,hw", [(1, 64), (2, 48)])
def test_operation_count_matches_the_flop_counter(name, n, hw):
    model = _config(name)["model"]
    params, batches = _inputs(model, 1, n=n, hw=hw)
    want = counts.msau_flops(model, n, hw, hw)
    p = {k: v.requires_grad_(True) for k, v in params.items()}
    with FlopCounterMode(display=False) as fwd:
        loss = ref.loss_fn(p, model, batches[0])
    with FlopCounterMode(display=False) as bwd:
        torch.autograd.grad(loss, list(p.values()), allow_unused=True)
    assert fwd.get_total_flops() == want["forward"]
    assert fwd.get_total_flops() + bwd.get_total_flops() == want["train"]


def test_attention_blocks_give_the_whole_softmax():
    """The reference's row blocks of the scores (held to
    SCORE_BLOCK_ELEMENTS) sum to the one-block attention."""
    gen = torch.Generator().manual_seed(3)
    x = torch.randn(2, 16, 8, 8, generator=gen, dtype=torch.float64)
    p = {f"a.{n}.weight": torch.randn(c, 16, 1, 1, generator=gen,
                                      dtype=torch.float64)
         for n, c in (("f", 2), ("g", 2), ("h", 16))}
    p.update({f"a.{n}.bias": torch.zeros(c, dtype=torch.float64)
              for n, c in (("f", 2), ("g", 2), ("h", 16))})
    whole = ref.attention(ref.Arith(), p, "a.", x)
    old = ref.SCORE_BLOCK_ELEMENTS
    try:
        ref.SCORE_BLOCK_ELEMENTS = 2 * 64 * 5   # rows of 5, 5, ... 4
        blocked = ref.attention(ref.Arith(), p, "a.", x)
    finally:
        ref.SCORE_BLOCK_ELEMENTS = old
    assert torch.allclose(whole, blocked, rtol=0, atol=1e-12)


def test_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2.0 ** -11, 1.0 + 3 * 2.0 ** -11,
                      1.0 + 2.0 ** -10, -(1.0 + 3 * 2.0 ** -11), 3.0e-3])
    got = ref.tf32_round(x)
    # ties go to even; 10 mantissa bits kept
    assert got[:5].tolist() == [1.0, 1.0, 1.0 + 2.0 ** -9, 1.0 + 2.0 ** -10,
                                -(1.0 + 2.0 ** -9)]
    assert abs(float(got[5]) - 3.0e-3) <= 3.0e-3 * 2.0 ** -11
