"""BatchNorm and dropout in the port's conv layers (``use_bn``,
``keep_prob``) against flax's ``ConvBnLrnDrop`` / ``DilConvBnLrnDrop``.

The BatchNorm is flax's: statistics over N, H and W in f32, the variance
E[x^2] - E[x]^2 clipped at 0, running averages ra = 0.99 ra + 0.01 batch,
eps 1e-5.  Train mode against ``apply(..., train=True,
mutable=["batch_stats"])`` (the output and the new statistics, two
updates in a row), eval mode against ``train=False``, the variables
bridged by ``utils/transplant.py`` both ways; f32, tolerance 1e-5 of the
output's largest |value| (statistics 1e-6).  Dropout's masks come from a
``torch.Generator`` and cannot equal flax's: its kept fraction, its scale
and its identity in eval mode are checked instead, on the port and on
flax.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msau_tpu.models.layers import ConvBnLrnDrop as JaxConv
from msau_tpu.models.layers import DilConvBnLrnDrop as JaxDilConv
from msau_tpu_torch.models.layers import (
    BatchNorm,
    ConvBnLrnDrop,
    DilConvBnLrnDrop,
    dropout,
)
from msau_tpu_torch.utils.transplant import flax_to_torch, torch_to_flax

CASES = {
    # name: (flax layer, port layer factory)
    "conv relu": (JaxConv(features=8, use_bn=True),
                  lambda g: ConvBnLrnDrop(5, 8, use_bn=True, gen=g)),
    "dil conv rate 2, lrn": (
        JaxDilConv(features=8, rate=2, use_bn=True, activation="relu"),
        lambda g: DilConvBnLrnDrop(5, 8, rate=2, use_bn=True,
                                   activation="relu", gen=g)),
}


def _x(seed, shape=(3, 12, 10, 5)):
    return np.random.default_rng(seed).normal(2.0, 1.5, shape).astype(
        np.float32)


def _nchw(x):
    return torch.from_numpy(x).permute(0, 3, 1, 2)


def _close(got, want, rel):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * max(np.abs(want).max(), 1.0))


def _stats(module):
    return torch_to_flax(module.state_dict())["batch_stats"]


@pytest.mark.parametrize("case", sorted(CASES))
def test_batchnorm_matches_flax(case):
    jl, make = CASES[case]
    x0, x1 = _x(0), _x(1)
    variables = jl.init(jax.random.PRNGKey(0), jnp.asarray(x0))
    # move scale and bias off their init so both are exercised
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    params["BatchNorm_0"]["scale"] = np.linspace(0.5, 1.5, 8, dtype=np.float32)
    params["BatchNorm_0"]["bias"] = np.linspace(-1, 1, 8, dtype=np.float32)
    variables = {"params": params,
                 "batch_stats": jax.tree_util.tree_map(
                     np.asarray, variables["batch_stats"])}
    port = make(torch.Generator().manual_seed(0))
    port.load_state_dict(flax_to_torch(variables))
    port.train()
    for x in (x0, x1):   # two updates of the running averages
        want, new = jl.apply(variables, jnp.asarray(x), train=True,
                             mutable=["batch_stats"])
        got = port(_nchw(x)).detach().permute(0, 2, 3, 1).numpy()
        _close(got, want, 1e-5)
        variables = {"params": params, "batch_stats": new["batch_stats"]}
        for k in ("mean", "var"):
            _close(_stats(port)["BatchNorm_0"][k],
                   new["batch_stats"]["BatchNorm_0"][k], 1e-6)
    port.eval()
    want = jl.apply(variables, jnp.asarray(x0), train=False)
    with torch.no_grad():
        got = port(_nchw(x0)).permute(0, 2, 3, 1).numpy()
    _close(got, want, 1e-5)
    # the bridge both ways: the port's variables are flax's
    back = flax_to_torch(torch_to_flax(port.state_dict()))
    assert set(back) == set(port.state_dict())
    for k, v in port.state_dict().items():
        assert torch.equal(back[k], v), k


def test_batchnorm_variance_clipped_and_biased():
    """A constant channel: E[x^2] - E[x]^2 rounds below 0 and is clipped;
    the running variance takes the biased batch variance."""
    bn = BatchNorm(2)
    x = torch.full((4, 2, 3, 3), 0.1)
    x[:, 1] = torch.arange(36.0).reshape(4, 3, 3)
    bn.train()
    y = bn(x)
    assert torch.isfinite(y).all()
    biased = float(x[:, 1].var(unbiased=False))
    np.testing.assert_allclose(float(bn.var[1]), 0.99 + 0.01 * biased,
                               rtol=1e-6)
    assert float(bn.var[0]) == pytest.approx(0.99, abs=1e-7)


def test_flat_layer_refuses_batchnorm():
    with pytest.raises(ValueError, match="BatchNorm"):
        ConvBnLrnDrop(8, 8, use_bn=True, flat=True,
                      gen=torch.Generator().manual_seed(0))


@pytest.mark.parametrize("flat", [False, True])
def test_dropout_keeps_scales_and_is_identity_in_eval(flat):
    """keep_prob 0.75: the kept fraction within 0.01 of 0.75 (0.4M
    draws), kept values scaled by 1/0.75, the rest 0, after the conv, elu
    and LRN (or the flat op, whose epilogue they are); the same generator
    seed gives the same mask; eval mode is the layer without dropout."""
    kw = dict(activation="elu", use_lrn=True, keep_prob=0.75, flat=flat)
    layer = ConvBnLrnDrop(8, 8, gen=torch.Generator().manual_seed(0),
                          dropout_gen=torch.Generator().manual_seed(3), **kw)
    x = torch.randn(8, 8, 64, 96, generator=torch.Generator().manual_seed(1))
    layer.eval()
    with torch.no_grad():
        plain = layer(x)
        layer.train()
        y = layer(x)
    assert plain.abs().min() > 0
    kept = y != 0
    assert abs(float(kept.float().mean()) - 0.75) < 0.01
    torch.testing.assert_close(y[kept], plain[kept] / 0.75, rtol=1e-6,
                               atol=0)
    twin = ConvBnLrnDrop(8, 8, gen=torch.Generator().manual_seed(0),
                         dropout_gen=torch.Generator().manual_seed(3), **kw)
    with torch.no_grad():
        assert torch.equal(twin(x) != 0, kept)
    layer.dropout_gen = None
    with pytest.raises(ValueError, match="generator"):
        layer(x)


def test_dropout_semantics_match_flax():
    """flax's Dropout on the same layer: the same kept fraction and scale
    (its mask comes from its own RNG), and the port's dropout of a
    tensor on the CPU draws the mask the generator gives on its device."""
    jl = JaxConv(features=8, keep_prob=0.75, activation=None)
    x = jnp.asarray(_x(2, (8, 32, 32, 5)))
    variables = jl.init(jax.random.PRNGKey(0), x)
    plain = np.asarray(jl.apply(variables, x, train=False))
    y = np.asarray(jl.apply(variables, x, train=True,
                            rngs={"dropout": jax.random.PRNGKey(1)}))
    kept = y != 0
    assert abs(kept.mean() - 0.75) < 0.01
    np.testing.assert_allclose(y[kept], plain[kept] / 0.75, rtol=1e-6)
    t = torch.ones(1000, 10)
    a = dropout(t, 0.75, torch.Generator().manual_seed(4))
    b = dropout(t, 0.75, torch.Generator().manual_seed(4))
    assert torch.equal(a, b)
    scale = float(np.float32(1) / np.float32(0.75))
    assert set(a.unique().tolist()) == {0.0, scale}
