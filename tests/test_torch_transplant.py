"""flax <-> torch weight bridge: round trips in both directions are exact,
and the deconv layout matches the reference's own transplant rule
(msau_tpu.utils.transplant, torch ConvTranspose2d -> flipped HWIO)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msau_tpu.config import ModelConfig
from msau_tpu.models.msau import build_model as jax_build_model
from msau_tpu.utils.transplant import _deconv_kernel
from msau_tpu_torch.models.msau import build_model
from msau_tpu_torch.utils.transplant import flax_to_torch, torch_to_flax

CFG = ModelConfig(img_channels=5, n_class=4, scale_space_num=3, res_depth=2,
                  feat_root=4, num_blocks=2)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + k + "/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def test_flax_torch_flax_round_trip():
    params = jax_build_model(CFG).init(jax.random.PRNGKey(0),
                                       jnp.zeros((1, 32, 32, 5)))
    params = jax.tree_util.tree_map(np.asarray, jax.device_get(params))
    back = torch_to_flax(flax_to_torch(params))
    a, b = _flat(params), _flat(back)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_torch_flax_torch_round_trip_loads_strictly():
    tm = build_model(CFG, torch.Generator().manual_seed(3))
    sd = tm.state_dict()
    back = flax_to_torch(torch_to_flax(sd))
    assert sd.keys() == back.keys()
    for k in sd:
        assert torch.equal(sd[k], back[k]), k
    build_model(CFG, torch.Generator().manual_seed(4)).load_state_dict(back)


def test_deconv_layout_matches_reference_rule():
    w = np.random.default_rng(0).normal(size=(8, 4, 3, 3)).astype(np.float32)
    tree = torch_to_flax({"net.block_0.up.deconv_0.weight": torch.from_numpy(w)})
    kernel = tree["params"]["net"]["block_0"]["up"]["deconv_0"]["kernel"]
    np.testing.assert_array_equal(kernel, _deconv_kernel(w))


VARIANTS = {
    "msau_box": dict(model="msau_box", num_box_convs=2, num_box_per_channel=2,
                     max_box_size=5),
    "lstm_spn": dict(use_lstm=True, use_spn=True),
}


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_variant_round_trips_are_exact(variant):
    """The box convolutions' ybox / xbox and the LSTM cells' dense kernels
    and biases: flax -> torch -> flax and torch -> flax -> torch bit for
    bit, and the bridged tree loads strictly into the port's model."""
    from msau_tpu_torch.config import ModelConfig as TorchModelConfig

    kw = dict(img_channels=5, n_class=4, scale_space_num=3, res_depth=2,
              feat_root=4, num_blocks=2, **VARIANTS[variant])
    params = jax_build_model(ModelConfig(**kw)).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 24, 24, 5)))
    params = jax.tree_util.tree_map(np.asarray, jax.device_get(params))
    sd = flax_to_torch(params)
    leaves = {k.rsplit(".", 1)[-1] for k in sd}
    assert leaves == ({"weight", "bias", "ybox", "xbox"}
                      if variant == "msau_box" else {"weight", "bias"})
    a, b = _flat(params), _flat(torch_to_flax(sd))
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    tm = build_model(TorchModelConfig(**kw), torch.Generator().manual_seed(3))
    tm.load_state_dict(sd)
    mine = tm.state_dict()
    back = flax_to_torch(torch_to_flax(mine))
    assert mine.keys() == back.keys()
    for k in mine:
        assert torch.equal(mine[k], back[k]), k
