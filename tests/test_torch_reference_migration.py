"""Migrating checkpoints of the original PyTorch MSAU into the port: the
port's ``torch_state_dict_to_flax`` against the JAX package's on seeded
reference-layout state dicts (``utils/reference_weights.py``), leaf for
leaf; the port's forward with the migrated weights against the JAX model
with JAX's migrated weights (tolerances of tests/test_reference_parity.py:
logits and aux atol / rtol 1e-4, probabilities atol 1e-5 / rtol 1e-4); the
same KeyErrors; ``KVModel.load(params=)`` serving migrated weights as the
JAX KVModel serves them; and, where the reference implementation is
present, the port against ``MSAUWrapper`` itself (skipped otherwise, as the
JAX package's parity test is).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msau_tpu.config import InferConfig as JaxInferConfig
from msau_tpu.config import ModelConfig as JaxModelConfig
from msau_tpu.infer.kv_model import KVModel as JaxKVModel
from msau_tpu.models.msau import build_model as jax_build_model
from msau_tpu.utils import transplant as jax_transplant
from msau_tpu_torch.config import InferConfig, ModelConfig
from msau_tpu_torch.infer.kv_model import KVModel
from msau_tpu_torch.models.msau import build_model
from msau_tpu_torch.utils import transplant
from msau_tpu_torch.utils.reference_weights import (
    reference_key,
    reference_state_dict,
)

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "kv_sample.json")
CHANNELS, N_CLASS, FEAT_ROOT = 8, 5, 8


def _cfg(scale_space_num, res_depth, channels=CHANNELS, n_class=N_CLASS):
    return dict(img_channels=channels, n_class=n_class, feat_root=FEAT_ROOT,
                scale_space_num=scale_space_num, res_depth=res_depth,
                num_blocks=3, final_act="softmax", activation_name="relu")


def _leaves(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


@pytest.mark.parametrize("scale_space_num,res_depth", [(4, 2), (6, 3)])
def test_converter_matches_jax_leaf_for_leaf(scale_space_num, res_depth):
    """(4, 2): FUNSD entry A's hyperparameters; (6, 3): the reference's
    defaults.  Every leaf equal in bits and dtype; the tree is the port's
    init tree and the JAX model's, in structure and shapes."""
    kw = _cfg(scale_space_num, res_depth)
    sd = reference_state_dict(ModelConfig(**kw), seed=scale_space_num)
    ours = transplant.torch_state_dict_to_flax(sd, scale_space_num)
    theirs = jax_transplant.torch_state_dict_to_flax(sd, scale_space_num)
    a, b = _leaves(ours), _leaves(theirs)
    assert a.keys() == b.keys()
    for k in b:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        assert a[k].tobytes() == b[k].tobytes(), k

    port_init = transplant.torch_to_flax(
        build_model(ModelConfig(**kw), torch.Generator().manual_seed(0))
        .state_dict())
    assert {k: v.shape for k, v in _leaves(port_init).items()} == \
        {k: v.shape for k, v in a.items()}
    jax_init = jax_build_model(JaxModelConfig(**kw)).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, CHANNELS)))
    assert jax.tree_util.tree_structure(jax_init) == \
        jax.tree_util.tree_structure(ours)
    assert {k: tuple(v.shape) for k, v in _leaves(jax_init).items()} == \
        {k: v.shape for k, v in a.items()}


@pytest.mark.parametrize("scale_space_num,res_depth,hw", [
    (4, 2, (48, 48)),
    (6, 3, (64, 64)),
    (4, 2, (45, 37)),     # odd sizes: the deconvs crop to the skip shapes
])
def test_migrated_forward_matches_jax(scale_space_num, res_depth, hw):
    kw = _cfg(scale_space_num, res_depth)
    sd = reference_state_dict(ModelConfig(**kw), seed=7)
    model = build_model(ModelConfig(**kw), torch.Generator().manual_seed(1))
    model.load_state_dict(transplant.flax_to_torch(
        transplant.torch_state_dict_to_flax(sd, scale_space_num)))
    model.eval()
    jm = jax_build_model(JaxModelConfig(**kw))
    jparams = jax_transplant.torch_state_dict_to_flax(sd, scale_space_num)
    x = np.random.default_rng(3).standard_normal((1, *hw, CHANNELS),
                                                 np.float32)
    jp, jl, ja = (np.asarray(t) for t in
                  jax.jit(jm.apply)(jparams, jnp.asarray(x)))
    with torch.no_grad():
        tp, tl, ta = (t.numpy() for t in model(torch.from_numpy(x)))
    assert tl.shape == (1, *hw, N_CLASS)
    np.testing.assert_allclose(tl, jl, atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(ta, ja, atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(tp, jp, atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("case", ["unknown key", "unknown block key",
                                  "leftover"])
def test_same_key_errors_as_jax(case):
    sd = reference_state_dict(ModelConfig(**_cfg(4, 2)), seed=0)
    if case == "unknown key":
        sd["msau_net.head.conv.weight"] = np.zeros((2, 2, 1, 1), np.float32)
        sd["msau_net.head.conv.bias"] = np.zeros(2, np.float32)
    elif case == "unknown block key":
        sd["msau_net.blocks.0.sideblock.conv.weight"] = np.zeros(
            (2, 2, 1, 1), np.float32)
        sd["msau_net.blocks.0.sideblock.conv.bias"] = np.zeros(2, np.float32)
    else:     # a buffer of the reference's that no rule converts
        sd["msau_net.blocks.1.downsamplingblock.conv1s.0.bn.running_mean"] = \
            np.zeros(8, np.float32)
    with pytest.raises(KeyError) as ours:
        transplant.torch_state_dict_to_flax(sd, 4)
    with pytest.raises(KeyError) as theirs:
        jax_transplant.torch_state_dict_to_flax(sd, 4)
    assert str(ours.value) == str(theirs.value)
    assert ("unconverted" if case == "leftover" else "unrecognized") in \
        str(ours.value)


def test_reference_keys_invert_the_rules():
    """Every reference key the helper names converts back to the port's
    parameter it came from, and unknown names raise."""
    kw = _cfg(4, 2)
    model = build_model(ModelConfig(**kw), torch.Generator().manual_seed(0))
    sd = {reference_key(n): p.detach().numpy()
          for n, p in model.named_parameters()}
    back = transplant.flax_to_torch(transplant.torch_state_dict_to_flax(sd, 4))
    assert back.keys() == model.state_dict().keys()
    for n, p in model.named_parameters():
        assert torch.equal(back[n], p.detach()), n
    for bad in ("net.block_0.down.lstm.weight", "head.weight",
                "net.end_conv_0.Conv_1.weight"):
        with pytest.raises(KeyError):
            reference_key(bad)


def test_kv_model_serves_migrated_weights_as_jax(tmp_path):
    """torch_state_dict_to_flax, then KVModel.load(params=): the fixture
    page through the port's predict and the JAX predict with JAX's
    migrated weights give the same argmax map, probabilities within 1e-5,
    and the same fields."""
    cs = tmp_path / "charset.txt"
    cs.write_text("".join(sorted(set(
        "Bank NameFirst National Account 0123456789 Alexandra Example Savings"))))
    jkv = JaxKVModel(infer_config=JaxInferConfig(n_class=N_CLASS))
    jkv.load(charset=str(cs), n_class=N_CLASS)
    kw = dict(_cfg(2, 1, channels=jkv.charset.n_token), feat_root=4,
              num_blocks=1)
    sd = reference_state_dict(ModelConfig(**kw), seed=5)
    jkv.model_config = JaxModelConfig(**kw)
    jkv.model = jax_build_model(jkv.model_config)
    jkv.params = jax_transplant.torch_state_dict_to_flax(sd, 2)
    tkv = KVModel(model_config=ModelConfig(**kw),
                  infer_config=InferConfig(n_class=N_CLASS), device="cpu")
    tkv.load(charset=str(cs), n_class=N_CLASS,
             params=transplant.torch_state_dict_to_flax(sd, 2))
    jres, jex = jkv.predict(FIXTURE)
    tres, tex = tkv.predict(FIXTURE)
    jp, tp = np.asarray(jex["pred"]), tex["pred"].numpy()
    np.testing.assert_array_equal(tp.argmax(-1), jp.argmax(-1))
    np.testing.assert_allclose(tp, jp, atol=1e-5)
    assert [tuple(v) for v in tex["values"]] == \
        [tuple(v) for v in jex["values"]]
    assert tres == jres


@pytest.mark.parametrize("scale_space_num,res_depth,hw", [
    (4, 2, (48, 48)),
    (6, 3, (64, 64)),
    (4, 2, (45, 37)),
])
def test_port_matches_reference_wrapper(scale_space_num, res_depth, hw):
    """The reference MSAUWrapper's own state_dict, migrated into the port:
    the port's forward against the reference's."""
    from test_reference_parity import _load_reference_wrapper

    RefWrapper = _load_reference_wrapper()
    torch.manual_seed(42)
    ref = RefWrapper(channels=CHANNELS, n_class=N_CLASS, model_kwargs=dict(
        model="msau", final_act="softmax", featRoot=FEAT_ROOT,
        scale_space_num=scale_space_num, res_depth=res_depth,
        activation_name="relu", filter_size=3, pool_size=2)).eval()
    sd = {k: v.detach().numpy() for k, v in ref.state_dict().items()}
    model = build_model(ModelConfig(**_cfg(scale_space_num, res_depth)),
                        torch.Generator().manual_seed(0)).eval()
    model.load_state_dict(transplant.flax_to_torch(
        transplant.torch_state_dict_to_flax(sd, scale_space_num)))
    x = np.random.default_rng(7).standard_normal((1, *hw, CHANNELS),
                                                 np.float32)
    with torch.no_grad():
        t_probs, t_logits, t_aux = (
            t.numpy().transpose(0, 2, 3, 1)
            for t in ref(torch.from_numpy(x.transpose(0, 3, 1, 2))))
        probs, logits, aux = (t.numpy() for t in model(torch.from_numpy(x)))
    np.testing.assert_allclose(logits, t_logits, atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(aux, t_aux, atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(probs, t_probs, atol=1e-5, rtol=1e-4)
