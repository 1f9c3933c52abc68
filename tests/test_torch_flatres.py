"""Fused residual block: the port's plain version (msau_tpu_torch.ops.flatres,
NCHW) against the JAX package's Pallas kernel in interpret mode, through
both of its bodies (``_fwd_kernel_al`` on a lane-aligned geometry,
``_fwd_kernel`` otherwise), and the port's flat res-block module against its
unfused composition.  A spy on ``pl.pallas_call`` asserts which kernel ran.

Tolerance: f32 on both sides, max abs error within 1e-5 of the output's
scale (summation order of two chained 3x3 convs).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from msau_tpu.ops import flatconv as jfc
from msau_tpu.ops.flatres import flat_res_block as jax_res_block
from msau_tpu_torch.models.layers import MultiConvResidualBlock
from msau_tpu_torch.ops.flatres import flat_res_block, flat_res_block_plain

REL = 1e-5


@pytest.fixture
def kernels_run(monkeypatch):
    seen = []
    real = pl.pallas_call

    def spy(kernel, *args, **kwargs):
        seen.append(getattr(kernel, "func", kernel).__name__)
        return real(kernel, *args, **kwargs)

    monkeypatch.setattr(pl, "pallas_call", spy)
    return seen


def _inputs(seed, c, h, w):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(2, c, h, w)).astype(np.float32)
    w1, w2 = ((rng.normal(size=(3, 3, c, c)) * 0.3).astype(np.float32)
              for _ in range(2))
    b1, b2 = ((rng.normal(size=(c,)) * 0.1).astype(np.float32)
              for _ in range(2))
    return x, w1, b1, w2, b2


def _oihw(w):
    return torch.from_numpy(np.ascontiguousarray(w.transpose(3, 2, 0, 1)))


# (geometry, kernel body): 64x248 with P 4 has Wp 256 (the lane-aligned
# body); 64x96 takes the classic body
GEOMS = {"aligned": (jfc.FlatGeom(64, 248, 4, 8), "_fwd_kernel_al"),
         "classic": (jfc.choose_geom(64, 96), "_fwd_kernel")}


@pytest.mark.parametrize("layout", sorted(GEOMS))
@pytest.mark.parametrize("c,act", [
    pytest.param(8, "relu", id="relu"), pytest.param(8, "elu", id="elu"),
    pytest.param(4, "relu", id="4-relu"), pytest.param(32, "elu", id="32-elu")])
def test_res_block_matches_pallas(kernels_run, layout, c, act):
    """Every channel count the kernels take (ops/flatres.FUSED_CHANNELS)."""
    geom, body = GEOMS[layout]
    x, w1, b1, w2, b2 = _inputs(len(layout) + len(act), c, geom.H, geom.W)
    want = jax_res_block(jfc.to_body(jnp.asarray(x), geom),
                         *map(jnp.asarray, (w1, b1, w2, b2)), geom, act)
    assert kernels_run == [body]
    want = np.asarray(jfc.from_body(want, geom))
    got = flat_res_block(torch.from_numpy(x), _oihw(w1), torch.from_numpy(b1),
                         _oihw(w2), torch.from_numpy(b2), act)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=REL * max(1.0, np.abs(want).max()))


@pytest.mark.parametrize("c,h,w", [(8, 20, 24), (16, 7, 5), (4, 33, 65)])
def test_module_fused_matches_unfused_composition(c, h, w):
    """The flat module's one fused op against relu -> conv(act) -> conv
    -> +x -> act as layers, on a tile that touches every image edge (conv1
    is zero outside the image, not act(b1))."""
    gen = torch.Generator().manual_seed(c)
    fused = MultiConvResidualBlock(c, 2, 3, "elu", gen=gen, flat=True)
    plain = MultiConvResidualBlock(c, 2, 3, "elu",
                                   gen=torch.Generator().manual_seed(0))
    plain.load_state_dict(fused.state_dict())
    assert fused.fused and not plain.fused
    x = torch.from_numpy(np.random.default_rng(c).normal(
        size=(2, c, h, w)).astype(np.float32))
    with torch.no_grad():
        torch.testing.assert_close(fused(x), plain(x), rtol=0, atol=1e-5)


def test_other_depths_run_as_flat_convs():
    """res_depth 3 has no fused kernel: the module runs one flat conv per
    layer, with the relu, residual add and act as torch ops."""
    gen = torch.Generator().manual_seed(3)
    flat = MultiConvResidualBlock(8, 3, 3, "relu", gen=gen, flat=True)
    plain = MultiConvResidualBlock(8, 3, 3, "relu",
                                   gen=torch.Generator().manual_seed(0))
    plain.load_state_dict(flat.state_dict())
    assert not flat.fused and flat.ConvBnLrnDrop_0.flat
    x = torch.randn(1, 8, 9, 11, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        torch.testing.assert_close(flat(x), plain(x), rtol=0, atol=1e-5)


def test_bf16_rounds_conv1_output():
    """bf16: conv1's output is rounded to bf16 before conv2 reads it, as in
    the TPU kernel's x.dtype scratch; everything else is f32."""
    x, w1, b1, w2, b2 = _inputs(9, 8, 10, 12)
    xb = torch.from_numpy(x).bfloat16()
    args = (_oihw(w1), torch.from_numpy(b1), _oihw(w2), torch.from_numpy(b2))
    got = flat_res_block_plain(xb, *args, "relu")
    assert got.dtype == torch.bfloat16
    f = torch.nn.functional
    w1b, w2b = (t.bfloat16().float() for t in (args[0], args[2]))
    h1 = f.relu(f.conv2d(f.relu(xb.float()), w1b, args[1], padding=1))
    y = f.conv2d(h1.bfloat16().float(), w2b, args[3], padding=1) + xb.float()
    assert torch.equal(got, f.relu(y).bfloat16())
