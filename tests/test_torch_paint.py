"""Paint parity: the port's paint_boxes against the TPU kernel
(paint_boxes_pallas in interpret mode) and the host golden model
paint_boxes_numpy, on random programs and on the edge programs the card
kernel is held to (a later box of value 0, boxes overhanging every edge,
a page-sized box under small ones, one box, none).  Integer grids: exact
equality."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msau_tpu.data.rasterize import BoxProgram as JaxBoxProgram
from msau_tpu.data.rasterize import paint_boxes_numpy as jax_paint_numpy
from msau_tpu.ops.paint_pallas import paint_boxes_pallas
from msau_tpu_torch.data.rasterize import BoxProgram, paint_boxes_numpy
from msau_tpu_torch.ops.paint import paint_boxes, paint_boxes_cuda
from msau_tpu_torch.utils.kernel_inputs import (
    PAINT_EDGE_CASES,
    paint_edge_program,
    paint_program,
)


@pytest.mark.parametrize("h,w,n,pad", [(128, 128, 40, 64), (256, 96, 300, 512),
                                       (128, 64, 0, 8)])
def test_paint_matches_pallas_and_numpy(h, w, n, pad):
    boxes, values = paint_program(np.random.default_rng(h + n), n, h, w, pad)
    want = np.asarray(paint_boxes_pallas(jnp.asarray(boxes),
                                         jnp.asarray(values), h, w,
                                         interpret=True))
    golden = paint_boxes_numpy(BoxProgram(boxes, values), h, w)
    np.testing.assert_array_equal(
        golden, jax_paint_numpy(JaxBoxProgram(boxes, values), h, w))
    np.testing.assert_array_equal(want, golden)
    got = paint_boxes(torch.from_numpy(boxes), torch.from_numpy(values), h, w)
    assert got.dtype == torch.int32 and got.shape == (h, w)
    np.testing.assert_array_equal(got.numpy(), want)


def test_cpu_tensor_takes_plain_version():
    before = paint_boxes_cuda.launches
    boxes = torch.tensor([[0, 2, 0, 2]], dtype=torch.int32)
    vals = torch.tensor([7], dtype=torch.int32)
    out = paint_boxes(boxes, vals, 4, 4)
    assert paint_boxes_cuda.launches == before
    assert out[:2, :2].eq(7).all() and out.sum() == 28


def test_cuda_wrapper_rejects_cpu_tensor():
    boxes = torch.zeros((1, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        paint_boxes_cuda(boxes, torch.zeros(1, dtype=torch.int32), 8, 8)


@pytest.mark.parametrize("case", PAINT_EDGE_CASES)
def test_paint_edge_programs_match_pallas_and_numpy(case):
    """The plain version against the host golden model on the raw boxes,
    and against the TPU kernel, which takes clipped boxes (the serve path
    clips them on the host): here they are clipped for it."""
    h, w = 128, 96
    boxes, values = paint_edge_program(case, h, w)
    golden = paint_boxes_numpy(BoxProgram(boxes, values), h, w)
    got = paint_boxes(torch.from_numpy(boxes), torch.from_numpy(values), h, w)
    np.testing.assert_array_equal(got.numpy(), golden)
    if case == "no_boxes":   # the TPU kernel cannot trace an empty box list
        assert not golden.any()
        return
    clipped = np.clip(boxes, 0, [h, h, w, w]).astype(np.int32)
    want = np.asarray(paint_boxes_pallas(jnp.asarray(clipped),
                                         jnp.asarray(values), h, w,
                                         interpret=True))
    np.testing.assert_array_equal(want, golden)


@pytest.mark.parametrize("h,w,n,planes", [(32, 32, 20, 3), (48, 70, 200, 4),
                                          (17, 9, 5, 1)])
def test_paint_planes_matches_jax(h, w, n, planes):
    """``paint_planes`` (one paint of a [P*H, W] grid) against the JAX
    package's per-plane select loop, with boxes over every edge and plane
    ids out of range."""
    from msau_tpu.data.rasterize import paint_planes as jax_paint_planes
    from msau_tpu_torch.data.rasterize import paint_planes
    from msau_tpu_torch.utils.kernel_inputs import planes_program

    boxes, values, ids = planes_program(np.random.default_rng(n), n, h, w,
                                        planes)
    want = np.asarray(jax_paint_planes(jnp.asarray(boxes), jnp.asarray(values),
                                       jnp.asarray(ids), h, w, planes))
    got = paint_planes(torch.from_numpy(boxes), torch.from_numpy(values),
                       torch.from_numpy(ids), h, w, planes)
    assert got.dtype == torch.int32 and got.shape == (planes, h, w)
    np.testing.assert_array_equal(got.numpy(), want)
    for p in range(planes):
        sel = ids == p
        np.testing.assert_array_equal(
            want[p], paint_boxes_numpy(BoxProgram(boxes[sel], values[sel]),
                                       h, w))
