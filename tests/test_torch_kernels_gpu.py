"""The port's CUDA kernels against their plain PyTorch versions on the card,
at the serve slice's shapes.  Every test here needs a CUDA card and skips
without one.  This file imports no JAX, so it runs on the machine with the
card (which has none):

    python -m pytest tests/test_torch_kernels_gpu.py -m gpu --noconftest -q

Tolerances: paint and CCL are integer maps, exact; attention is f32 in the
kernel, 1e-5 against the plain f32 einsum (sum order over T keys), and 2e-2
for bf16 inputs (the output is rounded to bf16).
"""

import numpy as np
import pytest
import torch

from msau_tpu_torch.ops.attention import (
    resident_attention_cuda,
    resident_attention_plain,
)
from msau_tpu_torch.ops.ccl import (
    connected_components_multiclass_cuda,
    connected_components_multiclass_plain,
)
from msau_tpu_torch.ops.paint import paint_boxes_cuda, paint_boxes_plain
from msau_tpu_torch.utils.kernel_inputs import (
    attention_inputs,
    ccl_map,
    paint_program,
)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run on the H100")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("h,w,n,pad", [(512, 512, 3000, 4096),
                                       (100, 70, 50, 64)])
def test_paint_kernel_matches_plain(cuda, h, w, n, pad):
    boxes, values = paint_program(np.random.default_rng(0), n, h, w, pad)
    b = torch.from_numpy(boxes).to(cuda)
    v = torch.from_numpy(values).to(cuda)
    got = paint_boxes_cuda(b, v, h, w)
    torch.cuda.synchronize()
    assert torch.equal(got, paint_boxes_plain(b, v, h, w))


@pytest.mark.gpu
@pytest.mark.parametrize("t,dtype,tol", [(4096, torch.float32, 1e-5),
                                         (4096, torch.bfloat16, 2e-2),
                                         (66, torch.float32, 1e-5)])
def test_attention_kernel_matches_plain(cuda, t, dtype, tol):
    f, g, h = (torch.from_numpy(a).to(cuda, dtype) for a in
               attention_inputs(np.random.default_rng(t), 1, t, 8, 64))
    got, _, _ = resident_attention_cuda(f, g, h)
    torch.cuda.synchronize()
    want = resident_attention_plain(f, g, h)
    assert got.dtype == dtype
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["blobby", "noisy", "maze"])
def test_ccl_kernel_matches_plain(cuda, kind):
    cls = ccl_map(kind, 512, 512, np.random.default_rng(5))
    t = torch.from_numpy(cls).to(cuda)
    got = connected_components_multiclass_cuda(t)
    torch.cuda.synchronize()
    assert torch.equal(got, connected_components_multiclass_plain(t))
