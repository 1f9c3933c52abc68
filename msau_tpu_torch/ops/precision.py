"""The dtype the plain versions compute in.

Every plain version computes in f32 from its f32 or bf16 operands, as its
kernel does.  A float64 tensor stays float64: a float64 model on the CPU
runs the same plain versions with no f32 rounding, and is the reference a
float32 step's gradients are held to.
"""

import torch


def wide_dtype(t: torch.Tensor) -> torch.dtype:
    return torch.float64 if t.dtype == torch.float64 else torch.float32


def wide(t: torch.Tensor) -> torch.Tensor:
    """``t`` in ``wide_dtype(t)``: f32, or float64 for a float64 tensor."""
    return t.to(wide_dtype(t))
