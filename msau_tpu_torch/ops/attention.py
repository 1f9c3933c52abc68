"""Reference-semantics attention for the MSAU deepest-scale block.

With flattened spatial tokens, A = softmax_rows(g fᵀ) and out = Aᵀ h — the
softmax runs over the *output* axis and the sum over the *input* axis (the
transpose of standard attention), with no 1/√d scaling.

Two entry points compute it, as in the JAX package.  ``resident_attention``
serves the deepest scale below 8192 tokens; ``fused_attention`` (further
down) is the streaming form for longer grids, with f32 output.

``resident_attention`` is a ``torch.autograd.Function``
(``ResidentAttention``) whose forward saves (f, g, h, m, l) with m, l each
query row's score max and sum-exp, and whose backward recomputes A from
them.  A CUDA tensor launches the hand-written kernels: the forward
(``csrc/attention.cu``, port of the TPU kernel
``msau_tpu/ops/pallas_attn.py:_res_fwd_kernel``) and the backward
(``csrc/attention_bwd.cu``, port of ``_res_bwd_kernel``).  A CPU tensor
takes the plain versions (``resident_attention_plain_stats``, the einsum
form of ``msau_tpu.models.attention.self_attention_xla``, and
``resident_attention_bwd_plain``), so CPU training runs the same backward
formula that the kernel implements.  With bf16 operands the plain versions
and the kernels round A (and, in the backward, ds) to bf16 before their
products, where the TPU kernels round them, and sum in f32.

``fused_attention`` (``FusedAttention``) is the port of
``msau_tpu.ops.pallas_attn.fused_attention``: operands upcast to f32, m, l
and every sum in f32, an f32 output whatever the operands' type, and
gradients cast back to the operands' types.  Nothing in it holds a [T, T]
tensor.  A CUDA tensor launches the resident form's two kernels
(``csrc/attention.cu``, ``msau_fused_attention_fwd``: port of the TPU
kernels ``_stats_kernel`` and ``_accum_kernel``) with an f32 output and A
kept in f32 for bf16 operands too, and, in the backward,
the rows kernel of ``csrc/attention_bwd.cu`` with an f32 cotangent (the
JAX package's ``_fused_bwd`` is that kernel's formula in f32).  A CPU
tensor takes the blockwise plain versions
(``fused_attention_plain_stats``, ``fused_attention_bwd_plain``), which
stream blocks of ``block`` keys.

Every op takes any Cb, C >= 1, on the CPU as on the card, as the JAX
block does.  At the widths of ``SPECIALISED_WIDTHS`` the CUDA entry points
run their tensor-core instances; at any other they run the general kernels
(``csrc/attention_general_fwd.cu``, ``attention_general_bwd.cu``: the same
tensor-core design with Cb and C runtime arguments), which each wrapper
also counts in ``general_launches``.
"""

from __future__ import annotations

from typing import Tuple

import torch

from msau_tpu_torch.ops import cuda_lib
from msau_tpu_torch.ops.precision import wide_dtype

# (Cb, C) pairs with kernel instances of their own (tensor-core kernels,
# csrc/attention.cu and attention_bwd.cu): the model's Cb = max(C // 8, 1)
# at feat_root 8 and pool 2, C = 8 ... 256.  Every other Cb, C >= 1 takes
# the general kernels (csrc/attention_general_fwd.cu,
# attention_general_bwd.cu), with Cb and C as runtime arguments; the block
# builds any Cb = max(C // num_heads, 1).
SPECIALISED_WIDTHS = ((1, 8), (2, 16), (4, 32), (8, 64), (16, 128),
                      (32, 256))
# the SMs the general backward's ds grid is sized for without asking the
# card: the H100's
GENERAL_BWD_SMS = 132


def _rounded_like(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x`` rounded to bf16 and back where the operands are bf16, as the
    TPU kernels round A and ds before their products
    (``pallas_attn.py:_res_fwd_kernel`` and ``_res_bwd_kernel``, which
    multiply bf16 values with f32 sums); unchanged otherwise."""
    if dtype != torch.bfloat16:
        return x
    return x.to(torch.bfloat16).to(x.dtype)


def resident_attention_plain(f: torch.Tensor, g: torch.Tensor,
                             h: torch.Tensor) -> torch.Tensor:
    """f, g: [N, T, Cb]; h: [N, T, C] -> [N, T, C] in h's dtype, computed in
    f32: out_j = sum_i h_i softmax_j(g_i . f_j).  With bf16 operands A is
    rounded to bf16 before Aᵀh, as the TPU kernel rounds it."""
    if h.dtype == torch.bfloat16:
        return resident_attention_plain_stats(f, g, h)[0]
    acc = wide_dtype(h)
    s = torch.einsum("nic,njc->nij", g.to(acc), f.to(acc))
    beta = torch.softmax(s, dim=-1)
    return torch.einsum("nij,nic->njc", beta, h.to(acc)).to(h.dtype)


def resident_attention_plain_stats(
    f: torch.Tensor, g: torch.Tensor, h: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain forward with the saved statistics: (out in h's dtype,
    m, l [N, T] f32), m_i = max_j s_ij and l_i = sum_j exp(s_ij - m_i).
    With bf16 operands A = p (1 / l) is rounded to bf16 before Aᵀh
    (``_res_fwd_kernel``)."""
    acc = wide_dtype(h)
    s = torch.einsum("nic,njc->nij", g.to(acc), f.to(acc))
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    l = p.sum(dim=-1)
    if h.dtype == torch.bfloat16:
        a = _rounded_like(p * (1.0 / l[..., None]), h.dtype)
    else:
        a = p / l[..., None]
    out = torch.einsum("nij,nic->njc", a, h.to(acc))
    return out.to(h.dtype), m, l


def resident_attention_bwd_plain(
    f: torch.Tensor, g: torch.Tensor, h: torch.Tensor, m: torch.Tensor,
    l: torch.Tensor, dout: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(df, dg, dh) in the input dtypes, from the forward's m and l; the
    f32 [N, T, T] form of ``_res_bwd_kernel``:

        A = exp(s - m) / l,  dh = A dout,  rho_i = h_i . dh_i,
        ds = A * (h doutᵀ - rho),  dg = ds f,  df = dsᵀ g.

    With bf16 operands A is rounded to bf16 before A dout, and ds before
    ds f and dsᵀ g, as the TPU kernel rounds them; A, u, rho and dh stay
    f32 (``pallas_attn.py:266-283``)."""
    acc = wide_dtype(h)
    ff, gf, hf, dof = (t.to(acc) for t in (f, g, h, dout))
    s = torch.einsum("nic,njc->nij", gf, ff)
    a = torch.exp(s - m[..., None]) / l[..., None]
    dh = torch.einsum("nij,njc->nic", _rounded_like(a, h.dtype), dof)
    rho = (hf * dh).sum(dim=-1)
    u = torch.einsum("nic,njc->nij", hf, dof)
    ds = _rounded_like(a * (u - rho[..., None]), h.dtype)
    dg = torch.einsum("nij,njc->nic", ds, ff)
    df = torch.einsum("nij,nic->njc", ds, gf)
    return df.to(f.dtype), dg.to(g.dtype), dh.to(h.dtype)


def _check_operands(name: str, f: torch.Tensor, g: torch.Tensor,
                    h: torch.Tensor) -> Tuple[int, int, int, int]:
    """Validate the kernels' f, g, h -> (n, t, cb, c)."""
    dtypes = (torch.float32, torch.bfloat16)
    for arg, t in (("f", f), ("g", g), ("h", h)):
        cuda_lib.require_cuda(f"{name} {arg}", t, dtypes, 3)
    if not (f.dtype == g.dtype == h.dtype):
        raise ValueError(f"{name}: f, g, h must share a dtype")
    if not (f.device == g.device == h.device):
        raise ValueError(f"{name}: f, g, h on different devices")
    n, t, cb = f.shape
    c = h.shape[-1]
    if g.shape != f.shape or h.shape[:2] != (n, t):
        raise ValueError(f"{name}: shapes f {tuple(f.shape)} "
                         f"g {tuple(g.shape)} h {tuple(h.shape)}")
    if cb < 1 or c < 1:
        raise ValueError(f"{name}: (Cb, C) = {(cb, c)}: both must be >= 1")
    return n, t, cb, c


def resident_attention_cuda(
    f: torch.Tensor, g: torch.Tensor, h: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the kernels (stats, then accumulate; no scratch; the
    general pair at a width outside ``SPECIALISED_WIDTHS``) -> (out, m,
    l), where m, l ([N, T] f32) are each query row's score max and sum-exp.
    ``resident_attention_cuda.launches`` counts calls, and
    ``.general_launches`` those at a width outside ``SPECIALISED_WIDTHS``
    (the other three wrappers count alike)."""
    n, t, cb, c = _check_operands("resident_attention", f, g, h)
    out = torch.empty_like(h)
    m = torch.empty((n, t), dtype=torch.float32, device=f.device)
    l = torch.empty((n, t), dtype=torch.float32, device=f.device)
    code = cuda_lib.library().msau_resident_attention_fwd(
        f.data_ptr(), g.data_ptr(), h.data_ptr(), out.data_ptr(),
        m.data_ptr(), l.data_ptr(), n, t, cb, c,
        int(f.dtype == torch.bfloat16), cuda_lib.stream_ptr(f.device))
    cuda_lib.check("msau_resident_attention_fwd", code)
    resident_attention_cuda.launches += 1
    resident_attention_cuda.general_launches += (
        (cb, c) not in SPECIALISED_WIDTHS)
    return out, m, l


resident_attention_cuda.launches = 0
resident_attention_cuda.general_launches = 0


def bwd_row_block(c: int) -> int:
    """Query rows per tile of the backward kernel (``Shape::BI`` in
    ``csrc/attention_bwd.cu``: 4 warps of 32 rows, of 16 when C >= 128)."""
    return 64 if c >= 128 else 128


def bwd_blocks_per_image(n: int, t: int, c: int, slots: int) -> int:
    """Blocks per image of the backward's persistent grid: the batch's row
    tiles over the ``slots`` the card holds at once
    (``msau_attention_bwd_slots``: the occupancy API's blocks per SM times
    the SMs), as few tiles per block as fill them.  The df scratch is one
    f32 [N, T, Cb] slice per block of an image."""
    tiles = -(-t // bwd_row_block(c))
    per_block = -(-tiles * n // max(slots, 1))
    return -(-tiles // per_block)


def general_bwd_rho_groups(c: int) -> int:
    """Column groups of the general backward's dh kernel, one partial rho
    slice [N, T] each (``general::bwd_rho_groups``): one group covers C up
    to 256 columns, and the grid takes a group of 256 per further 256."""
    return 1 if c <= 128 else -(-c // 256)


def general_bwd_rows(cb: int, f32: bool) -> int:
    """Rows i of a tile of the general backward's ds kernel
    (``general::bwd_rows``): 8 warps of 16, 4 with f32 operands at Cb > 32
    (their parts in shared memory)."""
    return 64 if f32 and cb > 32 else 128


def general_bwd_slots(f32: bool) -> int:
    """Blocks of the general backward's ds kernel the card holds at once,
    without asking it: its ``__launch_bounds__`` blocks per SM (one with
    f32 operands, whose parts fill an SM's shared memory; two with bf16)
    on ``GENERAL_BWD_SMS``."""
    return GENERAL_BWD_SMS * (1 if f32 else 2)


def general_bwd_plan(n: int, t: int, cb: int, c: int,
                     f32: bool) -> Tuple[int, int]:
    """(blocks per image of the general backward's ds kernel, f32 floats of
    its scratch), from the shapes and the operands' type alone: the
    batch's row tiles over ``general_bwd_slots``, as few tiles per block as
    fill them; the scratch holds the rho slices,
    [general_bwd_rho_groups(C), N, T], then one df slice [N, T, Cb] per
    block of an image.  ``general::bwd`` refuses a smaller scratch."""
    tiles = -(-t // general_bwd_rows(cb, f32))
    per_block = -(-tiles * n // general_bwd_slots(f32))
    per_image = -(-tiles // per_block)
    return per_image, (general_bwd_rho_groups(c) * n * t
                       + per_image * n * t * cb)


def _bwd_scratch(f: torch.Tensor, c: int,
                 dout_f32: bool) -> Tuple[torch.Tensor, int]:
    """The backward's scratch and its blocks per image: at
    ``SPECIALISED_WIDTHS`` its df slices, [blocks per image, N, T, Cb] f32,
    the blocks from the slots the card reports; at any other width the
    general kernels' rho and df slices, flat f32 (``general_bwd_plan``)."""
    n, t, cb = f.shape
    if (cb, c) not in SPECIALISED_WIDTHS:
        per_image, floats = general_bwd_plan(n, t, cb, c,
                                             f.dtype == torch.float32)
        return torch.empty((floats,), dtype=torch.float32,
                           device=f.device), per_image
    slots = cuda_lib.library().msau_attention_bwd_slots(
        cb, c, int(f.dtype == torch.bfloat16), int(dout_f32))
    if slots <= 0:
        cuda_lib.check("msau_attention_bwd_slots", -slots)
    per_image = bwd_blocks_per_image(n, t, c, slots)
    return torch.empty((per_image, n, t, cb), dtype=torch.float32,
                       device=f.device), per_image


def _check_bwd_operands(name: str, f: torch.Tensor, h: torch.Tensor,
                        m: torch.Tensor, l: torch.Tensor, dout: torch.Tensor,
                        dout_dtype: torch.dtype) -> None:
    """Validate a backward kernel's m, l ([N, T] f32) and dout (h's shape,
    ``dout_dtype``)."""
    n, t = f.shape[:2]
    cuda_lib.require_cuda(f"{name} dout", dout, dout_dtype, 3)
    for arg, st in (("m", m), ("l", l)):
        cuda_lib.require_cuda(f"{name} {arg}", st, torch.float32, 2)
        if st.shape != (n, t) or st.device != f.device:
            raise ValueError(f"{name}: {arg} must be [{n}, {t}] on "
                             f"{f.device}")
    if dout.shape != h.shape or dout.device != f.device:
        raise ValueError(f"{name}: dout must match h")


def resident_attention_bwd_cuda(
    f: torch.Tensor, g: torch.Tensor, h: torch.Tensor, m: torch.Tensor,
    l: torch.Tensor, dout: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the backward kernels (rows pass and df combine; at a width
    outside ``SPECIALISED_WIDTHS`` the general dh, ds and combine kernels) ->
    (df, dg, dh) in the input dtype.
    ``resident_attention_bwd_cuda.launches`` counts calls;
    ``resident_attention_bwd_cuda.scratch_bytes`` is the last call's
    scratch."""
    n, t, cb, c = _check_operands("resident_attention_bwd", f, g, h)
    _check_bwd_operands("resident_attention_bwd", f, h, m, l, dout, h.dtype)
    df, dg, dh = torch.empty_like(f), torch.empty_like(g), torch.empty_like(h)
    partial, per_image = _bwd_scratch(f, c, False)
    code = cuda_lib.library().msau_resident_attention_bwd(
        f.data_ptr(), g.data_ptr(), h.data_ptr(), dout.data_ptr(),
        m.data_ptr(), l.data_ptr(), df.data_ptr(), dg.data_ptr(),
        dh.data_ptr(), partial.data_ptr(), partial.numel(), per_image, n,
        t, cb, c, int(f.dtype == torch.bfloat16),
        cuda_lib.stream_ptr(f.device))
    cuda_lib.check("msau_resident_attention_bwd", code)
    resident_attention_bwd_cuda.launches += 1
    resident_attention_bwd_cuda.general_launches += (
        (cb, c) not in SPECIALISED_WIDTHS)
    resident_attention_bwd_cuda.scratch_bytes = 4 * partial.numel()
    return df, dg, dh


resident_attention_bwd_cuda.launches = 0
resident_attention_bwd_cuda.general_launches = 0
resident_attention_bwd_cuda.scratch_bytes = 0


def _device_kind(t: torch.Tensor) -> str:
    if t.device.type not in ("cuda", "cpu"):
        raise ValueError(f"attention: unsupported device {t.device}")
    return t.device.type


class ResidentAttention(torch.autograd.Function):
    """out = Aᵀh with A = softmax_rows(g fᵀ); saves (f, g, h, m, l) and
    returns (df, dg, dh) in the input dtypes, as the TPU kernel pair's
    ``jax.custom_vjp`` (``pallas_attn.py:_resident_fwd/_resident_bwd``)."""

    @staticmethod
    def forward(ctx, f, g, h):
        if _device_kind(f) == "cuda":
            out, m, l = resident_attention_cuda(f, g, h)
        else:
            out, m, l = resident_attention_plain_stats(f, g, h)
        ctx.save_for_backward(f, g, h, m, l)
        return out

    @staticmethod
    def backward(ctx, dout):
        f, g, h, m, l = ctx.saved_tensors
        # autograd may hand over a strided or differently typed cotangent
        dout = dout.to(h.dtype).contiguous()
        if _device_kind(f) == "cuda":
            return resident_attention_bwd_cuda(f, g, h, m, l, dout)
        return resident_attention_bwd_plain(f, g, h, m, l, dout)


def resident_attention(f: torch.Tensor, g: torch.Tensor,
                       h: torch.Tensor) -> torch.Tensor:
    """A = softmax_rows(g fᵀ), out = Aᵀ h, differentiable; the device of
    ``f`` picks the implementation."""
    return ResidentAttention.apply(f, g, h)


# ---------------------------------------------------------------------------
# Streaming attention: no [T, T] tensor anywhere, f32 output
# ---------------------------------------------------------------------------

# keys per block of the plain versions (the TPU kernels' default block)
FUSED_BLOCK = 256


def fused_attention_plain_stats(
    f: torch.Tensor, g: torch.Tensor, h: torch.Tensor,
    block: int = FUSED_BLOCK
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The blockwise plain forward -> (out [N, T, C], m, l [N, T]), all in
    the wide dtype (f32; float64 for float64 operands).  Two passes over
    blocks of ``block`` keys j: the online (max, sum-exp) of every query
    row, then out_j = sum_i exp(s_ij - m_i) / l_i h_i block by block, so
    the largest temporary is [N, T, block].  The last block is as short as
    T leaves it, so any T runs."""
    acc = wide_dtype(h)
    ff, gf, hf = f.to(acc), g.to(acc), h.to(acc)
    n, t, _ = f.shape
    m = torch.full((n, t), float("-inf"), dtype=acc, device=f.device)
    l = torch.zeros((n, t), dtype=acc, device=f.device)
    for j0 in range(0, t, block):
        s = torch.einsum("nic,njc->nij", gf, ff[:, j0:j0 + block])
        m_new = torch.maximum(m, s.amax(dim=-1))
        l = l * torch.exp(m - m_new) + torch.exp(s - m_new[..., None]).sum(-1)
        m = m_new
    out = torch.empty_like(hf)
    inv_l = 1.0 / l
    for j0 in range(0, t, block):
        s = torch.einsum("nic,njc->nij", gf, ff[:, j0:j0 + block])
        p = torch.exp(s - m[..., None]) * inv_l[..., None]
        out[:, j0:j0 + block] = torch.einsum("nij,nic->njc", p, hf)
    return out, m, l


def fused_attention_bwd_plain(
    f: torch.Tensor, g: torch.Tensor, h: torch.Tensor, m: torch.Tensor,
    l: torch.Tensor, dout: torch.Tensor, block: int = FUSED_BLOCK
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(df, dg, dh) in the input dtypes from the forward's m and l, two
    sweeps over blocks of ``block`` keys (``resident_attention_bwd_plain``'s
    formula with no [N, T, T] tensor; port of ``_fused_bwd``): dh = A dout,
    then rho, and per block ds, dg += ds f_blk, df_blk = dsᵀ g."""
    acc = wide_dtype(h)
    ff, gf, hf, dof = (x.to(acc) for x in (f, g, h, dout))
    t = f.shape[1]
    m, inv_l = m.to(acc)[..., None], (1.0 / l.to(acc))[..., None]

    def a_block(j0):
        s = torch.einsum("nic,njc->nij", gf, ff[:, j0:j0 + block])
        return torch.exp(s - m) * inv_l

    dh = torch.zeros_like(hf)
    for j0 in range(0, t, block):
        dh += torch.einsum("nij,njc->nic", a_block(j0), dof[:, j0:j0 + block])
    rho = (hf * dh).sum(dim=-1, keepdim=True)
    dg, df = torch.zeros_like(gf), torch.empty_like(ff)
    for j0 in range(0, t, block):
        u = torch.einsum("nic,njc->nij", hf, dof[:, j0:j0 + block])
        ds = a_block(j0) * (u - rho)
        dg += torch.einsum("nij,njc->nic", ds, ff[:, j0:j0 + block])
        df[:, j0:j0 + block] = torch.einsum("nij,nic->njc", ds, gf)
    return df.to(f.dtype), dg.to(g.dtype), dh.to(h.dtype)


def fused_attention_cuda(
    f: torch.Tensor, g: torch.Tensor, h: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the streaming forward (the resident form's stats and
    accumulate kernels with an f32 output; no scratch) -> (out [N, T, C]
    f32, m, l [N, T] f32).  ``fused_attention_cuda.launches`` counts
    calls."""
    n, t, cb, c = _check_operands("fused_attention", f, g, h)
    out = torch.empty((n, t, c), dtype=torch.float32, device=f.device)
    m = torch.empty((n, t), dtype=torch.float32, device=f.device)
    l = torch.empty((n, t), dtype=torch.float32, device=f.device)
    code = cuda_lib.library().msau_fused_attention_fwd(
        f.data_ptr(), g.data_ptr(), h.data_ptr(), out.data_ptr(),
        m.data_ptr(), l.data_ptr(), n, t, cb, c,
        int(f.dtype == torch.bfloat16), cuda_lib.stream_ptr(f.device))
    cuda_lib.check("msau_fused_attention_fwd", code)
    fused_attention_cuda.launches += 1
    fused_attention_cuda.general_launches += (
        (cb, c) not in SPECIALISED_WIDTHS)
    return out, m, l


fused_attention_cuda.launches = 0
fused_attention_cuda.general_launches = 0


def fused_attention_bwd_cuda(
    f: torch.Tensor, g: torch.Tensor, h: torch.Tensor, m: torch.Tensor,
    l: torch.Tensor, dout: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the backward kernels on the streaming forward's f32
    cotangent (the f32 path whatever the operands' type; the general
    sweeps outside ``SPECIALISED_WIDTHS``) -> (df, dg, dh) in the
    operands' dtype.  ``fused_attention_bwd_cuda.launches`` counts calls;
    ``fused_attention_bwd_cuda.scratch_bytes`` is the last call's
    scratch."""
    n, t, cb, c = _check_operands("fused_attention_bwd", f, g, h)
    _check_bwd_operands("fused_attention_bwd", f, h, m, l, dout,
                        torch.float32)
    df, dg, dh = torch.empty_like(f), torch.empty_like(g), torch.empty_like(h)
    partial, per_image = _bwd_scratch(f, c, True)
    code = cuda_lib.library().msau_fused_attention_bwd(
        f.data_ptr(), g.data_ptr(), h.data_ptr(), dout.data_ptr(),
        m.data_ptr(), l.data_ptr(), df.data_ptr(), dg.data_ptr(),
        dh.data_ptr(), partial.data_ptr(), partial.numel(), per_image, n,
        t, cb, c, int(f.dtype == torch.bfloat16),
        cuda_lib.stream_ptr(f.device))
    cuda_lib.check("msau_fused_attention_bwd", code)
    fused_attention_bwd_cuda.launches += 1
    fused_attention_bwd_cuda.general_launches += (
        (cb, c) not in SPECIALISED_WIDTHS)
    fused_attention_bwd_cuda.scratch_bytes = 4 * partial.numel()
    return df, dg, dh


fused_attention_bwd_cuda.launches = 0
fused_attention_bwd_cuda.general_launches = 0
fused_attention_bwd_cuda.scratch_bytes = 0


class FusedAttention(torch.autograd.Function):
    """out = Aᵀh in f32 with A = softmax_rows(g fᵀ), streamed; saves
    (f, g, h, m, l) and returns (df, dg, dh) in the input dtypes, as
    ``pallas_attn.py``'s ``jax.custom_vjp`` (``_fused_fwd`` /
    ``_fused_bwd``)."""

    @staticmethod
    def forward(ctx, f, g, h, block):
        if _device_kind(f) == "cuda":
            out, m, l = fused_attention_cuda(f, g, h)
        else:
            out, m, l = fused_attention_plain_stats(f, g, h, block)
        ctx.save_for_backward(f, g, h, m, l)
        ctx.block = block
        return out

    @staticmethod
    def backward(ctx, dout):
        f, g, h, m, l = ctx.saved_tensors
        # the output is f32 (float64 on the CPU's exact path), and so is
        # its cotangent; autograd may hand it over strided
        if _device_kind(f) == "cuda":
            dout = dout.to(torch.float32).contiguous()
            return (*fused_attention_bwd_cuda(f, g, h, m, l, dout), None)
        return (*fused_attention_bwd_plain(f, g, h, m, l, dout, ctx.block),
                None)


def fused_attention(f: torch.Tensor, g: torch.Tensor, h: torch.Tensor,
                    block: int = FUSED_BLOCK) -> torch.Tensor:
    """A = softmax_rows(g fᵀ), out = Aᵀ h in f32 (float64 for float64
    operands), differentiable, with no [T, T] tensor; the device of ``f``
    picks the implementation.  ``block``: keys per block of the plain
    versions (the kernel has its own tiles)."""
    return FusedAttention.apply(f, g, h, block)
