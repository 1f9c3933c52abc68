"""Device ops of the port: the hand-written CUDA kernels' wrappers (paint,
resident attention forward and backward, streaming attention forward and
backward, multiclass CCL, fused masked CE
forward and backward, and the flat-layout ops: entry layout, max pool, conv
with its fused epilogue, concat 1x1 conv, stride-2 deconv and the fused
residual block, with their backward: pool, conv stage 1 and dx, the
concat 1x1 conv's one pass, deconv dx and dw, residual block; the box
filter forward and backward), and the torch-op morphology and single-map labelling that ``msau_tpu.ops`` exports."""

from msau_tpu_torch.ops.attention import (
    fused_attention_bwd_cuda,
    fused_attention_cuda,
    resident_attention_bwd_cuda,
    resident_attention_cuda,
)
from msau_tpu_torch.ops.boxconv import box_conv_bwd_cuda, box_conv_fwd_cuda
from msau_tpu_torch.ops.ccl import (
    connected_components_jax,
    connected_components_multiclass_cuda,
)
from msau_tpu_torch.ops.ce_loss import masked_ce_bwd_cuda, masked_ce_fwd_cuda
from msau_tpu_torch.ops.flatconv import (
    concat_conv1x1_bwd_cuda,
    concat_conv1x1_cuda,
    flat_conv2d_cuda,
    flat_conv_bwd_cuda,
    flat_conv_dx_cuda,
    flat_deconv2_cuda,
    flat_deconv2_dw_cuda,
    flat_deconv2_dx_cuda,
    flat_maxpool2_bwd_cuda,
    flat_maxpool2_cuda,
    to_nchw_cuda,
)
from msau_tpu_torch.ops.flatres import (
    flat_res_block_bwd_cuda,
    flat_res_block_cuda,
)
from msau_tpu_torch.ops.morphology import (
    r_closing,
    r_dilation,
    r_erosion,
    r_opening,
)
from msau_tpu_torch.ops.paint import paint_boxes_cuda

# kernel name -> its wrapper, whose ``launches`` attribute counts launches
KERNEL_WRAPPERS = {
    "paint": paint_boxes_cuda,
    "resident_attention_fwd": resident_attention_cuda,
    "ccl_multiclass": connected_components_multiclass_cuda,
    "resident_attention_bwd": resident_attention_bwd_cuda,
    "masked_ce_fwd": masked_ce_fwd_cuda,
    "masked_ce_bwd": masked_ce_bwd_cuda,
    "to_nchw": to_nchw_cuda,
    "flat_maxpool2": flat_maxpool2_cuda,
    "flat_conv2d": flat_conv2d_cuda,
    "concat_conv1x1": concat_conv1x1_cuda,
    "flat_deconv2": flat_deconv2_cuda,
    "flat_res_block": flat_res_block_cuda,
    "flat_maxpool2_bwd": flat_maxpool2_bwd_cuda,
    "flat_conv_bwd": flat_conv_bwd_cuda,
    "flat_conv_dx": flat_conv_dx_cuda,
    "concat_conv1x1_bwd": concat_conv1x1_bwd_cuda,
    "flat_deconv2_dx": flat_deconv2_dx_cuda,
    "flat_deconv2_dw": flat_deconv2_dw_cuda,
    "flat_res_block_bwd": flat_res_block_bwd_cuda,
    "fused_attention_fwd": fused_attention_cuda,
    "fused_attention_bwd": fused_attention_bwd_cuda,
    "box_conv_fwd": box_conv_fwd_cuda,
    "box_conv_bwd": box_conv_bwd_cuda,
}

# the attention's general kernels (csrc/attention_general.cuh, every width
# outside ops.attention.SPECIALISED_WIDTHS) -> the wrapper whose
# ``general_launches`` counts them; its ``launches`` counts them too
GENERAL_ATTENTION = {
    "resident_attention_fwd_general": resident_attention_cuda,
    "resident_attention_bwd_general": resident_attention_bwd_cuda,
    "fused_attention_fwd_general": fused_attention_cuda,
    "fused_attention_bwd_general": fused_attention_bwd_cuda,
}


# the flat conv's wrappers (csrc/flatconv.cu) -> the wrapper whose
# ``tc_launches`` counts its f32 launches on the tensor cores
TENSOR_CORE_CONV = {
    "flat_conv2d": flat_conv2d_cuda,
    "flat_conv_dx": flat_conv_dx_cuda,
    "concat_conv1x1": concat_conv1x1_cuda,
}


def reset_launch_counts() -> None:
    for fn in KERNEL_WRAPPERS.values():
        fn.launches = 0
    for fn in GENERAL_ATTENTION.values():
        fn.general_launches = 0
    for fn in TENSOR_CORE_CONV.values():
        fn.tc_launches = 0


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in KERNEL_WRAPPERS.items()}


def general_launch_counts() -> dict:
    return {name: fn.general_launches
            for name, fn in GENERAL_ATTENTION.items()}


def tc_launch_counts() -> dict:
    return {name: fn.tc_launches for name, fn in TENSOR_CORE_CONV.items()}
