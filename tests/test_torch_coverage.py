"""Coverage of the JAX package by the port: every public top-level ``def``
and ``class`` of ``msau_tpu/`` (read with ``ast``) has a counterpart of
that name in ``msau_tpu_torch/``, or stands in ``TPU_ONLY`` with its
port counterpart or its reason.  One test per module of ``msau_tpu/``.

``TPU_ONLY`` holds the body-flat layout helpers (the port's flat layers
take ``flat=True`` over NCHW tensors, ``ops/flatconv.py``), the Pallas
dispatchers and support gates (the port's ``ops/*`` wrappers take any
shape: the attention any Cb and C, on the card through its general
kernels where no specialised instance has the width), the TPU precision knob, initialisers the port writes as one
helper, the oracles, and one capability: ``start_server``.
"""

import ast
import importlib
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]

LAYOUT, DISPATCH, KNOB, ORACLE, INIT, CAPABILITY = (
    "layout", "dispatcher", "knob", "oracle", "initialiser", "capability")

# "module:name" of msau_tpu -> (kind, port counterpart "module:attr" or
# None, reason)
TPU_ONLY = {
    "__init__:configure_tpu_precision": (
        KNOB, None, "TPU matmul precision; the port sets full f32 (TF32 off) "
        "once at import, msau_tpu_torch/__init__.py"),
    "data.rasterize:paint_boxes_fast": (
        DISPATCH, "ops.paint:paint_boxes", "Pallas or XLA painter by backend"),
    "models.attention:self_attention_pallas": (
        DISPATCH, "ops.attention:fused_attention",
        "two-pass attention in blocks; the port streams it in CUDA"),
    "models.attention:self_attention_xla": (
        ORACLE, "ops.attention:resident_attention_plain",
        "the einsum form; the port's plain version"),
    "models.flat_layers:ConcatConv1x1": (
        LAYOUT, "ops.flatconv:concat_conv1x1", "body-flat coupling layer"),
    "models.flat_layers:ConcatConvKxK": (
        LAYOUT, "ops.flatconv:flat_conv2d",
        "body-flat merge conv; flat_conv2d reads a second input as a concat"),
    "models.flat_layers:FlatConvOp": (
        LAYOUT, "models.layers:Conv", "nn.Conv on body tensors; the port's "
        "layers take flat=True"),
    "models.flat_layers:body_to_nhwc": (
        LAYOUT, "ops.flatconv:to_nchw", "the port's flat layout is NCHW"),
    "models.flat_layers:nhwc_to_body": (
        LAYOUT, "ops.flatconv:to_nchw", "the port's flat layout is NCHW"),
    "models.flat_layers:flat_eligible": (
        LAYOUT, None, "VMEM gate; the port runs every conv size flat"),
    "models.flat_layers:make_scale_geoms": (
        LAYOUT, None, "body-flat geometry per scale; NCHW needs none"),
    "models.layers:tf_bias_init": (
        INIT, "models.layers:Conv", "the port's Conv draws the same "
        "distributions from a torch.Generator"),
    "models.layers:tf_conv_kernel_init": (
        INIT, "models.layers:tf_conv_std", "the same stddev"),
    "ops.ccl:connected_components_multiclass_auto": (
        DISPATCH, "ops.ccl:connected_components_multiclass",
        "VMEM kernel or XLA by map size; the port's kernel takes any size"),
    "ops.ccl:connected_components_multiclass_pallas": (
        DISPATCH, "ops.ccl:connected_components_multiclass_cuda",
        "the Pallas launcher; the CUDA one"),
    "ops.flatconv:FlatGeom": (
        LAYOUT, None, "body-flat geometry (pads, guards, 128-lane tiles)"),
    "ops.flatconv:body_lrn": (
        LAYOUT, "ops.flatconv:local_response_norm", "LRN on body tensors"),
    "ops.flatconv:body_mask": (
        LAYOUT, None, "re-zeroes body-flat guards; NCHW has none"),
    "ops.flatconv:body_maxpool2": (
        LAYOUT, "ops.flatconv:flat_maxpool2", "max pool on body tensors"),
    "ops.flatconv:body_upsample2": (
        LAYOUT, "ops.flatconv:flat_deconv2",
        "zero insertion for the deconv; the port's deconv kernel needs none"),
    "ops.flatconv:choose_geom": (
        LAYOUT, None, "TPU tile and halo choice"),
    "ops.flatconv:extend_shards": (
        LAYOUT, "parallel.spatial:SpatialShards",
        "halo rows of H-shards in the body-flat form"),
    "ops.flatconv:shrink_shards": (
        LAYOUT, "parallel.spatial:SpatialShards",
        "inverse of extend_shards"),
    "ops.flatconv:flat_concat_conv1x1": (
        DISPATCH, "ops.flatconv:concat_conv1x1", "the Pallas op"),
    "ops.flatconv:flat_concat_conv2d": (
        DISPATCH, "ops.flatconv:flat_conv2d", "the Pallas op"),
    "ops.flatconv:flat_conv2d_reference": (
        ORACLE, "ops.flatconv:flat_conv2d_plain", "XLA oracle for tests"),
    "ops.flatconv:flat_upsample2": (
        DISPATCH, "ops.flatconv:flat_deconv2",
        "runs inside the deconv kernel (PERF.md row 9)"),
    "ops.flatconv:from_body": (
        LAYOUT, None, "body-flat to NCHW; the port's flat layout is NCHW"),
    "ops.flatconv:max_flat_cin": (
        LAYOUT, None, "VMEM budget gate"),
    "ops.flatconv:to_body": (
        LAYOUT, "ops.flatconv:to_nchw", "entry layout"),
    "ops.flatconv:to_body_nhwc_fused": (
        DISPATCH, "ops.flatconv:to_nchw_cuda", "the entry layout kernel"),
    "ops.flatres:flat_res_block_reference": (
        ORACLE, "ops.flatres:flat_res_block_plain", "oracle for tests"),
    "ops.flatres:fused_res_supported": (
        DISPATCH, None, "VMEM gate; the port's block takes 4-32 channels "
        "and wider ones run as flat convs"),
    "ops.paint_pallas:paint_boxes_pallas": (
        DISPATCH, "ops.paint:paint_boxes_cuda", "the Pallas launcher"),
    "ops.pallas_attn:resident_attn_supported": (
        DISPATCH, None, "VMEM gate; the port's resident kernels take any "
        "T, Cb and C"),
    "utils.profiling:start_server": (
        CAPABILITY, "utils.profiling:capture_trace",
        "a live JAX profiler server has no torch counterpart; capture_trace "
        "writes a torch.profiler trace of a block instead"),
}


def _module_id(path: Path) -> str:
    rel = path.relative_to(ROOT / "msau_tpu").with_suffix("")
    return ".".join(rel.parts)


def _top_names(path: Path, assignments: bool):
    names = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            names.add(node.name)
        elif assignments and isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) else [
                node.target]
            names.update(t.id for t in targets if isinstance(t, ast.Name))
    return names


JAX_MODULES = {
    _module_id(p): sorted(n for n in _top_names(p, False)
                          if not n.startswith("_"))
    for p in sorted((ROOT / "msau_tpu").rglob("*.py"))}
JAX_MODULES = {m: ns for m, ns in JAX_MODULES.items() if ns}
PORT_NAMES = set().union(*(_top_names(p, True) for p in
                           (ROOT / "msau_tpu_torch").rglob("*.py")))


@pytest.mark.parametrize("module", sorted(JAX_MODULES))
def test_public_names_have_counterparts(module):
    missing = [n for n in JAX_MODULES[module]
               if n not in PORT_NAMES and f"{module}:{n}" not in TPU_ONLY]
    assert not missing, (f"msau_tpu/{module.replace('.', '/')}.py: "
                         f"{missing} have no counterpart in msau_tpu_torch/")


@pytest.mark.parametrize("entry", sorted(TPU_ONLY))
def test_table_entry_is_needed_and_resolves(entry):
    """Each entry names a public name of its module that the port lacks
    (so the table stays exact), and its counterpart imports."""
    module, name = entry.split(":")
    assert name in JAX_MODULES.get(module, ()), entry
    assert name not in PORT_NAMES, f"{entry} is ported under its own name"
    kind, counterpart, reason = TPU_ONLY[entry]
    assert kind in (LAYOUT, DISPATCH, KNOB, ORACLE, INIT, CAPABILITY)
    assert reason
    if counterpart is not None:
        mod, attr = counterpart.split(":")
        assert hasattr(importlib.import_module(f"msau_tpu_torch.{mod}"),
                       attr), counterpart


def test_only_capability_left_out_is_start_server():
    assert [k for k, v in TPU_ONLY.items() if v[0] == CAPABILITY] == [
        "utils.profiling:start_server"]
