"""Configuration dataclasses of the port: ``ModelConfig``, ``DataConfig``,
``TrainConfig`` and ``InferConfig`` with the JAX package's field names and defaults
(``msau_tpu/config.py``), so one configuration drives both implementations.
The port keeps its own copy: it imports nothing of ``msau_tpu``.
``tests/test_torch_host_copies.py`` pins the copy to the original.

Fields that are TPU knobs (``matmul_precision``, ``donate_state``, the mesh
layout) are accepted and ignored by the port.  ``attention_impl`` picks the
deepest scale's attention op as in the JAX package
(``models/attention.py``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple


@dataclass
class ModelConfig:
    """Hyper-parameters of the MSAU segmentation network (reference
    defaults, model/model.py:406-419)."""

    model: str = "msau"                # "msau" | "msau_box" | "unet"
    img_channels: int = 1              # input channels (chargrid token dim)
    n_class: int = 2                   # output classes (incl. background 0)
    scale_space_num: int = 6           # number of U-Net scales
    res_depth: int = 3                 # convs per residual block
    feat_root: int = 8                 # features at the first scale
    filter_size: int = 3               # conv kernel size
    pool_size: int = 2                 # pooling stride / feature multiplier
    activation_name: str = "relu"      # "relu" | "elu"
    final_act: str = "softmax"         # "softmax" | "sigmoid" | "identity"
    num_blocks: int = 3                # number of coupled U-Net stages
    use_auxiliary_loss: bool = True
    use_lstm: bool = False             # separable RNN at the bottleneck
    use_spn: bool = False              # CSPN refinement on the last stage
    use_lrn: bool = True               # LRN after dilated convs
    # box-convolution variant (reference model/model_box.py:360-406)
    num_box_convs: int = 3
    max_box_size: int = 28
    num_box_per_channel: int = 3
    dtype: str = "float32"             # "float32" | "bfloat16" (| "float64": CPU reference)
    attention_impl: str = "auto"       # "auto" | "resident" | "pallas" | "xla"
    remat: bool = False                # recompute each U-Net stage in backward
    flat_scales: int = 0               # shallow scales through the flat ops
    spatial_shards: int = 1            # H shards on the flat scales

    # reference ``model_kwargs.json`` key -> field
    _MODEL_KWARGS_MAP = {
        "model": "model",
        "final_act": "final_act",
        "featRoot": "feat_root",
        "scale_space_num": "scale_space_num",
        "res_depth": "res_depth",
        "n_class": "n_class",
        "img_channels": "img_channels",
        "use_auxiliary_loss": "use_auxiliary_loss",
        "filter_size": "filter_size",
        "pool_size": "pool_size",
        "activation_name": "activation_name",
        "num_box_convs": "num_box_convs",
        "max_box_sizes": "max_box_size",
        "num_box_per_channels": "num_box_per_channel",
        "num_blocks": "num_blocks",
    }

    def to_model_kwargs(self) -> Dict[str, Any]:
        """Serialize to the reference's ``model_kwargs.json`` schema."""
        return {k: getattr(self, attr)
                for k, attr in self._MODEL_KWARGS_MAP.items()}

    @classmethod
    def from_model_kwargs(cls, kwargs: Dict[str, Any]) -> "ModelConfig":
        """Build from a reference-style ``model_kwargs`` dict (extra keys
        ignored)."""
        return cls(**{attr: kwargs[k]
                      for k, attr in cls._MODEL_KWARGS_MAP.items()
                      if k in kwargs})


@dataclass
class DataConfig:
    """Chargrid generation / augmentation parameters.

    Mirrors the reference `kwargs_dat` dict
    (data_generator/data_generator_funsd.py:53-104) plus static-shape
    bucketing.
    """

    n_classes: int = 5
    charset_path: Optional[str] = None
    batch_size: int = 1
    # text height scaling (pixels of text height after rescale)
    scale_min: float = 2.0
    scale_max: float = 4.0
    scale_val: float = 3.0
    # augmentation
    affine: bool = False
    affine_value: float = 0.025
    elastic: bool = False
    elastic_value_x: float = 0.0002
    elastic_value_y: float = 0.0002
    rotate: bool = False               # U(-20, 20) degrees (data_generator_text.py:308)
    rotate_mod90: bool = False         # exact k*90 rotation (rotateMod90 intent)
    text_err: float = 0.0              # OCR-noise injection rate
    shuffle: bool = True
    # static-shape bucketing (the reference uses data-dependent image
    # sizes, data_generator_funsd.py:330-334)
    buckets: Tuple[int, ...] = (256, 512, 1024)
    max_chars: int = 8192              # per-image char-box budget (padded)
    max_lines: int = 1024              # per-image line budget (padded)
    prefetch: int = 2
    num_workers: int = 2


@dataclass
class TrainConfig:
    """Optimizer / loop parameters (reference model/training/*)."""

    optimizer: str = "adam"            # "adam" | "rmsprop" | "momentum"
    learning_rate: float = 1e-4
    lr_decay_staircase: bool = True    # lr * rate ** (epoch // every)
    lr_decay_rate: float = 0.95
    lr_decay_every_epochs: int = 10
    weight_decay: float = 0.0
    momentum: float = 0.9
    grad_clip_norm: float = 1.0
    epochs: int = 250
    batch_steps_per_epoch: int = 1024
    checkpoint_every_epochs: int = 8
    seed: int = 777
    matmul_precision: str = "BF16_BF16_F32_X3"   # accepted and ignored
    loss_aux_weight: float = 0.5       # 0.5 * final + 0.5 * aux
    masked_loss: bool = True           # entry-A masked CE
    donate_state: bool = True          # accepted and ignored
    mesh_shape: Tuple[int, ...] = (-1,)
    mesh_axes: Tuple[str, ...] = ("data",)


@dataclass
class InferConfig:
    """KV decoding parameters (reference inference/kv_model.py)."""

    scale: float = 3.0                 # text height target
    n_class: int = 17
    class_names: Tuple[str, ...] = ()
    multiple_lines_fields: Tuple[int, ...] = (5, 11)
    min_component_area: int = 5
    closing_size: Tuple[int, int] = (1, 3)
    iou_threshold: float = 0.7         # field match criterion
    # the JAX decoder's bound on CCL sweeps; read by nothing in the port,
    # whose CCL runs to convergence (kept for config parity)
    max_ccl_iters: int = 64


__all__ = ["DataConfig", "InferConfig", "ModelConfig", "TrainConfig"]
