"""msau_tpu_torch — the PyTorch + CUDA port of msau_tpu for one NVIDIA H100.

The serve path (``infer.kv_model.KVModel.predict``: box programs, paint,
one-hot, the MSAU forward, device decode, host strings) and the train step
(``train``: masked CE, the optax chain, ``Trainer``) run on PyTorch, with
the TPU package's Pallas kernels on those paths rewritten by hand in CUDA
C++ (``csrc/``): paint, the resident attention forward and backward, the
multiclass CCL, the fused masked CE forward and backward, and the
flat-layout scales' ops (``flat_scales > 0``: conv with its epilogue,
concat 1x1, residual block, deconv, pool, entry layout) with their
backward.  ``msau_tpu`` stays the reference; this package imports neither
JAX nor anything of ``msau_tpu``.

The configuration dataclasses (``Config``, ``DataConfig``, ``InferConfig``,
``ModelConfig``, ``TrainConfig``) are re-exported here, as the JAX package
exports its own.  f32 precision policy, set once here (the port has no
``configure_tpu_precision``): cuDNN convolutions and matmuls run in
full f32 (PyTorch lets cuDNN use TF32 by default, which keeps about three
decimal digits).
"""

import torch

torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False

__version__ = "0.1.0"

from msau_tpu_torch.config import (  # noqa: E402
    Config,
    DataConfig,
    InferConfig,
    ModelConfig,
    TrainConfig,
)

__all__ = [
    "Config",
    "DataConfig",
    "InferConfig",
    "ModelConfig",
    "TrainConfig",
    "__version__",
]
