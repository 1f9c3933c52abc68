"""msau_tpu_torch — the PyTorch + CUDA port of msau_tpu for one NVIDIA H100.

The serve path (``infer.kv_model.KVModel.predict``: box programs, paint,
one-hot, the MSAU forward, device decode, host strings) runs on PyTorch,
with the TPU package's Pallas kernels on that path rewritten by hand in CUDA
C++ (``csrc/``): paint, the resident attention forward and the multiclass
CCL.  ``msau_tpu`` stays the reference; this package never imports JAX.

f32 precision policy, set once here: cuDNN convolutions and matmuls run in
full f32 (PyTorch lets cuDNN use TF32 by default, which keeps about three
decimal digits).
"""

import torch

torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False

__version__ = "0.1.0"
