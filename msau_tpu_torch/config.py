"""Configuration dataclasses of the port: the JAX package's own
``ModelConfig`` / ``InferConfig`` / ``TrainConfig`` (``msau_tpu.config``
imports no JAX), so one config drives both implementations."""

from msau_tpu.config import InferConfig, ModelConfig, TrainConfig

__all__ = ["InferConfig", "ModelConfig", "TrainConfig"]
