from repro_torch.fl.adapter import ModelAdapter, femnist_adapter
from repro_torch.fl.baselines import FLConfig, FLTrainer, train_standalone
from repro_torch.fl.pipeline import (
    REGISTRIES,
    RoundContext,
    RoundPipeline,
    build_pipeline,
    register,
)
from repro_torch.fl.runtime import BFLCConfig, BFLCRuntime, RoundLog

__all__ = [
    "ModelAdapter",
    "femnist_adapter",
    "BFLCConfig",
    "BFLCRuntime",
    "RoundLog",
    "FLConfig",
    "FLTrainer",
    "train_standalone",
    "RoundContext",
    "RoundPipeline",
    "REGISTRIES",
    "build_pipeline",
    "register",
]
