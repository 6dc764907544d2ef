from repro_torch.fl.adapter import ModelAdapter, femnist_adapter
from repro_torch.fl.baselines import FLConfig, FLTrainer, train_standalone
# registers the tiered round's stages (sampler "tiered", validator and
# packer "hier")
from repro_torch.fl.hier import HierState, build_hier_pipeline
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
    "HierState",
    "build_hier_pipeline",
]
