from repro_torch.fl.adapter import ModelAdapter, femnist_adapter, lm_adapter
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
# registers the sharded engine's stages (local_sgd_sharded,
# committee_sharded, committee_int8_sharded, top_k_int8_sharded,
# fused_int8_sharded)
from repro_torch.fl import sharded  # noqa: F401

__all__ = [
    "ModelAdapter",
    "femnist_adapter",
    "lm_adapter",
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
