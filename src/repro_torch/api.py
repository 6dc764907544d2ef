"""repro_torch.api — the one-call entry point over the round pipeline.

    from repro_torch.api import build_runtime

    rt = build_runtime(adapter, dataset, {"quantize_chain": True,
                                          "use_kernels": True})
    rt.run(rounds=10)

Port of ``repro/api.py`` for the BFLC runtime.  ``cfg`` is a ``BFLCConfig``
or a dict of its fields; ``stages`` swaps any round stage by registered
name or bare callable (see ``repro_torch.fl.pipeline``).  The runtime runs
on ``device``: CUDA by default, raising when CUDA is absent unless the
caller passes ``device="cpu"``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Union

from repro_torch.fl.runtime import BFLCConfig, BFLCRuntime

ConfigLike = Union[BFLCConfig, Dict[str, Any], None]


def build_config(cfg: ConfigLike = None, *, baseline: bool = False) -> BFLCConfig:
    """dict / None -> BFLCConfig; a BFLCConfig passes through."""
    if baseline:
        raise NotImplementedError(
            "baseline=True (Basic FL / CwMed, fl/baselines.py) is not "
            "ported yet: ROADMAP.md Queue 1 item 7"
        )
    if cfg is None:
        return BFLCConfig()
    if isinstance(cfg, dict):
        return BFLCConfig(**cfg)
    if isinstance(cfg, BFLCConfig):
        return cfg
    raise TypeError(f"cfg must be BFLCConfig, dict, or None — got {type(cfg)!r}")


def build_runtime(
    adapter,
    dataset,
    cfg: ConfigLike = None,
    *,
    baseline: bool = False,
    initial_params=None,
    stages: Optional[Dict[str, object]] = None,
    mesh=None,
    tiers: Optional[int] = None,
    schedule: str = "sequential",
    device="cuda",
) -> BFLCRuntime:
    """Builds the BFLC round runtime (chain + committee consensus).

    ``initial_params`` warm-starts the genesis model block (a dict of
    tensors or numpy arrays with the reference's keys and layouts).
    ``mesh``, ``tiers > 1``, ``schedule="async"`` and ``baseline=True``
    are the reference's sharded, hierarchical, asynchronous and baseline
    engines; they raise ``NotImplementedError`` until ported."""
    cfg = build_config(cfg, baseline=baseline)
    if tiers is not None:
        cfg = dataclasses.replace(cfg, tiers=int(tiers))
    return BFLCRuntime(adapter, dataset, cfg, initial_params=initial_params,
                       stages=stages, mesh=mesh, schedule=schedule,
                       device=device)
