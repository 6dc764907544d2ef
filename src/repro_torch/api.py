"""repro_torch.api — the one-call entry point over the round pipeline.

    from repro_torch.api import build_runtime

    rt = build_runtime(adapter, dataset, {"quantize_chain": True,
                                          "use_kernels": True})
    rt.run(rounds=10)

Port of ``repro/api.py``.  ``cfg`` may be a ``BFLCConfig``
(-> ``BFLCRuntime``), an ``FLConfig`` (-> the committee-free
``FLTrainer``), or a dict of config fields (``baseline=True`` selects the
FL baseline); ``stages`` swaps any round stage by registered name or bare
callable (see ``repro_torch.fl.pipeline``).  The runtime runs on
``device``: CUDA by default, raising when CUDA is absent unless the caller
passes ``device="cpu"``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Union

from repro_torch.fl.baselines import FLConfig, FLTrainer
from repro_torch.fl.runtime import BFLCConfig, BFLCRuntime

ConfigLike = Union[BFLCConfig, FLConfig, Dict[str, Any], None]


def build_config(cfg: ConfigLike = None, *, baseline: bool = False):
    """dict / None -> config dataclass; dataclasses pass through."""
    if cfg is None:
        cfg = {}
    if isinstance(cfg, dict):
        return FLConfig(**cfg) if baseline else BFLCConfig(**cfg)
    if isinstance(cfg, BFLCConfig):
        if baseline:
            raise ValueError(
                "baseline=True contradicts a BFLCConfig: pass an FLConfig "
                "(or a dict of FLConfig fields) for the committee-free "
                "baseline"
            )
        return cfg
    if isinstance(cfg, FLConfig):
        return cfg
    raise TypeError(
        f"cfg must be BFLCConfig, FLConfig, dict, or None — got {type(cfg)!r}"
    )


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
):
    """Builds the round runtime for a config: ``BFLCRuntime`` (chain +
    committee consensus) for a ``BFLCConfig``, or ``FLTrainer`` (Basic FL /
    CwMed, the same pipeline with the committee stages as no-ops) for an
    ``FLConfig`` or ``baseline=True``.  Both expose ``run(rounds,
    eval_every)``, ``run_round()``, ``evaluate()`` and per-round
    ``stage_timings``.

    ``initial_params`` warm-starts the model (a dict of tensors or numpy
    arrays with the reference's keys and layouts).  ``tiers=S > 1`` runs
    the two-tier round of ``repro_torch.fl.hier`` (S sub-communities, then
    a second-level committee round); ``tiers=1`` is the flat round.
    ``mesh`` and ``schedule="async"`` are the reference's sharded and
    asynchronous engines; they raise ``NotImplementedError`` until
    ported."""
    cfg = build_config(cfg, baseline=baseline)
    if tiers is not None:
        if isinstance(cfg, FLConfig):
            raise ValueError(
                "tiers applies to the BFLC committee runtime only: the "
                "committee-free baselines have no consensus to tier"
            )
        cfg = dataclasses.replace(cfg, tiers=int(tiers))
    if isinstance(cfg, FLConfig):
        return FLTrainer(adapter, dataset, cfg, initial_params=initial_params,
                         stages=stages, mesh=mesh, schedule=schedule,
                         device=device)
    return BFLCRuntime(adapter, dataset, cfg, initial_params=initial_params,
                       stages=stages, mesh=mesh, schedule=schedule,
                       device=device)
