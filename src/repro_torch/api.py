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
    arrays with the reference's keys and layouts).

    ``mesh`` (``repro_torch.launch.mesh.make_round_mesh(n)``, on each of
    the n ranks of a process group) selects the sharded round engine
    (``repro_torch.fl.sharded``): every rank runs the same host pipeline
    from the same seed, while local training AND committee validation
    split the cohort's clients over the ranks (``local_sgd_sharded`` /
    ``committee_sharded``: the P x Q score matrix is computed in P-blocks
    and gathered, equal to the single-device scores), and with
    ``quantize_chain=True`` packing and aggregation run D-sharded
    (``top_k_int8_sharded`` / ``fused_int8_sharded``) and the fused
    score-from-int8 validators (``committee_int8`` /
    ``committee_int8_sharded``) become available.  ``stages`` still
    overrides any stage by name or callable.

    ``tiers=S > 1`` runs the two-tier round of ``repro_torch.fl.hier`` (S
    sub-communities, then a second-level committee round); ``tiers=1`` is
    the flat round.

    ``schedule="async"`` runs the same stages under the asynchronous round
    engine (``repro_torch.fl.async_engine``): each cohort's training is
    dispatched to the card while the host finishes the previous cohort's
    committee work (in a tiered round, slice s+1 trains while slice s
    sub-aggregates).  Host rng draws and chain appends keep the sequential
    order, so the results are held bit-identical to
    ``schedule="sequential"``: the same RoundLogs, committees, chain
    payloads and params."""
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
