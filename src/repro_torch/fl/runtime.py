"""The BFLC round loop (paper Fig. 1): chain + committee consensus +
election + incentive.

Port of ``repro/fl/runtime.py``.  Each
round (1) samples active nodes, (2) trains the trainers locally from the
latest model block, (3) has the committee score every update on its own
data (median over members) and packs the top-k qualified updates as update
blocks, (4) aggregates them into the next model block, and (5) elects the
next committee and pays rewards.  With ``cfg.tiers = S > 1`` the round
is the two-tier one of ``repro_torch.fl.hier``: S sub-communities run
committee consensus on their own slices and a second-level committee round
judges the S sub-aggregates before the chain commit.  The host rng is
numpy, seeded from ``cfg.seed`` and drawn in the reference's order, so a
seed gives the same cohorts, committees and poison in both packages.

``BFLCRuntime`` runs on ``device`` ("cuda" by default; it raises when CUDA
is absent unless ``device="cpu"``).  ``schedule="async"`` runs the same
stages under ``repro_torch.fl.async_engine``, bit-identical to the
sequential engine.  ``mesh=make_round_mesh(n)`` runs the sharded engine
of ``repro_torch.fl.sharded`` on each of the n ranks: every rank builds
the same runtime from the same seed, and the device work is split over
the ranks.

Each round is recorded (``repro_torch.spans``): its ``stage_timings``
entry carries the round's spans and counters besides the stage seconds.

Where ``repro_torch.fl.pipeline.streams_int8`` holds at build, the rounds
stream each client's update into its int8 row as it is trained; they are
the batched program's bits.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.core import election as election_mod
from repro_torch.core.attacks import CollusionPolicy
from repro_torch.core.blockchain import Chain
from repro_torch.core.node import Node, NodeManager
from repro_torch.data.synthetic import FederatedDataset
from repro_torch.device import resolve_device
from repro_torch.fl.adapter import ModelAdapter
from repro_torch.fl.async_engine import AsyncRoundPipeline
from repro_torch.fl.client import (
    DeviceCommunity,
    make_eval_fn,
    make_local_train_fn,
    make_one_client_fn,
    make_score_from_int8_fn,
    make_score_matrix_fn,
    make_sharded_local_train_fn,
    make_sharded_score_from_int8_fn,
    make_sharded_score_matrix_fn,
)
from repro_torch.fl.hier import HierState, build_hier_pipeline
from repro_torch.fl.pipeline import (
    RoundContext,
    build_pipeline,
    default_stage_names,
    fill_committee,
    streams_int8,
)
from repro_torch.kernels.ops import (
    make_aggregate_quantized_sharded,
    make_quantize_stack_sharded,
)
from repro_torch.launch.mesh import RoundMesh
from repro_torch.spans import Recorder, recording
from repro_torch.tree import tree_leaves, tree_map


@dataclass
class BFLCConfig:
    active_proportion: float = 0.1
    committee_fraction: float = 0.4      # fraction of active nodes
    k_updates: int = 8                   # update blocks per round (chain k)
    local_steps: int = 20
    local_batch: int = 32
    local_lr: float = 0.02
    momentum: float = 0.9
    val_batch: int = 64
    election_method: str = election_mod.BY_SCORE
    accept_threshold: float = 0.5        # relative threshold (consensus stat)
    aggregation: str = "fedavg"
    trim: int = 1                        # trimmed_mean drop count per side
    weight_by_score: bool = True
    use_kernels: bool = False
    # store update blocks as int8 blobs (§IV.D) and aggregate straight from
    # them with the fused int8 kernel
    quantize_chain: bool = False
    # hierarchical rounds (repro_torch.fl.hier): tiers = S > 1 splits every
    # round into S sub-communities, each running committee consensus and
    # aggregation on its own slice, then a second-level committee round
    # over the S sub-aggregates; tiers = 1 is the flat pipeline
    tiers: int = 1
    malicious_fraction: float = 0.0
    attack: str = "gaussian"
    attack_sigma: float = 1.0
    collusion: bool = True
    kick_below: float = -1.0             # blacklist uploaders under this score
    # True = seat the round-0 committee from manager-vetted honest nodes
    # (§IV.C's precondition); False = uniform random
    honest_bootstrap: bool = True
    prune_keep_rounds: int = 0           # >0: prune old payloads each round
    reward_pool: float = 10.0
    seed: int = 0


@dataclass
class RoundLog:
    round: int
    trainers: int
    committee: int
    accepted_malicious: int
    packed_malicious: int
    mean_packed_score: float
    consensus_validations: int
    test_accuracy: Optional[float] = None


def check_schedule_and_mesh(mesh, schedule: str) -> None:
    """Refuse an unknown schedule, and a mesh that is not a round mesh."""
    if schedule not in ("sequential", "async"):
        raise ValueError(
            f"schedule={schedule!r} must be 'sequential' or 'async'"
        )
    if mesh is not None and not isinstance(mesh, RoundMesh):
        raise TypeError(
            f"mesh must be a round mesh from "
            f"repro_torch.launch.mesh.make_round_mesh(n), got {type(mesh)!r}"
        )


def runtime_device(device, mesh) -> torch.device:
    """The device a runtime runs on: ``device``, or with a mesh the rank's
    device, which ``device`` must not contradict."""
    dev = resolve_device(device)
    if mesh is None:
        return dev
    if dev.type != mesh.device.type or dev.index not in (None,
                                                         mesh.device.index):
        raise ValueError(f"device={device!r} contradicts the mesh's "
                         f"{mesh.device}")
    return mesh.device


def _check_config(cfg: BFLCConfig, mesh, schedule: str) -> None:
    check_schedule_and_mesh(mesh, schedule)
    if cfg.tiers < 1:
        raise ValueError(f"tiers={cfg.tiers} must be >= 1")
    if cfg.quantize_chain and not cfg.use_kernels:
        # the quantized chain path IS the fused kernel engine
        raise ValueError(
            "quantize_chain=True requires use_kernels=True "
            "(aggregation runs the fused int8 kernel)"
        )
    # a tiered round's final aggregation runs over S = tiers blocks, a flat
    # round's over k_updates: check the trim against the rows it will see
    agg_rows = cfg.tiers if cfg.tiers > 1 else cfg.k_updates
    if cfg.aggregation == "trimmed_mean" and not 0 <= 2 * cfg.trim < agg_rows:
        raise ValueError(
            f"trim={cfg.trim} invalid for {agg_rows} aggregated rows "
            f"(need 0 <= 2*trim < rows)"
        )


class BFLCRuntime:
    def __init__(
        self,
        adapter: ModelAdapter,
        dataset: FederatedDataset,
        cfg: BFLCConfig,
        initial_params=None,
        stages: Optional[Dict[str, object]] = None,
        mesh=None,
        schedule: str = "sequential",
        device="cuda",
    ):
        _check_config(cfg, mesh, schedule)
        self.device = runtime_device(device, mesh)
        self.recorder = Recorder(self.device)
        self.adapter = adapter
        self.data = dataset
        self.cfg = cfg
        self.rng = np.random.default_rng(cfg.seed)

        # node community: blacklist-mode manager, malicious ground truth
        self.manager = NodeManager()
        n = dataset.num_clients
        mal = set(
            self.rng.choice(
                n, int(round(cfg.malicious_fraction * n)), replace=False
            ).tolist()
        )
        for i in range(n):
            self.manager.join(
                Node(node_id=i, data_indices=np.arange(len(dataset.client_labels[i])),
                     is_malicious=i in mal)
            )

        # chain + genesis model block: a warm start (tensors or numpy
        # arrays, e.g. the reference's init) or the port's own seeded init
        if initial_params is None:
            initial_params = adapter.init(torch.Generator().manual_seed(cfg.seed))
        params = tree_map(lambda t: torch.as_tensor(t).to(self.device),
                          initial_params)
        self._codec = None
        if cfg.quantize_chain:
            from repro_torch.kernels.ops import Int8UpdateCodec

            self._codec = Int8UpdateCodec(params)
        # tiered rounds store S sub-aggregate update blocks and one tier-2
        # committee block per round
        tiered = cfg.tiers > 1
        self.chain = Chain(cfg.tiers if tiered else cfg.k_updates,
                           update_codec=self._codec, tier2_block=tiered)
        self.chain.append_model(params, 0)
        # flat update dimension D, for the tiered round's byte accounting
        self._dim = sum(leaf.numel() for leaf in tree_leaves(params))

        # the training shards on the device, for the rounds' batch draws
        self.community = DeviceCommunity(dataset, self.device)
        # batched helpers
        self._local_train = make_local_train_fn(adapter, cfg.local_lr, cfg.momentum)
        self._client_train = make_one_client_fn(adapter, cfg.local_lr,
                                                cfg.momentum)
        self._score_matrix = make_score_matrix_fn(adapter)
        # the int8 scorer (committee_int8) shares the chain codec's unravel
        # structure, so scored candidates decode exactly like stored blobs
        self._int8_score = (make_score_from_int8_fn(adapter, self._codec.unravel)
                            if cfg.quantize_chain else None)
        self._eval = make_eval_fn(adapter, self.device)
        self._collusion = CollusionPolicy()

        # sharded round engine: one program set per mesh, consumed by the
        # *_sharded stages through the context
        self.mesh = mesh
        self._sharded_train = self._sharded_score = None
        self._sharded_quantize = self._sharded_agg = None
        self._sharded_int8_score = None
        if mesh is not None:
            self._sharded_train = make_sharded_local_train_fn(
                adapter, cfg.local_lr, mesh, cfg.momentum)
            self._sharded_score = make_sharded_score_matrix_fn(adapter)
            if cfg.quantize_chain:
                self._sharded_quantize = make_quantize_stack_sharded(mesh)
                self._sharded_agg = make_aggregate_quantized_sharded(
                    mesh, cfg.aggregation, cfg.trim)
                self._sharded_int8_score = make_sharded_score_from_int8_fn(
                    adapter, self._codec.unravel)

        # fixed per-round sizes; committee size >= 3 (the median of two
        # scores is their mean, which one colluding member controls)
        n_active = max(2, int(round(n * cfg.active_proportion)))
        self.q_committee = max(3, int(round(n_active * cfg.committee_fraction)))
        self.p_trainers = max(cfg.k_updates, n_active - self.q_committee)

        # round-0 committee: honest bootstrap (§IV.C) or uniform random
        active = self.manager.sample_active(self.rng, cfg.active_proportion)
        pool = active
        if cfg.honest_bootstrap:
            honest = [i for i in active
                      if not self.manager.nodes[i].is_malicious]
            pool = honest or active
        self.committee: List[int] = sorted(
            self.rng.choice(pool, min(self.q_committee, len(pool)),
                            replace=False).tolist()
        )
        self.committee = fill_committee(self.manager, self.committee,
                                        self.q_committee)
        self._hier_inner = None
        if tiered:
            self.pipeline, self._hier_inner = build_hier_pipeline(cfg, mesh,
                                                                  stages)
        else:
            self.pipeline = build_pipeline(default_stage_names(cfg, mesh),
                                           stages)
        # the streamed round (repro_torch.fl.pipeline): each client's
        # update quantized into its int8 row as soon as it is trained
        self._streamed = streams_int8(adapter, cfg, self.pipeline, mesh)
        self.schedule = schedule
        if schedule == "async":
            # the same stage set under another runner: bit-identical
            # products, overlapped execution (repro_torch.fl.async_engine)
            self.pipeline = AsyncRoundPipeline.from_pipeline(self.pipeline)
        self.logs: List[RoundLog] = []
        self.stage_timings: List[Dict[str, float]] = []
        # per-round tiered memory accounting (tiers > 1): tiers,
        # peak_stack_bytes, flat_stack_bytes, max_slice_rows, t1_validations
        self.hier_logs: List[Dict[str, int]] = []

    # ------------------------------------------------------------------
    def global_params(self):
        return self.chain.latest_model()[1]

    def evaluate(self) -> float:
        return self._eval(self.global_params(), self.data.test_images,
                          self.data.test_labels)

    # ------------------------------------------------------------------
    def run_round(self, eval_test: bool = False) -> RoundLog:
        t, params = self.chain.latest_model()
        committee = [i for i in self.committee if i in self.manager.nodes]
        ctx = RoundContext(
            cfg=self.cfg,
            rng=self.rng,
            adapter=self.adapter,
            data=self.data,
            params=params,
            round=t,
            device=self.device,
            manager=self.manager,
            chain=self.chain,
            round_committee=committee,
            committee=list(committee),
            q_committee=self.q_committee,
            p_trainers=self.p_trainers,
            community=self.community,
            local_train_fn=self._local_train,
            client_train_fn=self._client_train,
            stream_int8=self._streamed,
            score_matrix_fn=self._score_matrix,
            int8_score_fn=self._int8_score,
            collusion=self._collusion,
            mesh=self.mesh,
            sharded_train_fn=self._sharded_train,
            sharded_quantize_fn=self._sharded_quantize,
            sharded_agg_fn=self._sharded_agg,
            sharded_score_fn=self._sharded_score,
            sharded_int8_score_fn=self._sharded_int8_score,
        )
        if self.cfg.tiers > 1:
            ctx.hier = HierState(tiers=self.cfg.tiers,
                                 inner_validator=self._hier_inner,
                                 dim=self._dim)
        with recording(self.recorder):
            self.pipeline.run(ctx)
        self.committee = ctx.committee
        if ctx.hier is not None:
            self.hier_logs.append({
                "tiers": ctx.hier.tiers,
                "peak_stack_bytes": ctx.hier.peak_stack_bytes,
                "flat_stack_bytes": ctx.hier.flat_stack_bytes,
                "max_slice_rows": ctx.hier.max_slice_rows,
                "t1_validations": ctx.hier.t1_validations,
            })

        mal_nodes = {i for i, nd in self.manager.nodes.items() if nd.is_malicious}
        log = RoundLog(
            round=t,
            trainers=len(ctx.trainers_total),
            committee=len(committee),
            accepted_malicious=sum(
                1 for r in ctx.consensus.accepted_records()
                if r.uploader in mal_nodes
            ) if ctx.consensus is not None else 0,
            packed_malicious=sum(1 for u in ctx.packed_ids if u in mal_nodes),
            mean_packed_score=(float(np.mean(ctx.packed_scores))
                               if ctx.packed_scores else 0.0),
            consensus_validations=(ctx.consensus.stats.validations
                                   if ctx.consensus is not None else 0),
            test_accuracy=self.evaluate() if eval_test else None,
        )
        self.logs.append(log)
        self.stage_timings.append(self.recorder.entry(ctx.timings))
        return log

    def run(self, rounds: int, eval_every: int = 5) -> List[RoundLog]:
        for r in range(rounds):
            self.run_round(eval_test=((r + 1) % eval_every == 0) or r == rounds - 1)
        return self.logs
