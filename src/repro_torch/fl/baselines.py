"""Baselines the paper compares against (§V): Basic FL (FedAvg), CwMed, and
stand-alone centralized training.

Port of ``repro/fl/baselines.py``.  The federated baselines are the same
``repro_torch.fl.pipeline`` round the BFLC runtime uses, with every
committee stage a no-op (uniform sampler, accept-all validator, pack-all
packer, no elector or rewarder), so BFLC-vs-baseline comparisons share one
code path.  ``FLConfig`` has no ``use_kernels``: the baselines aggregate
with the plain reductions, as the reference's do.

Both entry points run on ``device`` ("cuda" by default; they raise when
CUDA is absent unless ``device="cpu"``).  ``FLTrainer`` takes
``schedule="async"`` (``repro_torch.fl.async_engine``) and
``mesh=make_round_mesh(n)``, which trains each cohort with the sharded
trainer (``repro_torch.fl.sharded``).  Each round's spans are recorded
(``repro_torch.spans``), as in ``BFLCRuntime``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch
from torch.func import grad

from repro_torch.data.synthetic import FederatedDataset
from repro_torch.device import resolve_device
from repro_torch.fl.adapter import ModelAdapter
from repro_torch.fl.async_engine import AsyncRoundPipeline
from repro_torch.fl.client import (
    DeviceCommunity,
    make_eval_fn,
    make_local_train_fn,
    make_sharded_local_train_fn,
)
from repro_torch.fl.pipeline import (
    RoundContext,
    baseline_stage_names,
    build_pipeline,
)
from repro_torch.fl.runtime import check_schedule_and_mesh, runtime_device
from repro_torch.spans import Recorder, recording
from repro_torch.tree import tree_map


@dataclass
class FLConfig:
    active_proportion: float = 0.1
    local_steps: int = 20
    local_batch: int = 32
    local_lr: float = 0.02
    momentum: float = 0.9
    aggregation: str = "fedavg"          # "fedavg" -> Basic FL; "cwmed" -> CwMed
    size_weighted: bool = True
    malicious_fraction: float = 0.0
    attack: str = "gaussian"
    attack_sigma: float = 1.0
    seed: int = 0


def _on_device(params, device: torch.device):
    return tree_map(lambda t: torch.as_tensor(t).to(device), params)


class FLTrainer:
    """Basic FL / CwMed: central-server aggregation, no validation.

    The same stage pipeline as ``BFLCRuntime`` with the committee stages
    as no-ops; swap any stage via ``stages={kind: name-or-callable}``."""

    def __init__(self, adapter: ModelAdapter, dataset: FederatedDataset,
                 cfg: FLConfig, initial_params=None,
                 stages: Optional[Dict[str, object]] = None, mesh=None,
                 schedule: str = "sequential", device="cuda"):
        check_schedule_and_mesh(mesh, schedule)
        self.device = runtime_device(device, mesh)
        self.recorder = Recorder(self.device)
        self.adapter = adapter
        self.data = dataset
        self.cfg = cfg
        self.rng = np.random.default_rng(cfg.seed)
        n = dataset.num_clients
        self.malicious = set(
            self.rng.choice(
                n, int(round(cfg.malicious_fraction * n)), replace=False
            ).tolist()
        )
        if initial_params is None:
            initial_params = adapter.init(torch.Generator().manual_seed(cfg.seed))
        self.params = _on_device(initial_params, self.device)
        self.community = DeviceCommunity(dataset, self.device)
        self._local_train = make_local_train_fn(adapter, cfg.local_lr, cfg.momentum)
        self._eval = make_eval_fn(adapter, self.device)
        self.mesh = mesh
        self._sharded_train = (None if mesh is None else
                               make_sharded_local_train_fn(
                                   adapter, cfg.local_lr, mesh, cfg.momentum))
        self.pipeline = build_pipeline(baseline_stage_names(mesh), stages,
                                       max_cohorts=1)
        self.schedule = schedule
        if schedule == "async":
            self.pipeline = AsyncRoundPipeline.from_pipeline(self.pipeline)
        self.accuracies: List[float] = []
        self.stage_timings: List[Dict[str, float]] = []
        self._round = 0

    def evaluate(self) -> float:
        return self._eval(self.params, self.data.test_images, self.data.test_labels)

    def run_round(self):
        ctx = RoundContext(
            cfg=self.cfg,
            rng=self.rng,
            adapter=self.adapter,
            data=self.data,
            params=self.params,
            round=self._round,
            device=self.device,
            malicious=self.malicious,
            community=self.community,
            local_train_fn=self._local_train,
            mesh=self.mesh,
            sharded_train_fn=self._sharded_train,
        )
        with recording(self.recorder):
            self.pipeline.run(ctx)
        self.params = ctx.new_params
        self.stage_timings.append(self.recorder.entry(ctx.timings))
        self._round += 1

    def run(self, rounds: int, eval_every: int = 5) -> List[float]:
        for r in range(rounds):
            self.run_round()
            if (r + 1) % eval_every == 0 or r == rounds - 1:
                self.accuracies.append(self.evaluate())
        return self.accuracies


def train_standalone(
    adapter: ModelAdapter,
    dataset: FederatedDataset,
    *,
    steps: int,
    batch: int = 64,
    lr: float = 0.05,
    momentum: float = 0.9,
    seed: int = 0,
    eval_every: int = 200,
    device="cuda",
):
    """Centralized momentum SGD on the merged dataset (the paper's upper
    bound).  Returns (params, test accuracies every ``eval_every`` steps
    and at the last)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    imgs, labels = dataset.merged_train()
    params = _on_device(adapter.init(torch.Generator().manual_seed(seed)), dev)
    evaluate = make_eval_fn(adapter, dev)
    loss_grad = grad(adapter.loss)
    mu = tree_map(torch.zeros_like, params)
    accs = []
    for s in range(steps):
        idx = rng.integers(0, len(labels), batch)
        x = torch.from_numpy(imgs[idx]).to(dev)
        y = torch.from_numpy(labels[idx]).to(dev)
        g = loss_grad(params, x, y)
        mu = tree_map(lambda m, gg: momentum * m + gg, mu, g)
        params = tree_map(lambda p, m: p - lr * m, params, mu)
        if (s + 1) % eval_every == 0 or s == steps - 1:
            accs.append(evaluate(params, dataset.test_images, dataset.test_labels))
    return params, accs
