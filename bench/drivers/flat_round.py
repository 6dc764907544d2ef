"""The flat sequential BFLC round: one chain, one community, the pipeline's
stages in turn on one device.

``set_up`` makes the community and the weights from the seed, builds the
port's runtime through ``repro_torch.api.build_runtime`` and runs the
traffic's checked rounds, recording at the stage boundaries what the
reference needs: the host rng's state before each draw, each cohort's
trainers and committee, the per-leaf norms of every trainer's update
(float64, on the device), the update rows that the score check samples
and those the packer stores, and the score matrix.  ``check`` runs after
the window: it reads the chain, runs the port's ``verify()``, frees the
runtime and has ``bench.reference.round`` judge the checked rounds.
``readings`` gives what the limits were set from (``bench/calibrate.py``).
"""
from __future__ import annotations

import copy
import gc
import time
from dataclasses import dataclass
from typing import Dict, List

import numpy as np
import torch

from bench.harness import note, synchronize
from bench.reference import round as judge_mod
from bench.reference.precision import Precision
from bench.reference.tree import flatten, paths, tree_map, unflatten

NUMBERS = judge_mod.NUMBERS
UPDATE_NUMBERS = ("update_gap", "update_gap_median")


def stream_seed(seed: int, stream: int) -> int:
    """A 63-bit seed of its own for each random stream of a run (the
    community, the weights) derived from the run's seed."""
    state = np.random.SeedSequence([seed % (1 << 64), stream]).generate_state(
        1, np.uint64)[0]
    return int(state) >> 1


def leaf_norms(trees) -> np.ndarray:
    """Update trees -> (P, leaves) float64 norms, leaves in chain order."""
    norms = torch.stack([
        torch.stack([torch.linalg.vector_norm(leaf, dtype=torch.float64)
                     for _, leaf in paths(tree)]) for tree in trees])
    return norms.cpu().numpy()


def host_row(tree) -> np.ndarray:
    return flatten(tree).cpu().numpy()


class Recorder:
    """Wraps the trainer, the validator and the packer of a sequential
    runtime while it runs the checked rounds.  The stages run as they
    are; the records are copies."""

    def __init__(self, rt, seed: int, check_rows: int):
        self.rt, self.seed, self.check_rows = rt, seed, check_rows
        self.rounds: List[dict] = []

    def __enter__(self):
        pipe, rec = self.rt.pipeline, self
        self._saved = pipe.local_trainer, pipe.validator, pipe.packer
        trainer, validator, packer = self._saved

        class Trainer:
            def __getattr__(self, attr):
                return getattr(trainer, attr)

            def __call__(self, ctx):
                state = copy.deepcopy(ctx.rng.bit_generator.state)
                trainer(ctx)
                rec.rounds[-1]["cohorts"].append({
                    "trainers": [int(i) for i in ctx.trainers],
                    "rng_train": state,
                    "committee": [int(j) for j in ctx.round_committee],
                    "rng_val": rec.rounds[-1]["rng_val"],
                    "norms": leaf_norms(ctx.cohort_updates),
                    "rows": {}})

        class Validator:
            def __getattr__(self, attr):
                return getattr(validator, attr)

            def prepare(self, ctx):
                rec.rounds.append({"round": ctx.round, "cohorts": [],
                                   "rng_val": copy.deepcopy(
                                       ctx.rng.bit_generator.state)})
                validator.prepare(ctx)

            def __call__(self, ctx):
                validator(ctx)
                cohort = rec.rounds[-1]["cohorts"][-1]
                cohort["scores"] = np.array(ctx.cohort_scores, dtype=np.float32)
                for r in judge_mod.sample_rows(
                        rec.seed, ctx.round, len(rec.rounds[-1]["cohorts"]) - 1,
                        len(ctx.cohort_updates), rec.check_rows):
                    cohort["rows"][int(r)] = host_row(ctx.cohort_updates[r])

        class Packer:
            def __getattr__(self, attr):
                return getattr(packer, attr)

            def __call__(self, ctx):
                packer(ctx)
                cohorts = rec.rounds[-1]["cohorts"]
                for u, tree in zip(ctx.packed_ids, ctx.packed_updates):
                    c = max(c for c, co in enumerate(cohorts)
                            if u in co["trainers"])
                    i = cohorts[c]["trainers"].index(u)
                    if i not in cohorts[c]["rows"]:
                        cohorts[c]["rows"][i] = host_row(tree)

        pipe.local_trainer, pipe.validator, pipe.packer = \
            Trainer(), Validator(), Packer()
        return self

    def __exit__(self, *exc):
        (self.rt.pipeline.local_trainer, self.rt.pipeline.validator,
         self.rt.pipeline.packer) = self._saved
        return False


@dataclass
class Setup:
    """A cell after set-up: the port's runtime past its checked rounds and
    what the reference needs to judge them."""

    spec: object
    family: object
    community: object
    init_host: object            # the weights handed to the port, on the host
    rt: object
    records: List[dict]
    dim: int


def set_up(spec, family, seed: int, device, hooks=None) -> Setup:
    """Makes the community and the weights from the seed, builds the port's
    runtime and runs the checked rounds under the recorder.  The device's
    peak memory counts from the runtime's build.  ``hooks`` (tests only)
    may swap a stage of the port's pipeline first: ``hooks(rt)``."""
    from repro_torch.api import build_runtime
    from repro_torch.data.synthetic import FederatedDataset

    traffic = spec.traffic
    t = time.perf_counter()
    g = torch.Generator(device=device).manual_seed(stream_seed(seed, 1))
    community = family.community(spec.config, stream_seed(seed, 0), device)
    t = note("community", t)
    init = family.weights(spec.config, community, g, device)
    init_host = tree_map(lambda a: a.detach().cpu().clone(), init)
    t = note("weights", t)
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    rt = build_runtime(
        family.program_adapter(spec.config),
        FederatedDataset(community.client_images, community.client_labels,
                         community.test_images, community.test_labels),
        dict(traffic["bflc"], seed=seed), initial_params=init,
        stages={"validator": traffic["validator"]}, device=device)
    del init
    dim = rt.chain.codec.dim
    t = note("runtime", t)
    if hooks is not None:
        hooks(rt)
    with Recorder(rt, seed, traffic["check_rows"]) as rec:
        for _ in range(traffic["checked_rounds"]):
            rt.run_round()
            synchronize(device)
            stages = " ".join(f"{k} {v:.3f}" for k, v in rt.stage_timings[-1].items())
            t = note(f"checked round ({stages})", t)
    return Setup(spec, family, community, init_host, rt, rec.rounds, dim)


def chain_blocks(chain, with_payload: int) -> List[dict]:
    """The chain's blocks as the reference reads them: headers, and the
    payload leaves (host numpy, chain order) of the first ``with_payload``
    blocks."""
    out = []
    for blk in chain.blocks:
        b = {key: getattr(blk, key) for key in
             ("index", "kind", "round", "prev_hash", "payload_digest", "hash",
              "uploader", "score", "encoded")}
        b["payload"] = None
        if blk.index < with_payload and blk.payload is not None:
            b["payload"] = [(p, leaf.detach().cpu().numpy()
                             if isinstance(leaf, torch.Tensor) else np.asarray(leaf))
                            for p, leaf in paths(blk.payload)]
        out.append(b)
    return out


def release(setup: Setup, device):
    """Reads the chain (headers; payloads of the checked rounds), runs the
    port's ``verify()`` and frees the runtime.  Returns (blocks,
    verify_ok)."""
    traffic = setup.spec.traffic
    checked = traffic["checked_rounds"]
    blocks = chain_blocks(setup.rt.chain,
                          checked * (traffic["bflc"]["k_updates"] + 1) + 1)
    verify_ok = setup.rt.chain.verify()
    setup.rt = None
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    return blocks, verify_ok


def make_judge(setup: Setup, seed: int, device) -> judge_mod.RoundJudge:
    spec = setup.spec
    return judge_mod.RoundJudge(
        setup.family.REFERENCE(spec.config),
        (setup.community.client_images, setup.community.client_labels),
        tree_map(lambda a: a.to(device), setup.init_host),
        dict(spec.traffic["bflc"], check_rows=spec.traffic["check_rows"]),
        seed, device)


def judge(checker: judge_mod.RoundJudge, records, blocks, verify_ok: bool,
          k: int) -> Dict[str, float]:
    """The numbers that decide ``correct``: the worst gap and the total
    count of mismatches over the checked rounds."""
    numbers = dict.fromkeys(NUMBERS, 0.0)
    by_index = {b["index"]: b for b in blocks}
    for rec in records:
        for key, value in checker.judge_round(rec, by_index).items():
            numbers[key] = max(numbers[key], value) if key.endswith("_gap") \
                else numbers[key] + value
    numbers["chain_mismatch"] += judge_mod.chain_mismatch(blocks, k) \
        + (0 if verify_ok else 1)
    return numbers


def check(setup: Setup, seed: int, device) -> Dict[str, float]:
    """After the window: the chain read and verified, the runtime freed,
    the checked rounds judged."""
    t = time.perf_counter()
    blocks, verify_ok = release(setup, device)
    t = note("chain read and verified", t)
    numbers = judge(make_judge(setup, seed, device), setup.records, blocks,
                    verify_ok, setup.spec.traffic["bflc"]["k_updates"])
    note("reference", t)
    return numbers


def readings(setup: Setup, seed: int, device) -> dict:
    """The readings that the limits are set from, for one seed:

    * ``port``: the port, as every run judges it (the lower readings);
    * ``f32_reference``: the reference in float32 with TF32 off in the
      port's place (its updates, against the float64 reference);
    * ``control``: the reference in TF32, the nearest precision below the
      configurations' float32 with TF32 off, in the port's place: its
      updates (``update_gap``) and its scores of the sampled rows
      (``score_gap``, against the float32 reference's logits);
    * ``half_batch``: the reference trained on the first half of each
      local batch (a fault: half of the batch left out, the mean over the
      rest);
    * ``score_altered``: the port's score matrix with one sampled entry
      moved by one hit (a fault: an answer altered where it is produced).

    A state left unchanged (an update or a model change of 0) reads 1 by
    the measure of ``update_gap`` and ``model_gap``, and needs no run."""
    k = setup.spec.traffic["bflc"]["k_updates"]
    blocks, verify_ok = release(setup, device)
    checker = make_judge(setup, seed, device)
    out = {"port": judge(checker, setup.records, blocks, verify_ok, k),
           "f32_reference": dict.fromkeys(UPDATE_NUMBERS, 0.0),
           "control": dict.fromkeys(UPDATE_NUMBERS + ("score_gap",), 0.0),
           "half_batch": dict.fromkeys(UPDATE_NUMBERS, 0.0),
           "score_altered": {"score_gap": 0.0}}
    by_index = {b["index"]: b for b in blocks}
    f64 = Precision("f64", device)
    f32, tf32 = Precision("f32", device), Precision("tf32", device)

    def top(side, key, value):
        out[side][key] = max(out[side][key], value)

    for rec in setup.records:
        params_flat = judge_mod.payload_flat(by_index[rec["round"] * (k + 1)],
                                             device)
        params = unflatten(params_flat, checker.init)
        for c, cohort in enumerate(rec["cohorts"]):
            want = checker.norms(checker.reference_updates(params, cohort, f64))
            for side, prec, half in (("f32_reference", f32, False),
                                     ("control", tf32, False),
                                     ("half_batch", f32, True)):
                upd = checker.reference_updates(params, cohort, prec, half)
                gaps = judge_mod.row_gaps(checker.norms(upd), want)
                top(side, "update_gap", float(gaps.max()))
                top(side, "update_gap_median", float(np.median(gaps)))
                if side == "control":
                    ctrl = {int(r): upd[r] for r in checker.rows_of(rec, c)}
                del upd
            rows = sorted(ctrl)
            vx, vy = checker.member_rows(cohort)
            ctrl_scores = checker.scores(params_flat, ctrl, rows, vx, vy, tf32)
            top("control", "score_gap", checker.score_gap(
                params_flat, ctrl, ctrl_scores, rows, vx, vy))
            prog = {r: torch.from_numpy(cohort["rows"][r]).to(device)
                    for r in rows}
            altered = np.array(cohort["scores"][rows], np.float32)
            n = vy[0].numel()
            altered[0, 0] += -1.0 / n if altered[0, 0] >= 0.5 else 1.0 / n
            top("score_altered", "score_gap", checker.score_gap(
                params_flat, prog, altered, rows, vx, vy))
            del ctrl, prog
    return out
