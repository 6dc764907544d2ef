"""The streamed LM round: the flat sequential BFLC round of a model whose
cohort of f32 updates would not fit the card, each client's update
quantized into its int8 row as it is trained.

``set_up`` refuses first a program that cannot stream the round
(``repro_torch.fl.pipeline.streams_int8``), then makes the community and
the weights from the seed (the streams of ``flat_round``), builds the
port's runtime through ``repro_torch.api.build_runtime`` and refuses,
before any round, one that would not stream the round.  It then runs the
traffic's checked rounds, recording at the stage boundaries what
``bench.reference.olmo_judge`` needs: the host rng's state before each
draw, each cohort's trainers, committee and score matrix, and, as each
trainer's update is made, its per-leaf float64 norms and this package's
int8 codec of it (on the host, until the packer has stored the round's
blobs).  Only the rows the score check samples (``check_rows`` a cohort)
are copied to the host whole, with their codecs.  The packer's
blobs are compared with their uploaders' codecs and copied to the host,
and each new model block is copied after its round: the chain prunes
them (``prune_keep_rounds``).  ``check`` runs after the window: it reads
the chain's headers, runs the port's ``verify()``, frees the runtime and
judges the checked rounds.  ``readings`` gives what the limits were set
from (``bench/calibrate.py``).
"""
from __future__ import annotations

import copy
import gc
import time
from dataclasses import dataclass, field
from typing import Dict, List

import numpy as np
import torch

from bench.drivers.flat_round import stream_seed
from bench.harness import note, synchronize
from bench.reference import round as judge_mod
from bench.reference.olmo_judge import (LM_NUMBERS, LMRoundJudge,
                                        chain_mismatch, codec, code_mismatch,
                                        leaf_norms)
from bench.reference.precision import Precision
from bench.reference.round import row_gaps, sample_rows
from bench.reference.tree import paths, tree_map

NUMBERS = LM_NUMBERS
NORM_NUMBERS = ("update_gap", "update_gap_median")
UPDATE_NUMBERS = NORM_NUMBERS + ("row_gap",)
HEADER = ("index", "kind", "round", "prev_hash", "payload_digest", "hash",
          "uploader", "score", "encoded")


def allocated_gb(device) -> float:
    return (torch.cuda.memory_allocated() / 1e9
            if torch.device(device).type == "cuda" else 0.0)


def host_payload(tree) -> list:
    """[(path, numpy leaf)] of a block payload, in chain order."""
    return [(p, leaf.detach().cpu().numpy() if isinstance(leaf, torch.Tensor)
             else np.asarray(leaf)) for p, leaf in paths(tree)]


class Recorder:
    """Wraps the per-client program, the trainer, the validator and the
    packer of a streamed runtime while it runs the checked rounds.  The
    stages run as they are; the records are copies."""

    def __init__(self, rt, seed: int, check_rows: int):
        self.rt, self.seed, self.check_rows = rt, seed, check_rows
        self.rounds: List[dict] = []
        self.payloads: Dict[int, list] = {}

    def cohort(self) -> dict:
        return self.rounds[-1]["cohorts"][-1]

    def __enter__(self):
        rt, pipe, rec = self.rt, self.rt.pipeline, self
        self._saved = (rt._client_train, pipe.local_trainer, pipe.validator,
                       pipe.packer)
        client_fn, trainer, validator, packer = self._saved

        def client(params, xs, ys):
            update = client_fn(params, xs, ys)
            cohort = rec.cohort()
            i = len(cohort["norms"])
            cohort["norms"].append(leaf_norms(update))
            cohort["codes_all"].append(codec(update))
            if i in cohort["sampled"]:
                cohort["rows"][i] = torch.cat(
                    [leaf.reshape(-1) for _, leaf in paths(update)]
                ).cpu().numpy()
                cohort["codes"][i] = cohort["codes_all"][i]
            return update

        class Trainer:
            def __getattr__(self, attr):
                return getattr(trainer, attr)

            def __call__(self, ctx):
                cohorts = rec.rounds[-1]["cohorts"]
                cohorts.append({
                    "trainers": [int(i) for i in ctx.trainers],
                    "rng_train": copy.deepcopy(ctx.rng.bit_generator.state),
                    "committee": [int(j) for j in ctx.round_committee],
                    "rng_val": rec.rounds[-1]["rng_val"],
                    "sampled": {int(r) for r in sample_rows(
                        rec.seed, ctx.round, len(cohorts), len(ctx.trainers),
                        rec.check_rows)},
                    "norms": [], "codes_all": [], "codes": {}, "rows": {}})
                trainer(ctx)
                cohort = rec.cohort()
                cohort["norms"] = np.stack(cohort["norms"])

        class Validator:
            def __getattr__(self, attr):
                return getattr(validator, attr)

            def prepare(self, ctx):
                rec.rounds.append({"round": ctx.round, "cohorts": [],
                                   "blob_mismatch": 0,
                                   "rng_val": copy.deepcopy(
                                       ctx.rng.bit_generator.state)})
                validator.prepare(ctx)

            def __call__(self, ctx):
                validator(ctx)
                rec.cohort()["scores"] = np.array(ctx.cohort_scores,
                                                  dtype=np.float32)

        class Packer:
            def __getattr__(self, attr):
                return getattr(packer, attr)

            def __call__(self, ctx):
                packer(ctx)
                chain, k = ctx.chain, ctx.chain.k
                cohorts = rec.rounds[-1]["cohorts"]
                for blk in chain.blocks[-k:]:
                    c = max(c for c, co in enumerate(cohorts)
                            if blk.uploader in co["trainers"])
                    i = cohorts[c]["trainers"].index(blk.uploader)
                    payload = host_payload(blk.payload)
                    rec.rounds[-1]["blob_mismatch"] += code_mismatch(
                        {p[0]: a for p, a in payload},
                        cohorts[c]["codes_all"][i])
                    rec.payloads[blk.index] = payload
                for co in cohorts:
                    co["codes_all"] = []

        rt._client_train = client
        pipe.local_trainer, pipe.validator, pipe.packer = \
            Trainer(), Validator(), Packer()
        return self

    def __exit__(self, *exc):
        rt, pipe = self.rt, self.rt.pipeline
        (rt._client_train, pipe.local_trainer, pipe.validator,
         pipe.packer) = self._saved
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
    payloads: Dict[int, list] = field(default_factory=dict)


def set_up(spec, family, seed: int, device, hooks=None) -> Setup:
    """Makes the community and the weights from the seed, builds the port's
    runtime, refuses one that does not stream, and runs the checked rounds
    under the recorder.  The device's peak memory counts from the
    runtime's build.  ``hooks`` (tests only) may swap a stage first."""
    from repro_torch.api import build_runtime
    from repro_torch.data.synthetic import FederatedDataset
    try:
        from repro_torch.fl.pipeline import streams_int8
    except ImportError as e:
        raise RuntimeError(
            "the program does not stream the per-client round: the "
            "cohort's f32 updates of this model do not fit the device") from e

    traffic = spec.traffic
    t = time.perf_counter()
    g = torch.Generator(device=device).manual_seed(stream_seed(seed, 1))
    community = family.community(spec.config, stream_seed(seed, 0), device)
    t = note(f"community ({community.rows} rows)", t)
    init = family.weights(spec.config, community, g, device)
    init_host = tree_map(lambda a: a.detach().cpu().clone(), init)
    t = note("weights", t)
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    adapter = family.program_adapter(spec.config)
    rt = build_runtime(
        adapter,
        FederatedDataset(community.client_images, community.client_labels,
                         community.test_images, community.test_labels),
        dict(traffic["bflc"], seed=seed), initial_params=init,
        stages={"validator": traffic["validator"]}, device=device)
    del init
    if not streams_int8(adapter, rt.cfg, rt.pipeline, rt.mesh):
        raise RuntimeError(
            "the runtime does not stream the per-client round "
            "(streams_int8): the cohort's f32 updates of this model do not "
            "fit the device")
    dim = rt.chain.codec.dim
    t = note("runtime", t)
    if hooks is not None:
        hooks(rt)
    payloads = {0: host_payload(init_host)}
    with Recorder(rt, seed, traffic["check_rows"]) as rec:
        for _ in range(traffic["checked_rounds"]):
            rt.run_round()
            synchronize(device)
            r, model = rt.chain.latest_model()
            payloads[rt.chain.model_index(r)] = host_payload(model)
            del model
            stages = " ".join(f"{k} {v:.3f}" for k, v in rt.stage_timings[-1].items())
            scores = np.concatenate([c["scores"].ravel()
                                     for c in rec.rounds[-1]["cohorts"]])
            t = note(f"checked round ({stages}; {len(np.unique(scores))} "
                     f"distinct scores, largest {scores.max():.6f})", t)
    payloads.update(rec.payloads)
    return Setup(spec, family, community, init_host, rt, rec.rounds, dim,
                 payloads)


def release(setup: Setup, device):
    """Reads the chain's headers, runs the port's ``verify()`` and frees
    the runtime.  Returns (headers, verify_ok)."""
    headers = [{key: getattr(blk, key) for key in HEADER}
               for blk in setup.rt.chain.blocks]
    verify_ok = setup.rt.chain.verify()
    setup.rt = None
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    return headers, verify_ok


def make_judge(setup: Setup, seed: int, device) -> LMRoundJudge:
    spec = setup.spec
    return LMRoundJudge(
        setup.family.REFERENCE(spec.config),
        (setup.community.client_images, setup.community.client_labels),
        setup.init_host,
        dict(spec.traffic["bflc"], check_rows=spec.traffic["check_rows"]),
        seed, device)


def blocks_of(headers, payloads) -> Dict[int, dict]:
    return {h["index"]: dict(h, payload=payloads.get(h["index"]))
            for h in headers}


def judge(checker: LMRoundJudge, setup: Setup, headers, verify_ok: bool,
          k: int) -> Dict[str, float]:
    """The numbers that decide ``correct``: the worst gap and the total
    count of mismatches over the checked rounds."""
    numbers = dict.fromkeys(NUMBERS, 0.0)
    blocks = blocks_of(headers, setup.payloads)
    for rec in setup.records:
        for key, value in checker.judge_round(rec, blocks).items():
            numbers[key] = max(numbers[key], value) if key.endswith("_gap") \
                else numbers[key] + value
    numbers["chain_mismatch"] += chain_mismatch(headers, setup.payloads, k) \
        + (0 if verify_ok else 1)
    return numbers


def check(setup: Setup, seed: int, device) -> Dict[str, float]:
    """After the window: the chain's headers read and verified, the runtime
    freed, the checked rounds judged."""
    t = time.perf_counter()
    headers, verify_ok = release(setup, device)
    t = note(f"chain read and verified ({allocated_gb(device):.3f} GB still "
             "allocated)", t)
    numbers = judge(make_judge(setup, seed, device), setup, headers,
                    verify_ok, setup.spec.traffic["bflc"]["k_updates"])
    note("reference", t)
    return numbers


def readings(setup: Setup, seed: int, device) -> dict:
    """The readings that the limits are set from, for one seed:

    * ``port``: the port, as every run judges it (the lower readings);
    * ``f32_reference``: the reference in float32 with TF32 off in the
      port's place (its updates, against the float64 reference);
    * ``control``: the reference in TF32, the nearest precision below the
      configuration's float32 with TF32 off, in the port's place: its
      updates (``update_gap`` against the float64 reference, ``row_gap``
      against the float32 reference, as the port's) and its scores of the
      sampled rows (``score_gap``, against the float32 reference's
      logits);
    * ``half_batch``: the reference trained on the first half of each
      local batch (a fault: half of the batch left out);
    * ``score_altered``: the port's score matrix with one sampled entry
      moved by one hit (a fault: an answer altered where it is produced).

    A state left unchanged reads 1 by the measure of ``update_gap`` and
    ``model_gap``, and needs no run."""
    k = setup.spec.traffic["bflc"]["k_updates"]
    t = time.perf_counter()
    headers, verify_ok = release(setup, device)
    checker = make_judge(setup, seed, device)
    t = note(f"released ({allocated_gb(device):.3f} GB allocated)", t)
    out = {"port": judge(checker, setup, headers, verify_ok, k),
           "f32_reference": dict.fromkeys(NORM_NUMBERS, 0.0),
           "control": dict.fromkeys(UPDATE_NUMBERS + ("score_gap",), 0.0),
           "half_batch": dict.fromkeys(UPDATE_NUMBERS, 0.0),
           "score_altered": {"score_gap": 0.0}}
    t = note(f"port judged ({allocated_gb(device):.3f} GB allocated)", t)
    blocks = blocks_of(headers, setup.payloads)
    f64 = Precision("f64", device)
    f32, tf32 = Precision("f32", device), Precision("tf32", device)

    def top(side, key, value):
        out[side][key] = max(out[side][key], value)

    for rec in setup.records:
        params_flat = checker.params_of(blocks[rec["round"] * (k + 1)]["payload"])
        params = checker.unflatten(params_flat)
        for c, cohort in enumerate(rec["cohorts"]):
            rows = [int(r) for r in checker.rows_of(rec, c)]
            want = checker.reference_norms(params, cohort, f64)
            kept, ctrl = {}, {}
            for side, prec, half in (("f32_reference", f32, False),
                                     ("control", tf32, False),
                                     ("half_batch", f32, True)):
                norms = []
                for i, upd in checker.each_update(params, cohort, prec, half):
                    norms.append(leaf_norms(upd))
                    if i in rows and side == "f32_reference":
                        kept[i] = torch.cat([leaf.reshape(-1)
                                             for _, leaf in paths(upd)])
                    elif i in rows:
                        top(side, "row_gap", checker.leaf_dist(upd, kept[i]))
                    if side == "control" and i in rows:
                        ctrl[i] = codec(upd)
                    del upd
                gaps = row_gaps(np.stack(norms), want)
                top(side, "update_gap", float(gaps.max()))
                top(side, "update_gap_median", float(np.median(gaps)))
                t = note(f"{side} of round {rec['round']} "
                         f"({allocated_gb(device):.3f} GB allocated)", t)
            vx, vy = checker.member_rows(cohort)
            ctrl_scores = checker.scores(params_flat, ctrl, rows, vx, vy, tf32)
            top("control", "score_gap", checker.score_gap(
                params_flat, ctrl, ctrl_scores, rows, vx, vy))
            altered = np.array(cohort["scores"][rows], np.float32)
            n = vy[0].numel()
            altered[0, 0] += -1.0 / n if altered[0, 0] >= 0.5 else 1.0 / n
            top("score_altered", "score_gap", checker.score_gap(
                params_flat, cohort["codes"], altered, rows, vx, vy))
            del ctrl, kept
            t = note(f"scores of round {rec['round']} "
                     f"({allocated_gb(device):.3f} GB allocated)", t)
    return out
