"""Judges BFLC rounds that the port ran, by working them out again.

For each checked round the benchmark hands over what it recorded at the
stage boundaries (the cohort's trainers and committee, the host rng's
state before the batches and the validation rows were drawn, the
trainers' updates and the committee's score matrix) and the chain's
blocks.  The reference then computes, with the model family's plain code:

* ``update_gap``: each trainer's update, trained in float64 from the
  round's model on the batches the rng draws; per leaf the gap between
  the norm of the port's update and the reference's, over the larger of
  the reference leaf's norm and the median leaf's; the worst leaf of the
  worst trainer of every cohort.  Leaves whose reference norm is under a
  thousandth of the median leaf's are left out: they move by round-off
  alone.  The port's norms are taken on the device when the trainer
  stage ends, so one trainer off in a cohort of hundreds shows.
* ``update_gap_median``: the same, the median trainer of each cohort.
* ``score_gap``: for a sample of the cohort's rows drawn from the seed
  (``sample_rows``), the candidate
  model (round model + the int8 view of the port's update) scored by the
  reference on every member's rows.  An accuracy is a count of argmax
  hits; the number is the least logit margin, over the largest |logit|
  of the member's rows, by which the reference's logits would have to
  move to give the port's count.
* ``packed_mismatch``: median consensus over the committee (relative
  threshold over the running mean of accepted medians) and the top k,
  from the port's score matrix, against the uploaders and scores of the
  round's update blocks.
* ``blob_mismatch``: int8 lanes and scales of each stored update block
  that differ from the codec applied to the port's update of its
  uploader.
* ``model_gap``: the next model block against the round's model plus the
  score-weighted mean of the stored blocks, dequantized in float64; per
  leaf the gap of the norms of the change, as ``update_gap``.
* ``chain_mismatch``: blocks whose hash, payload digest, link or kind is
  not what the chain's rules give, the genesis block if it is not the
  weights the benchmark handed over, and 1 if the port's ``verify()``
  fails.

Steps the reference cannot take alone it takes from the port's state, and
the stage that made that state is checked by its own number: a round's
model is the port's previous model block (``model_gap``), the candidates
and the blocks come from the port's updates (``update_gap``), the
consensus from the port's scores (``score_gap``).
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from bench.reference import chain as chain_ref
from bench.reference.precision import Precision
from bench.reference.tree import flatten, layout, unflatten

NUMBERS = ("update_gap", "update_gap_median", "score_gap", "model_gap",
           "blob_mismatch", "packed_mismatch", "chain_mismatch")
LEAF_FLOOR = 1e-3        # of the median leaf's norm: leaves moved by round-off


def replay_draws(state: dict, sizes: List[int], steps: int, batch: int):
    """The row indices the runtime's host rng drew for each client, in
    order: ``integers(0, n_i, (steps, batch))`` from ``state``."""
    rng = np.random.default_rng()
    rng.bit_generator.state = state
    return [rng.integers(0, n, (steps, batch)) for n in sizes]


def sample_rows(seed: int, t: int, c: int, rows: int, n: int) -> np.ndarray:
    """The rows of round t's cohort c whose scores the reference checks: n
    of ``rows``, drawn from the run's seed."""
    rng = np.random.default_rng([seed % (1 << 64), t, c])
    return np.sort(rng.choice(rows, min(rows, n), replace=False))


def flat_norms(rows: torch.Tensor, layout) -> np.ndarray:
    """(P, D) rows -> (P, leaves) float64 norms of each leaf's lanes."""
    return torch.stack([rows[:, lo:hi].double().norm(dim=1)
                        for _, _, lo, hi in layout], dim=1).cpu().numpy()


def row_gaps(got: np.ndarray, want: np.ndarray) -> np.ndarray:
    """Each row's worst leaf: | |got_leaf| - |want_leaf| | over the larger of
    |want_leaf| and the row's median leaf norm, leaves under LEAF_FLOOR of
    the median left out.  got, want: (P, leaves) norms."""
    med = np.median(want, axis=1, keepdims=True)
    den = np.maximum(want, med)
    diff = np.abs(got - want)
    gap = np.divide(diff, den, out=np.where(diff > 0, np.inf, 0.0),
                    where=den > 0)
    return np.where(want >= LEAF_FLOOR * med, gap, 0.0).max(axis=1)


def count_gap(margins: torch.Tensor, count: int) -> float:
    """The least e with #(m > e) <= count <= #(m >= -e): how far the margins
    would move to give ``count`` hits."""
    m = margins.flatten().double().sort(descending=True).values
    n = m.numel()
    e = 0.0
    if count > 0:
        e = max(e, float(-m[count - 1]))
    if count < n:
        e = max(e, float(m[count]))
    return e


def label_margins(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """logit of the label minus the best other logit."""
    top = logits.topk(2, dim=-1)
    lab = logits.gather(-1, labels.long()[..., None])[..., 0]
    best_other = torch.where(top.indices[..., 0] == labels.long(),
                             top.values[..., 1], top.values[..., 0])
    return lab - best_other


def consensus(rows, threshold: float, k: int):
    """rows: [(uploader, [member scores])] in validation order -> the k
    packed (uploader, median): the running-mean rule, the top k accepted
    by median (stable), the best record when none is accepted, the first
    repeated to fill k."""
    accepted, records = [], []
    for uploader, scores in rows:
        med = float(np.median([float(s) for s in scores]))
        ok = not accepted or med >= threshold * float(np.mean(accepted))
        if ok:
            accepted.append(med)
        records.append((uploader, med, ok))
    top = sorted([r for r in records if r[2]], key=lambda r: -r[1])[:k]
    if not top:
        top = sorted(records, key=lambda r: -r[1])[:1]
    while len(top) < k:
        top.append(top[0])
    return [(u, med) for u, med, _ in top]


class RoundJudge:
    """``model``: the family's reference (``train``, ``logits``, ``batch``);
    ``data``: (client rows, client labels) as handed to the port;
    ``init``: the weights handed to the port (a tree of tensors)."""

    def __init__(self, model, data, init, traffic: dict, seed: int, device):
        self.model, self.data, self.traffic = model, data, traffic
        self.device = torch.device(device)
        self.init = init
        self.init_flat = flatten(init).to(self.device)
        self.layout = layout(init)
        self.dim = self.layout[-1][3]
        self.seed = seed
        self.sizes = [len(y) for y in data[1]]

    # -- training ------------------------------------------------------
    def batches(self, ids, state, steps, batch):
        draws = replay_draws(state, [self.sizes[i] for i in ids], steps, batch)
        return self.model.batch(self.data, ids, draws, self.device)

    def reference_updates(self, params, cohort, prec: Precision,
                          half: bool = False) -> torch.Tensor:
        t = self.traffic
        xs, ys = self.batches(cohort["trainers"], cohort["rng_train"],
                              t["local_steps"], t["local_batch"])
        if half:    # a fault: half of each batch left out
            b = xs.shape[2] // 2
            xs, ys = xs[:, :, :b], ys[:, :, :b]
        with prec.scope():
            return self.model.train(params, xs, ys, t["local_lr"],
                                    t["momentum"], prec)

    def norms(self, rows: torch.Tensor) -> np.ndarray:
        return flat_norms(rows, self.layout)

    # -- scoring -------------------------------------------------------
    def rows_of(self, rec: dict, c: int) -> np.ndarray:
        return sample_rows(self.seed, rec["round"], c,
                           len(rec["cohorts"][c]["trainers"]),
                           self.traffic["check_rows"])

    def candidate(self, params_flat, update_row):
        q, s = chain_ref.quantize(update_row[None].float())
        flat = (params_flat.double()
                + chain_ref.dequantize(q, s, self.dim)[0]).float()
        return unflatten(flat, self.init)

    def member_rows(self, cohort):
        vx, vy = self.batches(cohort["committee"], cohort["rng_val"], 1,
                              self.traffic["val_batch"])
        return vx[:, 0], vy[:, 0]          # (Q, vb, ...)

    def member_logits(self, cand, vx, prec: Precision) -> torch.Tensor:
        """The candidate's logits on every member's rows: (Q, vb, ..., C)."""
        Q, vb = vx.shape[0], vx.shape[1]
        lg = self.model.logits(cand, vx.reshape(Q * vb, *vx.shape[2:]), prec)
        return lg.reshape(Q, vb, *lg.shape[1:])

    def scores(self, params_flat, updates, rows, vx, vy, prec: Precision):
        """The side's accuracies at ``rows`` x every member, computed by the
        reference in ``prec`` (the control's scorer).  ``updates``: row
        index -> update row."""
        out = np.zeros((len(rows), vx.shape[0]), np.float32)
        with prec.scope(), torch.no_grad():
            for a, r in enumerate(rows):
                lg = self.member_logits(self.candidate(params_flat, updates[r]),
                                        vx, prec)
                hits = (lg.argmax(-1) == vy.long()).double()
                out[a] = hits.flatten(1).mean(1).cpu().numpy()
        return out

    def score_gap(self, params_flat, updates, scores, rows, vx, vy) -> float:
        """``scores[a, j]``: the judged side's accuracy of row rows[a] on
        member j; ``updates``: row index -> update row."""
        worst = 0.0
        prec = Precision("f32", self.device)
        with prec.scope(), torch.no_grad():
            for a, r in enumerate(rows):
                lg = self.member_logits(self.candidate(params_flat, updates[r]),
                                        vx, prec)
                for j in range(vx.shape[0]):
                    m = label_margins(lg[j], vy[j])
                    count = int(round(float(scores[a, j]) * m.numel()))
                    scale = float(lg[j].abs().max())
                    worst = max(worst, count_gap(m, count) / scale)
        return worst

    # -- one round -----------------------------------------------------
    def judge_round(self, rec: dict, blocks: Dict[int, dict]) -> dict:
        """Every number of one recorded round of the port."""
        t, tr = rec["round"], self.traffic
        k = tr["k_updates"]
        model_t = blocks[t * (k + 1)]
        params_flat = payload_flat(model_t, self.device)
        params = unflatten(params_flat, self.init)
        out = dict.fromkeys(NUMBERS, 0.0)
        by_uploader = {}
        rows_scored = []
        f64 = Precision("f64", self.device)
        for c, cohort in enumerate(rec["cohorts"]):
            want = self.norms(self.reference_updates(params, cohort, f64))
            gaps = row_gaps(cohort["norms"], want)
            out["update_gap"] = max(out["update_gap"], float(gaps.max()))
            out["update_gap_median"] = max(out["update_gap_median"],
                                           float(np.median(gaps)))
            prog = {r: torch.from_numpy(row).to(self.device)
                    for r, row in cohort["rows"].items()}
            rows = self.rows_of(rec, c)
            vx, vy = self.member_rows(cohort)
            out["score_gap"] = max(out["score_gap"], self.score_gap(
                params_flat, prog, cohort["scores"][rows], rows, vx, vy))
            for i, u in enumerate(cohort["trainers"]):
                by_uploader[u] = (c, i)
                rows_scored.append((u, cohort["scores"][i].tolist()))
        # consensus from the port's scores
        packed = consensus(rows_scored, tr["accept_threshold"], k)
        ups = [blocks[t * (k + 1) + 1 + i] for i in range(k)]
        out["packed_mismatch"] = float(sum(
            (b["uploader"], b["score"]) != p for b, p in zip(ups, packed)))
        # the stored blocks against the codec on the port's updates
        for b in ups:
            c, i = by_uploader[b["uploader"]]
            upd = torch.from_numpy(rec["cohorts"][c]["rows"][i]).to(self.device)
            q, s = chain_ref.quantize(upd[None])
            pay = dict(b["payload"])
            out["blob_mismatch"] += float(
                (torch.from_numpy(pay[("q",)]).to(self.device) != q[0]).sum()
                + (torch.from_numpy(pay[("scales",)]).to(self.device) != s[0]).sum()
                + (int(pay[("d",)]) != self.dim))
        # the next model block against the score-weighted mean of the blocks
        w = np.array([p[1] for p in packed], np.float64)
        w = w / max(w.sum(), 1e-12)        # all-zero scores weigh nothing
        agg = torch.zeros(self.dim, dtype=torch.float64, device=self.device)
        for wi, b in zip(w, ups):
            pay = dict(b["payload"])
            q = torch.from_numpy(pay[("q",)]).to(self.device)[None]
            s = torch.from_numpy(pay[("scales",)]).to(self.device)[None]
            agg += wi * chain_ref.dequantize(q, s, self.dim)[0]
        nxt = payload_flat(blocks[(t + 1) * (k + 1)], self.device)
        want = (params_flat + agg.float()).double() - params_flat.double()
        got = nxt.double() - params_flat.double()
        out["model_gap"] = float(row_gaps(self.norms(got[None]),
                                          self.norms(want[None])).max())
        if t == 0:
            out["chain_mismatch"] += float((params_flat != self.init_flat).any())
        return out


def payload_flat(block: dict, device) -> torch.Tensor:
    return torch.cat([torch.from_numpy(np.asarray(a)).reshape(-1).float()
                      for _, a in block["payload"]]).to(device)


def chain_mismatch(blocks: List[dict], k: int) -> int:
    """Blocks whose link, hash, kind or (where the payload is given)
    digest breaks the chain's rules."""
    bad, prev = 0, "genesis"
    for i, b in enumerate(blocks):
        kind = "model" if i % (k + 1) == 0 else "update"
        ok = (b["index"] == i and b["prev_hash"] == prev and b["kind"] == kind
              and chain_ref.block_hash(b) == b["hash"])
        if b.get("payload") is not None:
            ok = ok and chain_ref.digest(b["payload"]) == b["payload_digest"]
        bad += not ok
        prev = b["hash"]
    return bad
