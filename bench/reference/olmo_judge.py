"""Judges the streamed LM round: ``bench.reference.round``'s numbers, worked
out one client at a time.

A model of a billion weights cannot have the cohort's updates side by
side, in the port or here.  So the benchmark records, as each trainer's
update is made, its per-leaf float64 norms, and the int8 codec of this
package (``bench.reference.chain.quantize``) applied to it, on the host;
the blobs stored on the chain and the model blocks are copied to the host
as the rounds make them (the chain prunes them).  The numbers are those of
``bench.reference.round``, with these differences:

* ``update_gap`` and ``update_gap_median``: each trainer trained by
  ``bench.reference.olmo.train_client`` in float64 on its own, its
  per-leaf norms compared with the port's (``row_gaps``); no (P, D) stack.
* ``row_gap`` (new here): for the rows the score check samples, whose
  f32 updates the benchmark copies to the host whole, the worst leaf's
  ``|port - reference| / |reference|`` against the reference's update
  computed in the configuration's own precision, float32 with TF32 off
  (leaves under ``LEAF_FLOOR`` of the median leaf's norm left out).  A
  leaf's norm moves little under noise that averages out over a billion
  lanes (TF32's included), its distance does not.  Against float64 the
  distance of any float32 update of this model is a few per cent (2.6-7.9
  % on an H100), whatever its products: two steps move a weight by a few
  dozen of its float32 ulps, so the rounding of the stored weights swamps
  the products' own error; against the float32 reference that rounding is
  the same on both sides.
* ``score_gap``: the candidate of a sampled row is the round's model plus
  the dequantized codec of the port's update (what the port's scorer
  rebuilds from the same row), scored in float32 with TF32 off.
* ``blob_mismatch``: the int8 lanes and scales of each stored block that
  differ from the codec applied to its uploader's update, counted as the
  packer stores it.
* ``model_gap``, ``packed_mismatch``, ``chain_mismatch``: as there, on the
  recorded blocks; a payload's digest is checked where it was recorded.
"""
from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List

import numpy as np
import torch

from bench.reference import chain as chain_ref
from bench.reference import olmo
from bench.reference.precision import Precision
from bench.reference.round import (LEAF_FLOOR, NUMBERS, RoundJudge,
                                   consensus, row_gaps)
from bench.reference.tree import paths

CODE_CHUNK = 1 << 26          # lanes quantized at a time (a multiple of 2048)
LM_NUMBERS = NUMBERS + ("row_gap",)


class Reference:
    """OLMo as the round judge calls it."""

    def __init__(self, cfg: dict):
        m = cfg["model"]
        self.cfg = {"num_heads": m["num_heads"], "norm_eps": m["norm_eps"],
                    "rope_theta": m["rope_theta"]}

    def train_client(self, params, xs, ys, lr, momentum, prec) -> dict:
        return olmo.train_client(params, xs, ys, self.cfg, lr, momentum, prec)

    def logits(self, params, x, prec) -> torch.Tensor:
        return olmo.logits(params, x, self.cfg, prec)

    def batch(self, data, ids, draws, device):
        tokens, targets = data
        xs = np.stack([tokens[i][d] for i, d in zip(ids, draws)])
        ys = np.stack([targets[i][d] for i, d in zip(ids, draws)])
        return torch.from_numpy(xs).to(device), torch.from_numpy(ys).to(device)


def leaf_norms(tree) -> np.ndarray:
    """(leaves,) float64 norms in chain order."""
    return np.array([float(torch.linalg.vector_norm(leaf, dtype=torch.float64))
                     for _, leaf in paths(tree)])


def codec(tree) -> tuple:
    """This package's int8 codec of an update tree, made on the tree's
    device a chunk of lanes at a time and returned on the host:
    (q (Dpad,) int8, scales (Dpad / 2048,) float32)."""
    leaves = [leaf.reshape(-1) for _, leaf in paths(tree)]
    D = sum(leaf.numel() for leaf in leaves)
    dpad = D + (-D) % chain_ref.BLOCK_D
    q = np.empty(dpad, np.int8)
    s = np.empty(dpad // chain_ref.BLOCK_D, np.float32)
    bounds = np.cumsum([0] + [leaf.numel() for leaf in leaves])
    for lo in range(0, D, CODE_CHUNK):       # the last chunk pads to dpad
        hi = min(lo + CODE_CHUNK, D)
        chunk = torch.cat([leaves[i][max(lo, a) - a:min(hi, b) - a]
                           for i, (a, b) in enumerate(zip(bounds[:-1],
                                                          bounds[1:]))
                           if a < hi and b > lo]).float()
        cq, cs = chain_ref.quantize(chunk[None])
        n = cq.shape[1]
        q[lo:lo + n] = cq[0].cpu().numpy()
        s[lo // chain_ref.BLOCK_D:(lo + n) // chain_ref.BLOCK_D] = \
            cs[0].cpu().numpy()
    return q, s


def code_mismatch(blob: dict, code: tuple) -> int:
    """Lanes and scales of a stored blob that differ from a codec."""
    q, s = code
    return int(np.count_nonzero(np.asarray(blob["q"]) != q)
               + np.count_nonzero(np.asarray(blob["scales"]) != s))


def digests(payloads: Dict[int, list]) -> Dict[int, str]:
    """``chain_ref.digest`` of each recorded payload, several at once
    (hashlib releases the interpreter while it hashes)."""
    with ThreadPoolExecutor(max_workers=8) as pool:
        keys = list(payloads)
        return dict(zip(keys, pool.map(lambda k: chain_ref.digest(payloads[k]),
                                       keys)))


class LMRoundJudge(RoundJudge):
    """``RoundJudge`` for the streamed LM round.  ``init``: the weights
    handed to the port (a tree of host tensors)."""

    def __init__(self, model, data, init, traffic: dict, seed: int, device):
        self.model, self.data, self.traffic = model, data, traffic
        self.device = torch.device(device)
        self.init = init
        self.layout_leaves = [path for path, _ in paths(init)]
        self.dim = sum(leaf.numel() for _, leaf in paths(init))
        self.seed = seed
        self.sizes = [len(y) for y in data[1]]

    # -- training ------------------------------------------------------
    def cohort_batches(self, cohort, half: bool = False):
        t = self.traffic
        xs, ys = self.batches(cohort["trainers"], cohort["rng_train"],
                              t["local_steps"], t["local_batch"])
        if half:    # a fault: half of each batch left out
            b = xs.shape[2] // 2
            xs, ys = xs[:, :, :b], ys[:, :, :b]
        return xs, ys

    def each_update(self, params, cohort, prec: Precision, half=False,
                    only=None):
        """Each trainer's reference update tree (of the rows ``only``, if
        given), one at a time."""
        t = self.traffic
        xs, ys = self.cohort_batches(cohort, half)
        with prec.scope():
            for i in range(xs.shape[0]):
                if only is None or i in only:
                    yield i, self.model.train_client(
                        params, xs[i], ys[i], t["local_lr"], t["momentum"],
                        prec)

    def reference_norms(self, params, cohort, prec: Precision) -> np.ndarray:
        """(P, leaves) norms of the trainers' reference updates, each
        dropped before the next is trained."""
        return np.stack([leaf_norms(upd) for _, upd
                         in self.each_update(params, cohort, prec)])

    def row_gap(self, params, cohort, rows: dict) -> float:
        """The worst ``leaf_dist`` of ``rows`` (row -> flat update) from
        the float32 reference's updates of those rows."""
        f32 = Precision("f32", self.device)
        return max((self.leaf_dist(rows[i], upd) for i, upd
                    in self.each_update(params, cohort, f32, only=rows)),
                   default=0.0)

    def leaves_of(self, x):
        """A tree's leaves, or a flat vector (host or device) cut into the
        chain's leaves, each flat on the device."""
        if not isinstance(x, (np.ndarray, torch.Tensor)):
            return [leaf.reshape(-1) for _, leaf in paths(x)]
        out, lo = [], 0
        for _, leaf in paths(self.init):
            hi = lo + leaf.numel()
            part = x[lo:hi]
            out.append(torch.from_numpy(part).to(self.device)
                       if isinstance(part, np.ndarray) else part)
            lo = hi
        return out

    def leaf_dist(self, got, want) -> float:
        """The worst leaf's |got - want| / |want| in float64, leaves whose
        norm is under ``LEAF_FLOOR`` of the median leaf's left out."""
        pairs = list(zip(self.leaves_of(got), self.leaves_of(want)))
        ref = np.array([float(w.double().norm()) for _, w in pairs])
        floor = LEAF_FLOOR * np.median(ref)
        return max((float((g.double() - w.double()).norm()) / n
                    for (g, w), n in zip(pairs, ref) if n >= floor and n > 0),
                   default=0.0)

    def unflatten(self, flat):
        """A flat vector as views in the weights' tree (no reference
        cycle, unlike ``bench.reference.tree.unflatten``'s recursive
        closure, which would hold the vector until the collector ran)."""
        return olmo._unflatten(self.init, [
            part.reshape(leaf.shape) for part, (_, leaf)
            in zip(self.leaves_of(flat), paths(self.init))])

    # -- scoring -------------------------------------------------------
    def candidate(self, params_flat, code):
        """The round's model plus the dequantized codec ``code`` (host q,
        scales) of an update, added in float64 and rounded to float32, a
        chunk of ``CODE_CHUNK`` lanes at a time."""
        q, s = code
        tile = chain_ref.BLOCK_D
        flat = torch.empty_like(params_flat)
        for lo in range(0, self.dim, CODE_CHUNK):
            hi = min(lo + CODE_CHUNK, self.dim)
            b = -(-hi // tile) * tile
            dq = chain_ref.dequantize(
                torch.from_numpy(q[lo:b]).to(self.device)[None],
                torch.from_numpy(s[lo // tile:b // tile]).to(self.device)[None],
                hi - lo)[0]
            flat[lo:hi] = (params_flat[lo:hi].double() + dq).float()
        return self.unflatten(flat)

    # -- one round -----------------------------------------------------
    def params_of(self, payload) -> torch.Tensor:
        return torch.cat([torch.from_numpy(np.asarray(a)).reshape(-1).float()
                          for _, a in payload]).to(self.device)

    def judge_round(self, rec: dict, blocks: Dict[int, dict]) -> dict:
        t, tr = rec["round"], self.traffic
        k = tr["k_updates"]
        params_flat = self.params_of(blocks[t * (k + 1)]["payload"])
        params = self.unflatten(params_flat)
        out = dict.fromkeys(LM_NUMBERS, 0.0)
        by_uploader, rows_scored = {}, []
        f64 = Precision("f64", self.device)
        for c, cohort in enumerate(rec["cohorts"]):
            want = self.reference_norms(params, cohort, f64)
            out["row_gap"] = max(out["row_gap"],
                                 self.row_gap(params, cohort, cohort["rows"]))
            gaps = row_gaps(cohort["norms"], want)
            out["update_gap"] = max(out["update_gap"], float(gaps.max()))
            out["update_gap_median"] = max(out["update_gap_median"],
                                           float(np.median(gaps)))
            rows = self.rows_of(rec, c)
            vx, vy = self.member_rows(cohort)
            out["score_gap"] = max(out["score_gap"], self.score_gap(
                params_flat, cohort["codes"], cohort["scores"][rows], rows,
                vx, vy))
            for i, u in enumerate(cohort["trainers"]):
                by_uploader[u] = (c, i)
                rows_scored.append((u, cohort["scores"][i].tolist()))
        packed = consensus(rows_scored, tr["accept_threshold"], k)
        ups = [blocks[t * (k + 1) + 1 + i] for i in range(k)]
        out["packed_mismatch"] = float(sum(
            (b["uploader"], b["score"]) != p for b, p in zip(ups, packed)))
        out["blob_mismatch"] = float(rec["blob_mismatch"]) + float(sum(
            int(dict(b["payload"])[("d",)]) != self.dim for b in ups))
        w = np.array([p[1] for p in packed], np.float64)
        w = w / max(w.sum(), 1e-12)        # all-zero scores weigh nothing
        nxt = self.params_of(blocks[(t + 1) * (k + 1)]["payload"])
        got, want = self.model_change_norms(params_flat, nxt, ups, w)
        out["model_gap"] = float(row_gaps(got[None], want[None]).max())
        return out

    def model_change_norms(self, params_flat, nxt, ups, w):
        """Per-leaf float64 norms of the next model block's change from the
        round's model (``got``) and of the score-weighted mean of the
        stored blocks, dequantized in float64 and added in float32
        (``want``), a leaf at a time."""
        blobs = [dict(b["payload"]) for b in ups]
        got, want, lo = [], [], 0
        tile = chain_ref.BLOCK_D
        for _, leaf in paths(self.init):
            hi = lo + leaf.numel()
            a, b = lo // tile * tile, -(-hi // tile) * tile
            agg = torch.zeros(hi - lo, dtype=torch.float64, device=self.device)
            for wi, pay in zip(w, blobs):
                q = torch.from_numpy(pay[("q",)][a:b]).to(self.device)[None]
                s = torch.from_numpy(pay[("scales",)][a // tile:b // tile]
                                     ).to(self.device)[None]
                agg += wi * chain_ref.dequantize(q, s, b - a)[0][lo - a:hi - a]
            p = params_flat[lo:hi]
            want.append(float(((p + agg.float()).double() - p.double()).norm()))
            got.append(float((nxt[lo:hi].double() - p.double()).norm()))
            lo = hi
        return np.array(got), np.array(want)


def chain_mismatch(headers: List[dict], payloads: Dict[int, list],
                   k: int) -> int:
    """Blocks whose link, hash or kind breaks the chain's rules, or whose
    recorded payload's digest is not the header's."""
    hashed = digests(payloads)
    bad, prev = 0, "genesis"
    for i, b in enumerate(headers):
        kind = "model" if i % (k + 1) == 0 else "update"
        ok = (b["index"] == i and b["prev_hash"] == prev and b["kind"] == kind
              and chain_ref.block_hash(b) == b["hash"])
        if i in hashed:
            ok = ok and hashed[i] == b["payload_digest"]
        bad += not ok
        prev = b["hash"]
    return bad

