"""Slot-based continuous-batching engine over the serving steps.

Port of ``repro/serve/engine.py``.  A fixed-capacity decode batch of
``num_slots`` request slots runs ONE decode step per tick
(``launch/steps.make_decode_step`` with logits dropped).  Admission is
prefill-into-slot: a queued request is prefilled at its exact prompt
length (batch 1) and its KV state written into the freed slot row
(``models.cache.insert_slot_cache``), with no batch barrier, so short
requests never wait on long ones.  Finished slots free at the tick
boundary on which their generation budget is spent; finish detection is
count-based, so the hot loop never blocks on token values: each tick's
token vector starts its copy to pinned host memory at once
(``repro_torch.device.HostCopy``, non-blocking) and is read one tick late,
while the next tick is already queued on the device.  The KV cache and
the positions are updated in place (the reference donates them to its
compiled step for the same effect).

The engine also watches a parameter source (``repro_torch.serve.params``)
and hot-swaps the whole parameter tree at a tick boundary when a new
round commits a model block.  In-flight requests keep their caches and
keep decoding; nothing is dropped.

The engine runs on ``device``: CUDA by default, raising when CUDA is
absent unless the caller passes ``device="cpu"``.  Its steps take the
reference's ``mesh`` and ``pol`` (default: the 1 x 1 ``LocalMesh`` and
the one-device policy, the reference's ``make_host_mesh(1, 1)``), so an
MoE model under ``moe_impl="auto"`` serves through the expert-parallel
path with its capacity dispatch: the idle slots' rows route too and take
capacity, so a request's tokens may depend on the other rows (the
same-row oracle holds only on the dense path; a replay of the ticks the
engine ran holds always).  On a ``DeviceMesh`` the parameters are
DTensors laid out by ``param_pspecs`` and the decode state is sharded as
the reference lays it out: the cache by ``cache_pspecs`` (each rank
allocates and writes only its own block), the tokens and positions by
``decode_pspecs`` (slots over the data axes).  A prompt is prefilled in
the batch-1 layout and its row is written by the ranks that own slot
``b``, each its own slots or heads of it.  Each tick's tokens are
gathered whole for the host copy.
"""
from __future__ import annotations

import contextlib
import time
from collections import deque
from dataclasses import dataclass
from typing import Any, Callable, Deque, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.device import HostCopy, resolve_device, synchronize, to_device
from repro_torch.launch.mesh import LocalMesh
from repro_torch.launch.shardings import (
    decode_pspecs,
    distribute,
    param_pspecs,
)
from repro_torch.launch.steps import (
    make_decode_step,
    make_prefill_step,
    one_device_policy,
)
from repro_torch.models import init_cache
from repro_torch.models.cache import insert_slot_cache
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import torch_dtype
from repro_torch.models.moe import count_drops
from repro_torch.models.shardctx import (
    full_dtensor,
    is_dtensor,
    shard_range,
    vocab_argmax,
    whole,
)
from repro_torch.models.transformer import Batch
from repro_torch.serve.scheduler import FifoScheduler
from repro_torch.serve.slots import Request, RequestResult, SlotTable
from repro_torch.serve.trace import aggregate
from repro_torch.tree import tree_map


# ----------------------------------------------------------------------------
# clocks
# ----------------------------------------------------------------------------


class WallClock:
    """Real time — the benchmark's clock."""

    def __init__(self):
        self._t0 = time.perf_counter()

    def now(self) -> float:
        return time.perf_counter() - self._t0

    def tick(self) -> None:
        pass

    def advance_to(self, t: float) -> None:
        delta = t - self.now()
        if delta > 0:
            time.sleep(min(delta, 0.002))


class VirtualClock:
    """Deterministic tick-counting clock — the test harness's clock.

    Time advances ``dt`` per decode tick and jumps to the next arrival when
    the engine idles, so admission order (and therefore every decoded token)
    is reproducible run-to-run."""

    def __init__(self, dt: float = 1.0):
        self.dt = dt
        self._t = 0.0

    def now(self) -> float:
        return self._t

    def tick(self) -> None:
        self._t += self.dt

    def advance_to(self, t: float) -> None:
        if t > self._t:
            self._t = t


# ----------------------------------------------------------------------------
# the steps' inputs
# ----------------------------------------------------------------------------


def prompt_batch(cfg: ModelConfig, prompt: np.ndarray, device) -> Batch:
    """A batch-1 prefill of ``prompt``.  An M-RoPE model's prompt is text:
    its (3, 1, S) positions are the token positions on all three streams,
    with zero ``embeds`` and an all-False ``embed_mask``, as the reference
    engine builds it.  Its decode steps rotate by each slot's position on
    all three streams, the decode step's default."""
    S = int(prompt.shape[0])
    toks = to_device(np.asarray(prompt, np.int32)[None], device)
    pos = torch.arange(S, dtype=torch.int32, device=device)[None]
    if cfg.rope != "mrope":
        return Batch(tokens=toks, positions=pos)
    return Batch(tokens=toks, positions=pos[None].expand(3, 1, S),
                 embeds=torch.zeros((1, S, cfg.d_model),
                                    dtype=torch_dtype(cfg.dtype),
                                    device=device),
                 embed_mask=torch.zeros((1, S), dtype=torch.bool,
                                        device=device))


# ----------------------------------------------------------------------------
# the single-request oracle
# ----------------------------------------------------------------------------


@torch.no_grad()
def greedy_oracle(cfg: ModelConfig, params, prompt: np.ndarray, max_new: int,
                  *, max_len: int, rows: int = 1, row: int = 0,
                  return_logits: bool = False):
    """Greedy generation of one request alone, through the serving steps.

    ``rows=1`` is the reference's batch-1 oracle.  With ``rows=num_slots``
    the request decodes in row ``row`` of the engine's own batch shape, the
    other rows idle: a matmul's rounding may depend on its row count (the
    CPU's and the card's BLAS pick other kernels for one row than for
    four), so only this oracle pins served tokens bit for bit
    (PERF.md §6).  ``return_logits=True`` returns (tokens, logits): the
    (max_new, V) logits each token was the argmax of."""
    device = params["embed"].device
    prefill = make_prefill_step(cfg, max_len=max_len)
    decode = make_decode_step(cfg, return_logits=return_logits)
    S = int(prompt.shape[0])
    logits, slot_cache = prefill(params, prompt_batch(cfg, prompt, device))
    first = torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)
    cache = insert_slot_cache(
        init_cache(cfg, rows, max_len, params["embed"].dtype, device),
        slot_cache, row)
    tok = torch.zeros((rows, 1), dtype=torch.int32, device=device)
    tok[row, 0] = first[0]
    pos = torch.zeros((rows,), dtype=torch.int32, device=device)
    pos[row:row + 1].fill_(S)
    out, seen = [tok[row:row + 1]], [logits[0, -1]]
    for _ in range(max_new - 1):
        if return_logits:
            tok, logits, cache = decode(params, tok, pos, cache)
            seen.append(logits[row, -1])
        else:
            tok, cache = decode(params, tok, pos, cache)
        pos.add_(1)
        out.append(tok[row:row + 1])
    tokens = [int(t) for t in torch.cat(out).reshape(-1).cpu()]
    return (tokens, torch.stack(seen)) if return_logits else tokens


# ----------------------------------------------------------------------------
# engine
# ----------------------------------------------------------------------------


@dataclass
class _Pending:
    """A launched-but-not-read token vector: drained one tick late."""

    tok: HostCopy                                 # (rows, 1) on its way
    # (rid, row, is_first_token, is_last_token)
    deliveries: List[Tuple[int, int, bool, bool]]
    version: int


@dataclass
class ServeReport:
    results: List[RequestResult]
    wall_s: float
    ticks: int
    occupancy: float                              # mean active-slot fraction
    swaps: List[Dict[str, Any]]
    policy: str

    def metrics(self) -> Dict[str, float]:
        return aggregate(
            self.results, wall_s=self.wall_s, ticks=self.ticks,
            occupancy=self.occupancy, swaps=len(self.swaps),
        )

    def by_rid(self) -> Dict[int, RequestResult]:
        return {r.rid: r for r in self.results}


class ServeEngine:
    """Continuous-batching server for one decoder model."""

    def __init__(
        self,
        cfg: ModelConfig,
        params: Any,
        *,
        num_slots: int = 4,
        max_len: int = 128,
        mesh=None,
        pol=None,
        param_source=None,
        swap_poll_every: int = 1,
        device="cuda",
    ):
        if not cfg.is_decoder():
            raise ValueError(f"{cfg.name} is encoder-only: nothing to serve")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.dtype = torch_dtype(cfg.dtype)
        self.mesh = LocalMesh() if mesh is None else mesh
        self.pol = one_device_policy() if pol is None else pol
        self.params = self._place(params)
        self.num_slots = num_slots
        self.max_len = max_len
        self.source = param_source
        self.swap_poll_every = max(1, swap_poll_every)
        self.version = getattr(param_source, "version", 0) or 0
        # a prompt is a batch of one: on a DeviceMesh it is prefilled in
        # the batch-1 layout (rows unsplit, the cache's sequence over the
        # data axes), and ``_insert`` lays its row out as the slots'
        self._prefill_step = make_prefill_step(
            cfg, self.mesh, self.pol, max_len=max_len,
            batch_sharded=getattr(self.mesh, "is_local", False))
        self._decode = make_decode_step(cfg, self.mesh, self.pol,
                                        return_logits=False)

    def _place(self, params, like=None):
        """The tree on the serving device (in ``like``'s dtypes), laid out
        on the mesh by ``param_pspecs``."""
        if like is None:
            params = tree_map(lambda t: t.to(self.device), params)
        else:
            params = tree_map(lambda n, o: n.to(device=self.device,
                                                dtype=o.dtype), params, like)
        return distribute(params, self.mesh,
                          param_pspecs(self.cfg, params, self.pol))

    # ------------------------------------------------------------------
    # the device steps
    # ------------------------------------------------------------------
    def _prefill(self, batch: Batch):
        logits, cache = self._prefill_step(self.params, batch)
        tok = whole(vocab_argmax(logits[:, -1, :]))
        return tok[:, None], cache

    def _tick(self, tokens, positions, cache):
        next_tok, cache = self._decode(self.params, tokens, positions, cache)
        positions.add_(1)
        return next_tok, positions, cache

    @staticmethod
    def _insert(cache, tokens, positions, slot_cache, first_tok, pos0: int,
                b: int):
        cache = insert_slot_cache(cache, slot_cache, b)
        # a new token vector: the last tick's may still be on its way to
        # the host (on the CPU its host copy is the tensor itself)
        tokens = tokens.clone()
        # on a mesh, the ranks whose block holds slot b write it
        tok_l, pos_l, b_l = _slot_rows(tokens, positions, b)
        if b_l is not None:
            tok_l[b_l] = first_tok[0].to(tok_l.device)
            # fill_ passes the number to the kernel; ``positions[b] = pos0``
            # would copy it from the host, a blocking copy
            pos_l[b_l:b_l + 1].fill_(pos0)
        return tokens, positions, cache

    def _fresh_state(self):
        shapes = ((self.num_slots, 1), (self.num_slots,))
        if getattr(self.mesh, "is_local", False):
            tokens, positions = (torch.zeros(shape, dtype=torch.int32,
                                             device=self.device)
                                 for shape in shapes)
        else:
            specs = decode_pspecs(self.cfg, self.pol, batch_sharded=True)
            tokens, positions = (
                full_dtensor(shape, 0, torch.int32, self.device, self.mesh,
                             spec)
                for shape, spec in zip(shapes, (specs.tokens,
                                                specs.position)))
        cache = init_cache(self.cfg, self.num_slots, self.max_len, self.dtype,
                           self.device, mesh=self.mesh, pol=self.pol)
        return tokens, positions, cache

    @torch.no_grad()
    def warmup(self, prompt_lens: Sequence[int]) -> None:
        """Run every hot-path step (per-bucket prefill, insert, tick) once
        outside the timed window (library handles, workspaces, the
        allocator's pools)."""
        tokens, positions, cache = self._fresh_state()
        for S in sorted(set(int(s) for s in prompt_lens)):
            tok, slot_cache = self._prefill(prompt_batch(
                self.cfg, np.zeros((S,), np.int32), self.device))
            tokens, positions, cache = self._insert(
                cache, tokens, positions, slot_cache, tok, S, 0)
        tokens, positions, cache = self._tick(tokens, positions, cache)
        synchronize(self.device)

    # ------------------------------------------------------------------
    def _poll_swap(self, tick_idx: int, clock, swaps: List[dict]) -> None:
        if self.source is None:
            return
        got = self.source.poll()
        if got is None:
            return
        ver, new_params = got
        # onto the serving device in the serving dtype, once; the structure
        # must match, which a chain model block of the same arch guarantees
        self.params = self._place(new_params, like=self.params)
        self.version = ver
        swaps.append({"round": int(ver), "tick": tick_idx,
                      "t": round(clock.now(), 6)})

    def _drain(self, pending: Deque[_Pending],
               results: Dict[int, RequestResult], clock,
               force: bool = False) -> None:
        """Read token vectors one tick late: the wait on the copy's event
        overlaps with the next tick already queued on the device."""
        while pending and (force or len(pending) > 1):
            rec = pending.popleft()
            toks = rec.tok.wait()
            now = clock.now()
            for rid, row, first, last in rec.deliveries:
                r = results[rid]
                r.tokens.append(int(toks[row, 0]))
                if first:
                    r.first_token = now
                if last:
                    r.finished = now
                    r.version_finished = rec.version

    # ------------------------------------------------------------------
    @torch.no_grad()
    def run(
        self,
        requests: Sequence[Request],
        *,
        policy: str = "continuous",
        clock=None,
        on_tick: Optional[Callable[[int], None]] = None,
        record: Optional[list] = None,
    ) -> ServeReport:
        """Serve a trace to completion and return the per-request results.

        ``on_tick(tick_idx)`` fires at every tick boundary — used to commit
        a new model block to the watched chain mid-trace.  ``record``, a
        list, receives the device steps in order, for ``replay_ticks``:
        ``("admit", rid, slot, drops)`` (slot -1 for a one-token request)
        and ``("tick", rids by row, drops)``, where ``drops`` is the
        expert-parallel MoE's dropped assignments in that step (a 0-d
        tensor, read later; 0 without MoE layers).  Without ``record`` the
        drops are not counted, so the MoE layers launch nothing extra.
        """
        for r in requests:
            if r.max_new < 1:
                raise ValueError(f"request {r.rid}: max_new must be >= 1")
            if r.prompt_len < 1:
                raise ValueError(f"request {r.rid}: empty prompt")
            if r.prompt_len + r.max_new - 1 > self.max_len:
                raise ValueError(
                    f"request {r.rid}: prompt {r.prompt_len} + gen {r.max_new}"
                    f" exceeds max_len {self.max_len}"
                )

        drop_counter = (count_drops if record is not None
                        else contextlib.nullcontext)
        clock = clock or WallClock()
        sched = FifoScheduler(requests, policy=policy)
        table = SlotTable(self.num_slots)
        tokens, positions, cache = self._fresh_state()
        results: Dict[int, RequestResult] = {
            r.rid: RequestResult(rid=r.rid, prompt_len=r.prompt_len,
                                 max_new=r.max_new, arrival=r.arrival)
            for r in requests
        }
        pending: Deque[_Pending] = deque()
        swaps: List[dict] = []
        tick_idx = 0
        active_ticks = 0          # sum of active slots over all ticks
        t_start = time.perf_counter()

        while not (sched.exhausted and table.all_free and not pending):
            if tick_idx % self.swap_poll_every == 0:
                self._poll_swap(tick_idx, clock, swaps)

            # ---- admissions (prefill-into-slot) --------------------------
            for b, req in sched.admissions(table, clock.now()):
                res = results[req.rid]
                res.admitted = clock.now()
                res.version_admitted = self.version
                with drop_counter() as drops:
                    tok, slot_cache = self._prefill(
                        prompt_batch(self.cfg, req.prompt, self.device))
                one_shot = req.max_new == 1
                if record is not None:
                    record.append(("admit", req.rid, -1 if one_shot else b,
                                   _total(drops)))
                pending.append(_Pending(
                    tok=HostCopy(tok),
                    deliveries=[(req.rid, 0, True, one_shot)],
                    version=self.version,
                ))
                if not one_shot:
                    tokens, positions, cache = self._insert(
                        cache, tokens, positions, slot_cache, tok,
                        req.prompt_len, b)
                    table.occupy(b, req.rid, req.max_new - 1)
                    res.slot = b

            # ---- one decode tick over the whole slot batch ---------------
            if table.num_active:
                rids = table.active_snapshot()
                with drop_counter() as drops:
                    tokens, positions, cache = self._tick(tokens, positions,
                                                          cache)
                if record is not None:
                    record.append(("tick", [int(r) for r in rids],
                                   _total(drops)))
                done_slots = table.decrement_active()
                done_set = set(done_slots)
                deliveries = [
                    (int(rids[b]), b, False, b in done_set)
                    for b in range(self.num_slots)
                    if rids[b] >= 0
                ]
                pending.append(_Pending(tok=HostCopy(whole(tokens)),
                                        deliveries=deliveries,
                                        version=self.version))
                for b in done_slots:
                    table.release(b)
                active_ticks += len(deliveries)
                tick_idx += 1
                clock.tick()
                if on_tick is not None:
                    on_tick(tick_idx)
                self._drain(pending, results, clock)
            else:
                # idle: nothing decoding — drain stragglers, jump to the
                # next arrival
                self._drain(pending, results, clock, force=True)
                na = sched.next_arrival()
                if na is not None:
                    clock.advance_to(na)

        self._drain(pending, results, clock, force=True)
        wall = time.perf_counter() - t_start
        occupancy = (active_ticks / (tick_idx * self.num_slots)
                     if tick_idx else 0.0)
        ordered = [results[r.rid] for r in sorted(requests, key=lambda q: q.rid)]
        return ServeReport(results=ordered, wall_s=wall, ticks=tick_idx,
                           occupancy=occupancy, swaps=swaps, policy=policy)


def _slot_rows(tokens, positions, b: int):
    """(tokens, positions, row): the tensors a rank writes slot ``b`` of
    the engine's state into, with ``b``'s row in them, or a row of None
    where this rank's block does not hold it (DTensors laid out by
    ``decode_pspecs``: their local blocks)."""
    if not is_dtensor(tokens):
        return tokens, positions, b
    b0, n = shard_range(tokens.device_mesh, tokens.placements, 0,
                        tokens.shape[0])
    return (tokens.to_local(), positions.to_local(),
            b - b0 if b0 <= b < b0 + n else None)


def _total(drops: List[torch.Tensor]):
    return torch.stack(drops).sum() if drops else torch.zeros((),
                                                              dtype=torch.int64)


@torch.no_grad()
def replay_ticks(engine: "ServeEngine", requests: Sequence[Request],
                 record: list) -> Dict[int, List[int]]:
    """The replay oracle: the engine's own prefill and decode steps called
    again, from a fresh state, on the admissions and ticks it recorded
    (``run(..., record=...)``), with no scheduler, clock or deferred
    reads; returns each request's tokens (for a run without a hot swap:
    the replay serves ``engine.params``).  Under capacity dispatch a row's
    tokens may depend on the other rows, so this, not a single-request
    oracle, is what pins an MoE engine's service."""
    by_rid = {r.rid: r for r in requests}
    out: Dict[int, List[int]] = {r.rid: [] for r in requests}
    tokens, positions, cache = engine._fresh_state()
    for event in record:
        if event[0] == "admit":
            _, rid, b, _ = event
            req = by_rid[rid]
            tok, slot_cache = engine._prefill(
                prompt_batch(engine.cfg, req.prompt, engine.device))
            out[rid].append(int(tok[0, 0]))
            if b >= 0:
                tokens, positions, cache = engine._insert(
                    cache, tokens, positions, slot_cache, tok,
                    req.prompt_len, b)
        else:
            _, rids, _ = event
            tokens, positions, cache = engine._tick(tokens, positions, cache)
            host = whole(tokens).cpu()
            for b, rid in enumerate(rids):
                if rid >= 0:
                    out[rid].append(int(host[b, 0]))
    return out
