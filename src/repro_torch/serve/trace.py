"""Synthetic heavy-traffic traces + latency/throughput metric aggregation.

The driver models the BFLC deployment story: a large user population hits a
serving node with Poisson arrivals and mixed prompt/generation lengths.
Metrics follow the standard serving vocabulary — tokens/s, TTFT (arrival to
first generated token) and end-to-end request latency, p50/p99 over the
request population — and one row per run comes out of
``aggregate``.

Port of ``repro/serve/trace.py`` (numpy, copied as it is: the same seed
gives the same trace and the same metrics).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.serve.slots import Request, RequestResult


def make_poisson_trace(
    *,
    num_requests: int,
    rate: float,
    prompt_lens: Sequence[int],
    gen_lens: Sequence[int],
    vocab_size: int,
    seed: int = 0,
) -> List[Request]:
    """Poisson arrival process (exponential inter-arrival at ``rate`` req/s)
    with prompt/generation lengths drawn uniformly from the given buckets.

    Lengths come from a small bucket set on purpose: the engine prefills at
    exact prompt lengths (one XLA trace per distinct length, cached), which
    keeps admission correct for every mixer kind — ring-buffer SWA and
    recurrent (mamba/rwkv) caches included — without pad-token masking."""
    if rate <= 0:
        raise ValueError("rate must be positive")
    rng = np.random.default_rng(seed)
    t = 0.0
    reqs: List[Request] = []
    for rid in range(num_requests):
        t += float(rng.exponential(1.0 / rate))
        s = int(rng.choice(np.asarray(prompt_lens)))
        g = int(rng.choice(np.asarray(gen_lens)))
        prompt = rng.integers(0, vocab_size, (s,), dtype=np.int64).astype(np.int32)
        reqs.append(Request(rid=rid, prompt=prompt, max_new=g, arrival=t))
    return reqs


def _pct(xs: List[float], q: float) -> float:
    return float(np.percentile(np.asarray(xs, np.float64), q)) if xs else 0.0


def aggregate(
    results: Sequence[RequestResult],
    *,
    wall_s: float,
    ticks: int,
    occupancy: float,
    swaps: int = 0,
) -> Dict[str, float]:
    """The metrics row of a finished run."""
    gen = sum(len(r.tokens) for r in results)
    ttft = [r.first_token - r.arrival for r in results if r.first_token >= 0]
    lat = [r.finished - r.arrival for r in results if r.finished >= 0]
    return {
        "requests": len(results),
        "generated_tokens": gen,
        "wall_s": round(wall_s, 4),
        "tok_s": round(gen / wall_s, 2) if wall_s > 0 else 0.0,
        "ticks": ticks,
        "occupancy": round(occupancy, 4),
        "ttft_p50_ms": round(_pct(ttft, 50) * 1e3, 2),
        "ttft_p99_ms": round(_pct(ttft, 99) * 1e3, 2),
        "latency_p50_ms": round(_pct(lat, 50) * 1e3, 2),
        "latency_p99_ms": round(_pct(lat, 99) * 1e3, 2),
        "swaps": swaps,
    }
