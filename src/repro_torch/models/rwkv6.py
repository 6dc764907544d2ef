"""RWKV-6 "Finch" time mix (data-dependent decay) and channel mix.

Port of ``repro/models/rwkv6.py``.  Prefill and the full-sequence forward
use the reference's *chunked* linear-attention form, not the sequential
recurrence, so they round as the reference's prefill does: within a
chunk of CHUNK tokens the recurrence is masked (L, L) products with
log-space cumulative decay, and the (H, dh, dh) state is carried across
chunks (a Python loop where the reference ``lax.scan``s).  Decode is the
exact single-step recurrence.

Recurrence (per head, dh-dim r/k/v, state S in R^{dh x dh}):
    y_t = r_t @ (S_{t-1} + diag(u) k_t v_t^T)
    S_t = diag(w_t) S_{t-1} + k_t v_t^T
with per-channel data-dependent decay w_t in (0, 1).  Log-decay
differences are clamped to [-LOG_CLAMP, 0] before exponentiation.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import dense_init, normal

CHUNK = 64
LOG_CLAMP = 30.0

N_SHIFT = 5  # r, k, v, g, w token-shift interpolants


def init_rwkv_time_mix(gen: torch.Generator, cfg: ModelConfig, dtype) -> dict:
    D = cfg.d_model
    L1, L2 = cfg.rwkv_lora_mix, cfg.rwkv_lora_decay
    dev = gen.device

    def full(shape, value):
        return torch.full(shape, value, dtype=dtype, device=dev)

    return {
        # token-shift interpolation: base mus + DDLoRA producing 5 deltas
        "mu_base": full((D,), 0.5),
        "mu": full((N_SHIFT, D), 0.5),
        "mix_w1": dense_init(gen, D, N_SHIFT * L1, dtype=dtype),
        "mix_w2": normal(gen, (N_SHIFT, L1, D), 1.0 / math.sqrt(L1)).to(dtype),
        # projections
        "wr": dense_init(gen, D, D, dtype=dtype),
        "wk": dense_init(gen, D, D, dtype=dtype),
        "wv": dense_init(gen, D, D, dtype=dtype),
        "wg": dense_init(gen, D, D, dtype=dtype),
        "wo": dense_init(gen, D, D, dtype=dtype),
        # data-dependent decay DDLoRA
        "w0": full((D,), -4.0),
        "decay_w1": dense_init(gen, D, L2, dtype=dtype),
        "decay_w2": normal(gen, (L2, D), 1.0 / math.sqrt(L2)).to(dtype),
        # per-channel bonus
        "u": normal(gen, (D,), 0.1).to(dtype),
        # post-WKV group norm (one group per head)
        "gn_scale": full((D,), 1.0),
        "gn_bias": full((D,), 0.0),
    }


def init_rwkv_channel_mix(gen: torch.Generator, cfg: ModelConfig, dtype) -> dict:
    D, Fd = cfg.d_model, cfg.d_ff
    return {
        "mu_k": torch.full((D,), 0.5, dtype=dtype, device=gen.device),
        "mu_r": torch.full((D,), 0.5, dtype=dtype, device=gen.device),
        "wk": dense_init(gen, D, Fd, dtype=dtype),
        "wv": dense_init(gen, Fd, D, dtype=dtype),
        "wr": dense_init(gen, D, D, dtype=dtype),
    }


# ----------------------------------------------------------------------------
# shared pieces
# ----------------------------------------------------------------------------


def _shifted(x: torch.Tensor, x_prev: torch.Tensor) -> torch.Tensor:
    """x one token later: x_prev (B, D) first, then x[:, :-1]."""
    return torch.cat([x_prev[:, None, :], x[:, :-1, :]], dim=1)


def _token_shift_vectors(params, x, x_prev):
    """The 5 interpolated inputs (r, k, v, g, w) of the time mix.

    x: (B, S, D); x_prev: (B, D), the previous segment's last token (zeros
    at sequence start).  Returns (B, S, 5, D)."""
    B, S, D = x.shape
    sx = _shifted(x, x_prev) - x
    xxx = x + sx * params["mu_base"]
    hid = torch.tanh(xxx @ params["mix_w1"]).reshape(B, S, N_SHIFT, -1)
    delta = torch.einsum("bsnl,nld->bsnd", hid, params["mix_w2"])
    mix = params["mu"][None, None] + delta
    return x[:, :, None, :] + sx[:, :, None, :] * mix


def _decay_log(params, xw):
    """log(w_t) in (-inf, 0): w = exp(-exp(w0 + lora(xw)))."""
    lora = torch.tanh(xw @ params["decay_w1"]) @ params["decay_w2"]
    return -torch.exp(torch.clamp(
        params["w0"].to(torch.float32) + lora.to(torch.float32), -8.0, 8.0))


def _group_norm(params, y, H: int):
    """Per-head LayerNorm (GroupNorm with H groups), in float32."""
    B, S, D = y.shape
    yh = y.reshape(B, S, H, D // H).to(torch.float32)
    mean = yh.mean(dim=-1, keepdim=True)
    var = (yh - mean).square().mean(dim=-1, keepdim=True)
    yh = (yh - mean) * torch.rsqrt(var + 1e-5)
    return (yh.reshape(B, S, D) * params["gn_scale"].to(torch.float32)
            + params["gn_bias"].to(torch.float32))


# ----------------------------------------------------------------------------
# chunked WKV (training / prefill)
# ----------------------------------------------------------------------------


def _wkv_chunk(state, rc, kc, vc, lwc, u):
    """One chunk: rc, kc, vc, lwc (B, L, H, dh); state (B, H, dh, dh).
    Returns (new state, y (B, L, H, dh))."""
    L = rc.shape[1]
    a_inc = torch.cumsum(lwc, dim=1)                      # inclusive
    a_exc = a_inc - lwc                                   # sum over s < t
    # the carried state's contribution: y_t += (r_t * exp(a_exc_t)) @ S
    r_dec = rc * torch.exp(torch.clamp(a_exc, min=-LOG_CLAMP))
    y_state = torch.einsum("blhd,bhde->blhe", r_dec, state)
    # intra-chunk scores: s_tj = sum_d r_td k_jd exp(a_exc_t - a_inc_j)
    k_dec = kc * torch.exp(torch.clamp(-a_inc, min=-LOG_CLAMP))
    scores = torch.einsum("blhd,bmhd->bhlm", r_dec, k_dec)
    tri = torch.tril(torch.ones((L, L), dtype=torch.bool, device=rc.device),
                     diagonal=-1)
    scores = torch.where(tri[None, None], scores, 0.0)
    # the diagonal bonus: j == t
    diag = torch.einsum("blhd,blhd->blh", rc, u[None, None] * kc)
    y_intra = torch.einsum("bhlm,bmhe->blhe", scores, vc) + diag[..., None] * vc
    # S' = diag(exp(a_L)) S + sum_j (k_j exp(a_L - a_inc_j)) v_j^T
    a_tot = a_inc[:, -1]                                  # (B, H, dh)
    k_tail = kc * torch.exp(torch.clamp(a_tot[:, None] - a_inc, min=-LOG_CLAMP))
    state = state * torch.exp(torch.clamp(a_tot, min=-LOG_CLAMP))[..., None]
    state = state + torch.einsum("blhd,blhe->bhde", k_tail, vc)
    return state, y_state + y_intra


def _wkv_chunked(r, k, v, logw, u, state0):
    """r, k, v: (B, S, H, dh); logw: (B, S, H, dh) (<= 0); u: (H, dh);
    state0: (B, H, dh, dh).  S % CHUNK == 0.  Returns (y, state)."""
    S = r.shape[1]
    state, ys = state0, []
    for c in range(0, S, CHUNK):
        sl = slice(c, c + CHUNK)
        state, y = _wkv_chunk(state, r[:, sl], k[:, sl], v[:, sl], logw[:, sl], u)
        ys.append(y)
    return torch.cat(ys, dim=1), state


def _wkv_step(r, k, v, logw, u, state):
    """The exact one-token recurrence.  r, k, v, logw: (B, H, dh); state
    (B, H, dh, dh)."""
    y = torch.einsum("bhd,bhde->bhe", r, state)
    kv = torch.einsum("bhd,bhe->bhde", k, v)
    y = y + torch.einsum("bhd,bhde->bhe", r * u[None], kv)
    state = state * torch.exp(logw)[..., None] + kv
    return y, state


# ----------------------------------------------------------------------------
# public API
# ----------------------------------------------------------------------------


def _projections(params, x, x_prev, cfg: ModelConfig):
    """r, k, v (float32, (B, S, H, dh)), the gate g, logw and u."""
    B, S, D = x.shape
    dh = cfg.rwkv_head_dim
    H = D // dh
    xi = _token_shift_vectors(params, x, x_prev)          # (B, S, 5, D)
    xr, xk, xv, xg, xw = (xi[:, :, i] for i in range(N_SHIFT))
    r = (xr @ params["wr"]).reshape(B, S, H, dh).to(torch.float32)
    k = (xk @ params["wk"]).reshape(B, S, H, dh).to(torch.float32)
    v = (xv @ params["wv"]).reshape(B, S, H, dh).to(torch.float32)
    g = F.silu(xg @ params["wg"])
    logw = _decay_log(params, xw).reshape(B, S, H, dh)
    u = params["u"].to(torch.float32).reshape(H, dh)
    return r, k, v, g, logw, u


def rwkv_time_mix_forward(params, x, cfg: ModelConfig, state=None):
    """Full-sequence time mix.  x: (B, S, D); state: None (fresh) or
    {shift (B, D), wkv (B, H, dh, dh)}.  Returns (out, new_state)."""
    B, S, D = x.shape
    H = D // cfg.rwkv_head_dim
    dh = cfg.rwkv_head_dim
    x_prev = state["shift"] if state else x.new_zeros((B, D))
    wkv0 = (state["wkv"] if state else
            torch.zeros((B, H, dh, dh), dtype=torch.float32, device=x.device))
    r, k, v, g, logw, u = _projections(params, x, x_prev, cfg)
    pad = (-S) % CHUNK
    if pad:
        # padded steps have k = v = 0 and logw = 0: the state is unchanged
        padf = lambda t: F.pad(t, (0, 0, 0, 0, 0, pad))
        y, wkv = _wkv_chunked(padf(r), padf(k), padf(v), padf(logw), u, wkv0)
        y = y[:, :S]
    else:
        y, wkv = _wkv_chunked(r, k, v, logw, u, wkv0)
    y = _group_norm(params, y.reshape(B, S, D), H)
    out = (y.to(x.dtype) * g) @ params["wo"]
    return out, {"shift": x[:, -1, :], "wkv": wkv}


def rwkv_time_mix_step(params, x, cfg: ModelConfig, state):
    """One-token decode.  x: (B, 1, D).  Returns (out, new_state)."""
    B, _, D = x.shape
    H = D // cfg.rwkv_head_dim
    r, k, v, g, logw, u = _projections(params, x, state["shift"], cfg)
    y, wkv = _wkv_step(r[:, 0], k[:, 0], v[:, 0], logw[:, 0], u, state["wkv"])
    y = _group_norm(params, y.reshape(B, 1, D), H)
    out = (y.to(x.dtype) * g) @ params["wo"]
    return out, {"shift": x[:, -1, :], "wkv": wkv}


def rwkv_channel_mix_forward(params, x, cfg: ModelConfig, state=None):
    """x: (B, S, D) -> (out, new_state {shift})."""
    B, S, D = x.shape
    x_prev = state["shift"] if state else x.new_zeros((B, D))
    sx = _shifted(x, x_prev) - x
    xk = x + sx * params["mu_k"]
    xr = x + sx * params["mu_r"]
    k = torch.square(F.relu(xk @ params["wk"]))
    v = k @ params["wv"]
    out = torch.sigmoid(xr @ params["wr"]) * v
    return out, {"shift": x[:, -1, :]}


def init_rwkv_state(cfg: ModelConfig, batch: int, dtype, device="cpu") -> dict:
    D = cfg.d_model
    dh = cfg.rwkv_head_dim
    H = D // dh
    return {
        "tm": {
            "shift": torch.zeros((batch, D), dtype=dtype, device=device),
            "wkv": torch.zeros((batch, H, dh, dh), dtype=torch.float32,
                               device=device),
        },
        "cm": {"shift": torch.zeros((batch, D), dtype=dtype, device=device)},
    }
