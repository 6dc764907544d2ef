"""Mamba-1 selective SSM block (as used inside Jamba).

Port of ``repro/models/mamba.py``.  The full-sequence forward (training
and prefill) and decode are the exact sequential recurrence in float32:
a Python loop over the tokens, one ``_ssm_step`` each.  The reference
pads S up to a multiple of its 64-token chunk and scans chunk by chunk; its pad
steps carry ``dt = 0``, so they multiply the state by ``exp(0 * A) = 1``
and add 0, and the unpadded loop leaves the same state.  Decode is the
single-step recurrence with a (conv_state, ssm_state) cache.

Recurrence (per channel c of d_inner, per state dim n of d_state):
    h_t = exp(dt_t * A) * h_{t-1} + dt_t * B_t * u_t
    y_t = C_t . h_t + D_param * u_t
with input-dependent dt (softplus), B, C (Jamba applies RMSNorm to dt/B/C
before projection).

The causal depthwise convolution is the reference's sum over the
``d_conv`` taps in tap order in the forward and its ``einsum`` over the
window in decode.  ``softplus`` is ``logaddexp(x, 0)``, as
``jax.nn.softplus`` is (``F.softplus`` returns ``x`` above a threshold).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import dense_init, normal


def init_mamba(gen: torch.Generator, cfg: ModelConfig, dtype) -> dict:
    D = cfg.d_model
    din = cfg.mamba_d_inner
    ds = cfg.mamba_d_state
    dc = cfg.mamba_d_conv
    dtr = cfg.resolved_dt_rank
    dev = gen.device
    # S4D-real initialization for A
    a = torch.arange(1, ds + 1, dtype=torch.float32, device=dev)[None, :].repeat(
        din, 1)
    dt_init_std = dtr ** -0.5
    dt_proj = (torch.rand((dtr, din), generator=gen, device=dev)
               * (2 * dt_init_std) - dt_init_std)
    return {
        "in_proj": dense_init(gen, D, 2 * din, dtype=dtype),
        "conv_w": normal(gen, (dc, din), 1.0 / math.sqrt(dc)).to(dtype),
        "conv_b": torch.zeros((din,), dtype=dtype, device=dev),
        "x_proj": dense_init(gen, din, dtr + 2 * ds, dtype=dtype),
        "dt_proj": dt_proj.to(dtype),
        "dt_bias": torch.full((din,), -4.6, dtype=dtype, device=dev),
        "A_log": torch.log(a),                     # float32 whatever dtype is
        "D": torch.ones((din,), dtype=dtype, device=dev),
        "out_proj": dense_init(gen, din, D, dtype=dtype),
        # Jamba-style RMSNorms on dt / B / C
        "dt_norm": torch.ones((dtr,), dtype=dtype, device=dev),
        "b_norm": torch.ones((ds,), dtype=dtype, device=dev),
        "c_norm": torch.ones((ds,), dtype=dtype, device=dev),
    }


def _rms(x, scale, eps=1e-6):
    xf = x.to(torch.float32)
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.to(torch.float32)).to(x.dtype)


def _softplus(x):
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def _ssm_inputs(params, u, cfg: ModelConfig):
    """u: (B,S,din) post-conv activations -> (dt, Bmat, Cmat) in f32."""
    ds = cfg.mamba_d_state
    dtr = cfg.resolved_dt_rank
    proj = u @ params["x_proj"]                            # (B,S,dtr+2ds)
    dt_lowrank = _rms(proj[..., :dtr], params["dt_norm"])
    Bmat = _rms(proj[..., dtr:dtr + ds], params["b_norm"]).to(torch.float32)
    Cmat = _rms(proj[..., dtr + ds:], params["c_norm"]).to(torch.float32)
    dt = _softplus(
        (dt_lowrank @ params["dt_proj"]).to(torch.float32)
        + params["dt_bias"].to(torch.float32)
    )                                                      # (B,S,din)
    return dt, Bmat, Cmat


def _ssm_step(h, inp, A):
    """h: (B,din,ds); inp = (u_t (B,din), dt_t (B,din), B_t (B,ds), C_t (B,ds))."""
    u_t, dt_t, B_t, C_t = inp
    da = torch.exp(dt_t[..., None] * A[None])              # (B,din,ds)
    dbu = (dt_t * u_t)[..., None] * B_t[:, None, :]        # (B,din,ds)
    h = da * h + dbu
    y = torch.einsum("bdn,bn->bd", h, C_t)
    return h, y


def _scan_chunk(A, h0, u, dt, Bm, Cm):
    """The exact sequential scan over a chunk of tokens (here the whole
    sequence).  u,dt: (B,L,din); Bm,Cm: (B,L,ds)."""
    h, ys = h0, []
    for t in range(u.shape[1]):
        h, y = _ssm_step(h, (u[:, t], dt[:, t], Bm[:, t], Cm[:, t]), A)
        ys.append(y)
    return h, torch.stack(ys, dim=1)                       # (B,L,din)


def mamba_forward(params, x, cfg: ModelConfig, state=None):
    """x: (B,S,D) -> (out, new_state).

    state: None or dict(conv (B,dc-1,din), ssm (B,din,ds))."""
    B, S, D = x.shape
    din = cfg.mamba_d_inner
    ds = cfg.mamba_d_state
    dc = cfg.mamba_d_conv

    xz = x @ params["in_proj"]
    u, z = torch.chunk(xz, 2, dim=-1)                      # (B,S,din) each

    conv_prev = (state["conv"] if state else
                 torch.zeros((B, dc - 1, din), dtype=x.dtype, device=x.device))
    ssm_prev = (state["ssm"] if state else
                torch.zeros((B, din, ds), dtype=torch.float32, device=x.device))
    # causal depthwise conv over time
    u_pad = torch.cat([conv_prev, u], dim=1)               # (B,S+dc-1,din)
    conv = sum(
        u_pad[:, i:i + S, :] * params["conv_w"][i][None, None]
        for i in range(dc)
    )
    u_act = F.silu(conv + params["conv_b"]).to(torch.float32)

    dt, Bm, Cm = _ssm_inputs(params, u_act.to(x.dtype), cfg)
    A = -torch.exp(params["A_log"])                        # (din,ds)
    h_final, y = _scan_chunk(A, ssm_prev, u_act, dt, Bm, Cm)
    y = y + u_act * params["D"].to(torch.float32)
    out = (y.to(x.dtype) * F.silu(z)) @ params["out_proj"]
    new_state = {
        # the last dc-1 rows of the pre-conv input, the carried state's
        # rows among them when S < dc - 1
        "conv": u_pad[:, S:S + dc - 1, :] if dc > 1 else conv_prev,
        "ssm": h_final,
    }
    return out, new_state


def mamba_step(params, x, cfg: ModelConfig, state):
    """Single-token decode.  x: (B,1,D)."""
    xz = x[:, 0] @ params["in_proj"]
    u, z = torch.chunk(xz, 2, dim=-1)                      # (B,din)

    conv_prev = state["conv"]                              # (B,dc-1,din)
    window = torch.cat([conv_prev, u[:, None]], dim=1)     # (B,dc,din)
    conv = torch.einsum("bcd,cd->bd", window, params["conv_w"])
    u_act = F.silu(conv + params["conv_b"]).to(torch.float32)

    dt, Bm, Cm = _ssm_inputs(params, u_act[:, None].to(x.dtype), cfg)
    A = -torch.exp(params["A_log"])
    h, y = _ssm_step(state["ssm"], (u_act, dt[:, 0], Bm[:, 0], Cm[:, 0]), A)
    y = y + u_act * params["D"].to(torch.float32)
    out = (y.to(x.dtype) * F.silu(z))[:, None] @ params["out_proj"]
    return out, {"conv": window[:, 1:], "ssm": h}


def init_mamba_state(cfg: ModelConfig, batch: int, dtype, device="cpu") -> dict:
    return {
        "conv": torch.zeros((batch, cfg.mamba_d_conv - 1, cfg.mamba_d_inner),
                            dtype=dtype, device=device),
        "ssm": torch.zeros((batch, cfg.mamba_d_inner, cfg.mamba_d_state),
                           dtype=torch.float32, device=device),
    }
