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
from repro_torch.models.shardctx import (
    as_dtensor,
    is_dtensor,
    keep_dims,
    local_part,
)


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


def _causal_conv(u_pad, w, b, S: int):
    """The depthwise causal conv over ``u_pad`` (B, S + dc - 1, din), the
    taps in order, then SiLU, in float32."""
    conv = sum(u_pad[:, i:i + S, :] * w[i][None, None]
               for i in range(w.shape[0]))
    return F.silu(conv + b).to(torch.float32)


def mamba_forward(params, x, cfg: ModelConfig, state=None, layout=None):
    """x: (B,S,D) -> (out, new_state).

    state: None or dict(conv (B,dc-1,din), ssm (B,din,ds)).  ``layout``
    (a prefill on a DeviceMesh): (mesh, the conv state's placements, the
    ssm state's), and the mixer runs on each rank's rows and channels as
    ``mamba_step`` does (``_mamba_forward_local``), from a zero state."""
    if layout is not None:
        return _mamba_forward_local(params, x, cfg, *layout)
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
    u_act = _causal_conv(u_pad, params["conv_w"], params["conv_b"], S)

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


def _mamba_forward_local(params, x, cfg: ModelConfig, mesh, conv_pl, ssm_pl):
    """``mamba_forward`` from a zero state, the conv and the scan on each
    rank's rows and d_inner channels (``conv_pl``: the conv state's
    placements, (B, dc-1, din)), so the final state comes out in the
    cache's layout, each rank holding its own block; the projections
    between them are DTensor products."""
    B, S, _ = x.shape
    din, ds, dc = cfg.mamba_d_inner, cfg.mamba_d_state, cfg.mamba_d_conv
    xz = x @ params["in_proj"]
    u, z = torch.chunk(xz, 2, dim=-1)                      # (B,S,din)
    rows_ch = keep_dims(conv_pl, {0: 0, 2: 2})             # (B, S, din)
    rows = keep_dims(conv_pl, {0: 0})                      # (B, S, ds)
    ch = keep_dims(conv_pl, {2: 0})                        # (din, ...)
    u_l = local_part(u, mesh, rows_ch)
    u_pad = torch.cat([u_l.new_zeros((u_l.shape[0], dc - 1, u_l.shape[2])),
                       u_l], dim=1)
    u_act = _causal_conv(u_pad, local_part(params["conv_w"], mesh,
                                           keep_dims(conv_pl, {2: 1})),
                         local_part(params["conv_b"], mesh, ch), S)
    dt, Bm, Cm = _ssm_inputs(
        params, as_dtensor(u_act, mesh, rows_ch, (B, S, din)).to(x.dtype), cfg)
    A = -torch.exp(local_part(params["A_log"], mesh, ch))
    h0 = u_act.new_zeros((u_act.shape[0], u_act.shape[2], ds))
    h_final, y = _scan_chunk(A, h0, u_act, local_part(dt, mesh, rows_ch),
                             local_part(Bm, mesh, rows),
                             local_part(Cm, mesh, rows))
    y = y + u_act * local_part(params["D"], mesh, ch).to(torch.float32)
    y = as_dtensor(y.to(x.dtype), mesh, rows_ch, (B, S, din))
    out = (y * F.silu(z)) @ params["out_proj"]
    conv = u_pad[:, S:S + dc - 1, :] if dc > 1 else u_pad[:, :0]
    return out, {"conv": as_dtensor(conv.contiguous(), mesh, conv_pl,
                                    (B, dc - 1, din)),
                 "ssm": as_dtensor(h_final, mesh, ssm_pl, (B, din, ds))}


def mamba_step(params, x, cfg: ModelConfig, state):
    """Single-token decode.  x: (B,1,D).  A state of DTensors (a
    DeviceMesh) is stepped as a local map (``_mamba_step_local``)."""
    xz = x[:, 0] @ params["in_proj"]
    u, z = torch.chunk(xz, 2, dim=-1)                      # (B,din)
    if is_dtensor(state["conv"]):
        return _mamba_step_local(params, x, cfg, state, u, z)

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


def _mamba_step_local(params, x, cfg: ModelConfig, state, u, z):
    """``mamba_step`` on a state laid out as ``cache_pspecs`` says (rows
    over the data axes, d_inner over model): the causal conv and the SSM
    update run on each rank's rows and channels, with ``in_proj``'s u,
    dt and the per-channel parameters taken in the same split (a
    parameter laid out otherwise is redistributed, never the state); the
    projections between them are DTensor products.  The new state is
    each rank's own block."""
    conv_s, ssm_s = state["conv"], state["ssm"]
    mesh, cpl = conv_s.device_mesh, tuple(conv_s.placements)
    B, din = conv_s.shape[0], conv_s.shape[2]
    rows_ch = keep_dims(cpl, {0: 0, 2: 1})                 # (B, din)
    rows = keep_dims(cpl, {0: 0})                          # (B, ds)
    ch = keep_dims(cpl, {2: 0})                            # (din, ...)
    u_l = local_part(u, mesh, rows_ch)
    window = torch.cat([conv_s.to_local(), u_l[:, None]], dim=1)
    conv = torch.einsum("bcd,cd->bd", window,
                        local_part(params["conv_w"], mesh,
                                   keep_dims(cpl, {2: 1})))
    u_act = F.silu(conv + local_part(params["conv_b"], mesh, ch)).to(
        torch.float32)

    u_act_d = as_dtensor(u_act, mesh, rows_ch, (B, din))
    dt, Bm, Cm = _ssm_inputs(params, u_act_d[:, None].to(x.dtype), cfg)
    A = -torch.exp(local_part(params["A_log"], mesh, ch))
    h, y = _ssm_step(ssm_s.to_local(), (
        u_act, local_part(dt[:, 0], mesh, rows_ch),
        local_part(Bm[:, 0], mesh, rows), local_part(Cm[:, 0], mesh, rows)), A)
    y = y + u_act * local_part(params["D"], mesh, ch).to(torch.float32)
    y = as_dtensor(y.to(x.dtype), mesh, rows_ch, (B, din))
    out = (y * F.silu(z))[:, None] @ params["out_proj"]
    return out, {"conv": as_dtensor(window[:, 1:], mesh, cpl, conv_s.shape),
                 "ssm": as_dtensor(h, mesh, tuple(ssm_s.placements),
                                   ssm_s.shape)}


def init_mamba_state(cfg: ModelConfig, batch: int, dtype, device="cpu") -> dict:
    return {
        "conv": torch.zeros((batch, cfg.mamba_d_conv - 1, cfg.mamba_d_inner),
                            dtype=dtype, device=device),
        "ssm": torch.zeros((batch, cfg.mamba_d_inner, cfg.mamba_d_state),
                           dtype=torch.float32, device=device),
    }
