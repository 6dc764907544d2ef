"""Flash attention in plain PyTorch with a recompute-based backward.

Port of ``repro/models/flash.py`` on one card.  The forward is the
online softmax over KV blocks of ``KV_BLOCK`` keys: a running max ``m``,
a running sum ``l`` and an accumulator, masked scores set to ``NEG_INF``,
``l`` clamped at 1e-30 and the log-sum-exp saved.  Q blocks are a
batched dimension, as in the reference: every tensor is blocked into the
canonical layout (B, nq, Kv, G, QB, ...), and one Python loop walks the
KV blocks where the reference ``lax.scan``s.

``FlashAttention`` is a ``torch.autograd.Function`` whose backward
recomputes P a block at a time from (q, k, v, out, lse), the reference's
custom VJP: autograd through the forward's loop would keep every P block
alive for the backward (about 100 GB at hubert-xlarge's width and
S = 4096).

GQA layout: q (B,Sq,H,Dh); k,v (B,Skv,Kv,Dh); H = Kv*G.  On a mesh
(DTensor inputs), ``block_spec`` is the reference's 6-entry spec over the
canonical (B, nq, Kv, G, QB, Dh) layout: entry 0 the batch's axes, entry
1 the axis Q blocks are split over, entry 2 the axis heads are split
over.  The reference pins q, the carries and lse to it and lets GSPMD
split the einsums; here the same layout is a local map (the reference's
blocks never talk to each other): q, k, v and the positions are
redistributed to it, each rank runs ``FlashAttention`` on its local
blocks, and the output is a DTensor in the same layout.  DTensor's own
sharding rules are not used inside, because they cannot view the
blocked dims of a tensor split over both mesh axes.  ``pick_q_block``
picks a q-block size whose block count the model axis divides.
"""
from __future__ import annotations

import torch

KV_BLOCK = 512
NEG_INF = -1e30


def pick_q_block(seq: int, model_size: int, max_block: int = 512) -> int:
    """Largest block <= max_block such that (seq/block) % model_size == 0
    (falls back to max_block when impossible)."""
    for qb in (512, 256, 128, 64):
        if qb > max_block:
            continue
        nq = seq // qb
        if seq % qb == 0 and nq % model_size == 0:
            return qb
    return max_block


def _pair_mask(q_pos, kv_pos, *, causal: bool, window: int):
    q = q_pos[..., :, None]
    k = kv_pos[..., None, :]
    ok = k >= 0
    if causal:
        ok = ok & (k <= q)
    if window > 0:
        ok = ok & (q - k < window)
    return ok


def _block_q(t, nq, q_block, Kv, G, Dh):
    """(B,Sq,H,Dh) -> canonical (B,nq,Kv,G,QB,Dh)."""
    B = t.shape[0]
    return t.reshape(B, nq, q_block, Kv, G, Dh).permute(0, 1, 3, 4, 2, 5)


def _unblock_q(t, B, Sq, H, Dh):
    """(B,nq,Kv,G,QB,Dh) -> (B,Sq,H,Dh)."""
    return t.permute(0, 1, 4, 2, 3, 5).reshape(B, Sq, H, Dh)


def _shapes(q, k, q_block):
    B, Sq, H, Dh = q.shape
    Skv, Kv = k.shape[1], k.shape[2]
    if Sq % q_block or Skv % KV_BLOCK:
        raise ValueError(
            f"flash attention needs Sq % {q_block} == 0 and Skv % {KV_BLOCK} "
            f"== 0, got Sq = {Sq}, Skv = {Skv}")
    if H % Kv:
        raise ValueError(f"{H} query heads over {Kv} KV heads")
    return B, Sq, H, Dh, Skv, Kv, H // Kv, Sq // q_block, Skv // KV_BLOCK


def _kv_blocks(k, v, kv_pos, nk):
    """The j-th KV block: (B,KB,Kv,Dh) keys and values (float32) and its
    (B,1,KB) positions."""
    for j in range(nk):
        sl = slice(j * KV_BLOCK, (j + 1) * KV_BLOCK)
        yield (k[:, sl].to(torch.float32), v[:, sl].to(torch.float32),
               kv_pos[:, None, sl])


def _scores(qf, kb, qp, kpb, causal, window):
    s = torch.einsum("bnkgqd,bskd->bnkgqs", qf, kb)
    mask = _pair_mask(qp, kpb, causal=causal, window=window)
    return s.masked_fill(~mask[:, :, None, None], NEG_INF)


def _forward(q, k, v, q_pos, kv_pos, causal, window, q_block):
    B, Sq, H, Dh, Skv, Kv, G, nq, nk = _shapes(q, k, q_block)
    qf = _block_q(q.to(torch.float32) * (Dh ** -0.5), nq, q_block, Kv, G, Dh)
    qp = q_pos.reshape(B, nq, q_block)
    m = torch.full((B, nq, Kv, G, q_block), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((B, nq, Kv, G, q_block, Dh), dtype=torch.float32,
                      device=q.device)
    for kb, vb, kpb in _kv_blocks(k, v, kv_pos, nk):
        s = _scores(qf, kb, qp, kpb, causal, window)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        scale = torch.exp(m - m_new)
        l = l * scale + p.sum(dim=-1)
        acc = acc * scale[..., None] + torch.einsum("bnkgqs,bskd->bnkgqd", p,
                                                    vb)
        m = m_new
    l_safe = torch.clamp(l, min=1e-30)
    out = acc / l_safe[..., None]                       # (B,nq,Kv,G,QB,Dh)
    lse = m + torch.log(l_safe)
    return _unblock_q(out, B, Sq, H, Dh).to(q.dtype), lse


def _backward(q, k, v, q_pos, kv_pos, out, lse, dout, causal, window, q_block):
    B, Sq, H, Dh, Skv, Kv, G, nq, nk = _shapes(q, k, q_block)
    scale = Dh ** -0.5
    qf = _block_q(q.to(torch.float32) * scale, nq, q_block, Kv, G, Dh)
    dof = _block_q(dout.to(torch.float32), nq, q_block, Kv, G, Dh)
    of = _block_q(out.to(torch.float32), nq, q_block, Kv, G, Dh)
    qp = q_pos.reshape(B, nq, q_block)
    delta = (dof * of).sum(dim=-1)                      # (B,nq,Kv,G,QB)
    dq = torch.zeros_like(qf)
    dks, dvs = [], []
    for kb, vb, kpb in _kv_blocks(k, v, kv_pos, nk):
        s = _scores(qf, kb, qp, kpb, causal, window)
        p = torch.exp(s - lse[..., None])               # (B,nq,Kv,G,QB,KB)
        dp = torch.einsum("bnkgqd,bskd->bnkgqs", dof, vb)
        ds = p * (dp - delta[..., None])
        dq = dq + torch.einsum("bnkgqs,bskd->bnkgqd", ds, kb)
        dks.append(torch.einsum("bnkgqs,bnkgqd->bskd", ds, qf))
        dvs.append(torch.einsum("bnkgqs,bnkgqd->bskd", p, dof))
    dq = (_unblock_q(dq, B, Sq, H, Dh) * scale).to(q.dtype)
    dk = torch.cat(dks, dim=1).to(k.dtype)
    dv = torch.cat(dvs, dim=1).to(v.dtype)
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """out = softmax(q k^T / sqrt(Dh) masked) v, saving (q, k, v, out, lse)
    and recomputing P block by block in the backward."""

    @staticmethod
    def forward(ctx, q, k, v, q_pos, kv_pos, causal, window, q_block):
        out, lse = _forward(q, k, v, q_pos, kv_pos, causal, window, q_block)
        ctx.save_for_backward(q, k, v, q_pos, kv_pos, out, lse)
        ctx.args = (causal, window, q_block)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, q_pos, kv_pos, out, lse = ctx.saved_tensors
        dq, dk, dv = _backward(q, k, v, q_pos, kv_pos, out, lse, dout,
                               *ctx.args)
        return dq, dk, dv, None, None, None, None, None


class _ContiguousGrad(torch.autograd.Function):
    """Identity whose backward hands on a contiguous gradient: DTensor
    views a local gradient as the global one's shape, which a transposed
    gradient (an einsum's) cannot give."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


def local_attention(attend, q, k, v, q_pos, kv_pos, mesh, dp, q_axis,
                    head_axis):
    """``attend(q, k, v, q_pos, kv_pos)`` on each rank's blocks: q and the
    output split as (batch over ``dp``, queries over ``q_axis``, heads
    over ``head_axis``), k and v as (batch, -, heads), whole along the
    keys, the positions as their rows.  An input's local gradient is
    declared split where the input is, a partial sum over an axis that
    splits only the output (k and v over the query axis), and replicated
    over an axis that splits neither (every rank of it computed the
    same).  Returns the output as a DTensor in q's layout."""
    from torch.distributed.tensor import DTensor, Partial, Replicate

    from repro_torch.launch.mesh import mesh_axis_names, mesh_axis_size
    from repro_torch.launch.shardings import P, placements, spec_axes

    q_spec = P(dp, q_axis, head_axis, None)
    names = mesh_axis_names(mesh)
    out_axes = spec_axes(q_spec)

    def local(t, spec):
        if not isinstance(t, DTensor):     # positions every rank holds whole
            t = DTensor.from_local(t, mesh, (Replicate(),) * len(names),
                                   run_check=False)
        pl = placements(mesh, spec)
        axes = spec_axes(spec)
        grad_pl = tuple(
            p if a in axes or mesh_axis_size(mesh, a) == 1
            else Partial() if a in out_axes else Replicate()
            for a, p in zip(names, pl))
        return _ContiguousGrad.apply(
            t.redistribute(mesh, pl).to_local(grad_placements=grad_pl))

    kv_spec = P(dp, None, head_axis, None)
    out = attend(local(q, q_spec), local(k, kv_spec), local(v, kv_spec),
                 local(q_pos, P(dp, q_axis)), local(kv_pos, P(dp, None)))
    # contiguous: the callers view the DTensor's heads as one dimension
    return DTensor.from_local(out.contiguous(), mesh,
                              placements(mesh, q_spec), run_check=False)


def _sharded(q, k, v, q_pos, kv_pos, causal, window, q_block, block_spec,
             mesh):
    """``FlashAttention`` on each rank's blocks of ``block_spec``'s layout
    (``local_attention``): batch, Q blocks and heads split as its first
    three entries say."""
    from repro_torch.launch.mesh import mesh_axis_size

    dp, q_axis, head_axis = tuple(block_spec)[:3]
    if q_axis is not None and (q.shape[1] // q_block) % mesh_axis_size(
            mesh, q_axis):
        q_axis = None      # pick_q_block found no even split: Q blocks whole
    return local_attention(
        lambda q_, k_, v_, qp, kp: FlashAttention.apply(
            q_, k_, v_, qp, kp, causal, window, q_block),
        q, k, v, q_pos, kv_pos, mesh, dp, q_axis, head_axis)


def flash_attention(q, k, v, q_pos, kv_pos, causal: bool, window: int,
                    q_block: int = 512, block_spec=None, mesh=None):
    """Returns out (B,Sq,H,Dh).  Sq % q_block == 0, Skv % KV_BLOCK == 0,
    else ``ValueError``.  With a ``block_spec`` and a ``mesh``, q, k and v
    are DTensors and so is the output (``_sharded``)."""
    if block_spec is not None and mesh is not None:
        return _sharded(q, k, v, q_pos, kv_pos, causal, window, q_block,
                        block_spec, mesh)
    return FlashAttention.apply(q, k, v, q_pos, kv_pos, causal, window,
                                q_block)
