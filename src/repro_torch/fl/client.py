"""Client-side local training, batched across clients, and committee scoring.

Port of ``repro/fl/client.py``.  The round's P trainers each run momentum
SGD from the same global model, all of them in one batched pass per step.
The reference ``vmap``s one per-client XLA program, so a client's update
does not depend on which or how many clients share the call.  The port
holds the same property where the adapter gives a ``stacked_loss`` (the
FEMNIST CNN does): its products go through ``kernels.client_gemm``, one
fixed-order FMA chain an output on the card and one ``torch.mm`` a client
on the CPU, and the rest of the step is elementwise or row-wise.  An
adapter without one (``lm_adapter``) is trained by ``torch.func.vmap``
over the per-client program, whose batched products PyTorch may round
differently at another P.  Committee validation scores the (P updates x Q
members) accuracy matrix: each candidate ``params + update_i`` is built
once and all Q member batches run through it in one batched forward.  The
int8 scorer does the same for the chain codec's int8 view of each update.

The sharded round engine (``repro_torch.fl.sharded``) runs these same
programs on each rank's block of the cohort: ``make_sharded_*`` build
them once per mesh.  With a ``stacked_loss`` adapter and with the scorers
(one candidate at a time), a rank's per-client results are the
single-device program's on the same rows, so the gathered stacks equal
the single-device ones.
"""
from __future__ import annotations

from typing import Callable, Tuple

import numpy as np
import torch
from torch.func import grad, vmap

from repro_torch.device import to_device
from repro_torch.fl.adapter import ModelAdapter
from repro_torch.kernels.ops import candidates_from_quantized, quantize_stack
from repro_torch.launch.shardings import round_engine_pspecs
from repro_torch.tree import ravel_pytree, tree_leaves, tree_map


def make_one_client_fn(adapter: ModelAdapter, lr: float, momentum: float = 0.0):
    """The single-client local-SGD program: (params, xs, ys) -> update.

    xs: (steps, batch, ...), ys: (steps, batch)."""
    loss_grad = grad(adapter.loss)

    def one_client(params, xs, ys):
        p = params
        mu = tree_map(torch.zeros_like, params)
        for step in range(xs.shape[0]):
            g = loss_grad(p, xs[step], ys[step])
            mu = tree_map(lambda m, gg: momentum * m + gg, mu, g)
            p = tree_map(lambda pp, m: pp - lr * m, p, mu)
        return tree_map(lambda a, b: a - b, p, params)

    return one_client


def make_local_train_fn(adapter: ModelAdapter, lr: float, momentum: float = 0.0):
    """Returns train(params, xs, ys) batched over a leading client axis.

    xs: (P, steps, batch, ...), ys: (P, steps, batch).  Output: the update
    tree stacked over P (update = locally trained params - global params).
    With ``adapter.stacked_loss`` each client's row is the same bits in a
    call of any P (see the module docstring); without it the per-client
    program is ``vmap``ped."""
    if adapter.stacked_loss is None:
        return vmap(make_one_client_fn(adapter, lr, momentum),
                    in_dims=(None, 0, 0))

    def train(params, xs, ys):
        P = xs.shape[0]
        p = tree_map(lambda a: a.detach()[None].expand(P, *a.shape).clone(),
                     params)
        mu = tree_map(torch.zeros_like, p)
        for step in range(xs.shape[1]):
            live = tree_map(lambda a: a.detach().requires_grad_(), p)
            with torch.enable_grad():
                g = torch.autograd.grad(
                    adapter.stacked_loss(live, xs[:, step], ys[:, step]),
                    tree_leaves(live))
            g = iter(g)
            g = tree_map(lambda _: next(g), p)      # tree_leaves order
            mu = tree_map(lambda m, gg: momentum * m + gg, mu, g)
            p = tree_map(lambda pp, m: pp - lr * m, p, mu)
        return tree_map(lambda a, b: a - b[None], p, params)

    return train


def make_sharded_local_train_fn(adapter: ModelAdapter, lr: float, mesh,
                                momentum: float = 0.0):
    """The P-client batched program on this rank's block of clients.

    ``train(params, xs, ys)``: xs (P, steps, batch, ...) and ys (P, steps,
    batch) are the cohort's host batches, which every rank draws alike;
    the rank copies only its block of clients (split as
    ``round_engine_pspecs()["clients"]`` names) to ``mesh.device`` and
    returns that block's update tree.  The caller pads P to a multiple of
    the mesh size.  With ``adapter.stacked_loss``, a client's row does not
    depend on the other rows of its call, so the block's rows are the
    single-device program's bit for bit and padded rows leave the real
    ones unchanged; a ``vmap``ped adapter's rows may round differently."""
    batched = make_local_train_fn(adapter, lr, momentum)
    split = round_engine_pspecs()["clients"]

    def train(params, xs: np.ndarray, ys: np.ndarray):
        return batched(params, to_device(mesh.shard(xs, split), mesh.device),
                       to_device(mesh.shard(ys, split), mesh.device))

    return train


def make_score_matrix_fn(adapter: ModelAdapter):
    """Returns score(params, updates, val_x, val_y) -> (P, Q) accuracies.

    updates: P-stacked tree; val_x: (Q, vb, ...), val_y: (Q, vb).  Entry
    [i, j] = accuracy of (global + update_i) on member j's data — the
    committee's minimized validation (§III.B).  Candidates run one at a
    time, each against all Q member batches at once, which keeps the
    activations of one candidate in memory rather than P of them."""
    per_member = vmap(adapter.accuracy, in_dims=(None, 0, 0))

    @torch.no_grad()
    def score(params, updates, vx, vy):
        P = tree_leaves(updates)[0].shape[0]
        rows = []
        for i in range(P):
            candidate = tree_map(lambda p, u: p + u[i].to(p.dtype), params, updates)
            rows.append(per_member(candidate, vx, vy))
        return torch.stack(rows)

    return score


# The P x Q score matrix on a rank's block of candidates: the sharded
# validator passes the rank's P-block of the stacked updates
# (``score_matrix_pspecs()["updates"]``) with params and member batches
# whole, and gathers the block's rows.  Candidates are scored one at a
# time, so a block's rows are the single-device program's: the reference's
# name for the same program.
make_sharded_score_matrix_fn = make_score_matrix_fn


def make_score_from_int8_fn(adapter: ModelAdapter, unravel):
    """Returns score(params, stack, vx, vy) -> ((P, Q) accuracies, q, scales).

    ``stack``: (P, D) f32 flattened updates.  The stack is quantized with
    the chain codec's tiling in one launch, so the committee scores exactly
    the int8 blobs a quantizing packer stores, and the fused candidates
    kernel rebuilds every candidate ``params + dequant(q_i)`` in one read
    of the int8 rows.  Candidates are then scored one at a time, each
    against all Q member batches, as in ``make_score_matrix_fn``.  The
    per-row ``(q, scales)`` come back with the scores: they ARE the chain
    blobs, so the packer reuses them.  ``unravel`` is the chain codec's, so
    a scored candidate decodes exactly like a stored blob.  Port of the
    reference's ``_int8_score_program`` / ``make_score_from_int8_fn``."""
    per_member = vmap(adapter.accuracy, in_dims=(None, 0, 0))

    @torch.no_grad()
    def score(params, stack, vx, vy):
        q, s, D = quantize_stack(stack)
        cands = candidates_from_quantized(ravel_pytree(params)[0], q, s, D)
        scores = torch.stack([per_member(unravel(cands[i]), vx, vy)
                              for i in range(cands.shape[0])])
        return scores, q, s

    return score


def flatten_stacked_updates(stacked) -> torch.Tensor:
    """A P-stacked update tree -> (P, D) f32, on the tree's device.

    Leaves in ``tree_leaves`` order with each reshaped to (P, -1) give row
    i equal to ``ravel_pytree(update_i)`` bit for bit, so the int8 scorer
    reads the trainer's device-resident stack without unstacking it."""
    return torch.cat([l.reshape(l.shape[0], -1).to(torch.float32)
                      for l in tree_leaves(stacked)], dim=1)


def make_sharded_score_from_int8_fn(adapter: ModelAdapter, unravel):
    """The fused int8 scorer on this rank's block of candidates:
    ``score(params, block, vx, vy)`` takes the rank's P-block of the
    stacked update tree, flattens it in place (``flatten_stacked_updates``),
    quantizes the rows and scores them as ``make_score_from_int8_fn``
    does.  Returns the block's (scores, q, scales), each split on P
    (``score_matrix_pspecs()``); tiles are row-local, so the rows equal the
    single-device codec's.  The validator gathers all three."""
    program = make_score_from_int8_fn(adapter, unravel)

    def score(params, block, vx, vy):
        return program(params, flatten_stacked_updates(block), vx, vy)

    return score


def make_eval_fn(adapter: ModelAdapter, device, eval_batch: int = 512):
    """evaluate(params, images, labels) -> test accuracy, in host batches of
    ``eval_batch`` moved to ``device`` one at a time."""

    @torch.no_grad()
    def evaluate(params, images: np.ndarray, labels: np.ndarray) -> float:
        accs, n = [], len(labels)
        for i in range(0, n, eval_batch):
            x = torch.from_numpy(images[i : i + eval_batch]).to(device)
            y = torch.from_numpy(labels[i : i + eval_batch]).to(device)
            accs.append(float(adapter.accuracy(params, x, y))
                        * min(eval_batch, n - i))
        return sum(accs) / n

    return evaluate


def sample_client_batches(
    rng: np.random.Generator,
    images: np.ndarray,
    labels: np.ndarray,
    steps: int,
    batch: int,
) -> Tuple[np.ndarray, np.ndarray]:
    idx = rng.integers(0, len(labels), (steps, batch))
    return images[idx], labels[idx]
