"""End-to-end training: the LM trainer and the BFLC rounds.

Port of ``repro/launch/train.py``, with its flags and defaults, plus
``--device`` (CUDA unless ``cpu`` is asked for).  Two entry modes:

* ``--driver fl``   — the paper's pipeline: BFLC over federated clients
  (synthetic FEMNIST-like data, CNN global model) through
  ``repro_torch.api.build_runtime``.
* ``--driver lm``   — the production pipeline on one card: a
  ~100M-parameter decoder (``lm_100m_config``: 116,411,136 params)
  trained on synthetic Markov-chain data with ``launch/steps.py``'s train
  step, in ``standard`` or ``bflc`` (committee-weighted) mode.
  ``--use-all-devices`` is accepted for the reference's command lines and
  means the one device: the LM's sharded step waits with the LM mesh
  (ROADMAP.md Queue 1 item 11).

Examples:
  PYTHONPATH=src python -m repro_torch.launch.train --driver lm --steps 200
  PYTHONPATH=src python -m repro_torch.launch.train --driver lm --small \\
      --steps 20 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --driver fl --rounds 30

``run_lm(args, on_step=...)`` calls ``on_step(step, state, metrics)``
after each step (the metrics are tensors still on the device), for
callers that time or profile the loop.
"""
from __future__ import annotations

import argparse
import time

import numpy as np


def lm_100m_config(vocab: int = 8192):
    from repro_torch.models.config import ModelConfig, dense_unit

    return ModelConfig(
        name="repro-100m",
        arch_type="dense",
        d_model=768,
        vocab_size=vocab,
        unit=dense_unit(1),
        num_units=12,
        num_heads=12,
        num_kv_heads=4,
        d_ff=3072,
        remat=False,
    )


def lm_batch(lm, rng: np.random.Generator, batch: int, seq: int, device):
    """One batch of the Markov chain's tokens on ``device``: targets are the
    next tokens, every position counts in the loss."""
    import torch

    from repro_torch.device import to_device
    from repro_torch.models.transformer import Batch

    toks, tgts = lm.batch(rng, batch, seq)
    B, S = toks.shape
    return Batch(
        tokens=to_device(toks, device),
        positions=torch.arange(S, dtype=torch.int32,
                               device=device)[None].expand(B, S),
        targets=to_device(tgts, device),
        loss_mask=torch.ones((B, S), dtype=torch.float32, device=device),
    )


def run_lm(args, on_step=None):
    import torch

    from repro_torch.data.lm_synthetic import MarkovLM
    from repro_torch.device import resolve_device
    from repro_torch.launch.steps import TrainState, make_train_step
    from repro_torch.models import init_model
    from repro_torch.optim import adamw, linear_warmup_cosine
    from repro_torch.tree import tree_leaves

    device = resolve_device(getattr(args, "device", "cuda"))
    cfg = lm_100m_config(vocab=getattr(args, "vocab", 8192))
    if args.small:
        cfg = cfg.replace(num_units=4, d_model=256, num_heads=8,
                          num_kv_heads=4, d_ff=1024)
    opt = adamw(linear_warmup_cosine(args.lr, 20, args.steps))
    params = init_model(torch.Generator(device=device).manual_seed(0), cfg)
    n_params = sum(t.numel() for t in tree_leaves(params))
    print(f"model: {n_params/1e6:.1f}M params, device {device}")

    step_fn = make_train_step(
        cfg, opt, mode=args.mode,
        num_cohorts=args.cohorts, committee_size=args.committee,
    )
    state = TrainState(params, opt.init(params),
                       torch.zeros((), dtype=torch.int32, device=device))
    del params

    lm = MarkovLM(cfg.vocab_size, seed=1)
    rng = np.random.default_rng(0)
    print(f"chain entropy (loss floor): {lm.entropy():.3f} nats; "
          f"ln(V) = {np.log(cfg.vocab_size):.3f}")

    t0 = time.perf_counter()
    for step in range(args.steps):
        batch = lm_batch(lm, rng, args.batch, args.seq, device)
        val = lm_batch(lm, rng, max(args.committee, 1), args.seq, device) \
            if args.mode == "bflc" else None
        state, metrics = step_fn(state, batch, val)
        if on_step is not None:
            on_step(step, state, metrics)
        if (step + 1) % args.log_every == 0 or step == 0:
            print(f"step {step+1:4d}  loss {float(metrics['loss']):.4f}  "
                  f"({(time.perf_counter()-t0)/(step+1):.2f}s/step)")
    if args.ckpt:
        from repro_torch.checkpoint import save_pytree
        save_pytree(args.ckpt, state.params)
        print("saved", args.ckpt)
    return float(metrics["loss"])


def run_fl(args):
    from repro_torch.api import build_runtime
    from repro_torch.data import make_femnist_like
    from repro_torch.fl import femnist_adapter

    ds = make_femnist_like(
        num_clients=args.clients, mean_samples=80, test_size=1000, seed=1
    )
    adapter = femnist_adapter(width=16)
    rt = build_runtime(adapter, ds, dict(
        active_proportion=args.active, k_updates=args.k_updates,
        local_steps=args.local_steps, malicious_fraction=args.malicious,
        seed=args.seed,
    ), device=getattr(args, "device", "cuda"))
    logs = rt.run(args.rounds, eval_every=args.log_every)
    for lg in logs:
        if lg.test_accuracy is not None:
            print(f"round {lg.round:3d}  acc {lg.test_accuracy:.4f}  "
                  f"packed_malicious {lg.packed_malicious}")
    if not rt.chain.verify():
        raise RuntimeError("chain integrity violated")
    print(f"chain height {rt.chain.height}, verified OK")
    return logs[-1].test_accuracy


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description="Train the repro-100m LM (--driver lm) or run BFLC "
                    "rounds over federated clients (--driver fl).")
    ap.add_argument("--driver", choices=["lm", "fl"], default="lm")
    # lm
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--vocab", type=int, default=8192)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--mode", choices=["standard", "bflc"], default="standard")
    ap.add_argument("--cohorts", type=int, default=4)
    ap.add_argument("--committee", type=int, default=4)
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--use-all-devices", action="store_true",
                    help="accepted; the port trains on one device")
    ap.add_argument("--ckpt", default="")
    ap.add_argument("--log-every", type=int, default=10)
    # fl
    ap.add_argument("--clients", type=int, default=100)
    ap.add_argument("--rounds", type=int, default=30)
    ap.add_argument("--active", type=float, default=0.2)
    ap.add_argument("--k-updates", type=int, default=8)
    ap.add_argument("--local-steps", type=int, default=20)
    ap.add_argument("--malicious", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.driver == "lm":
        run_lm(args)
    else:
        run_fl(args)


if __name__ == "__main__":
    main()
