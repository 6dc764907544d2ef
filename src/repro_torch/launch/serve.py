"""Serving CLI: continuous-batching engine (default) or the static-batch
baseline over the same prefill / decode steps.

Port of ``repro/launch/serve.py``, with its flags and defaults, plus
``--device`` (CUDA unless ``cpu`` is asked for):

  PYTHONPATH=src python -m repro_torch.launch.serve --arch olmo-1b --smoke \\
      --device cpu

Every decoder of the registry serves: the dense ones, the MoE archs
(mixtral-8x7b, qwen3-moe-30b-a3b; the dense MoE path), rwkv6-7b and
jamba-1.5-large-398b (their recurrent states ride in the decode cache)
and qwen2-vl-7b (text prompts, M-RoPE positions on all three streams);
hubert-xlarge is an encoder.

``--static`` switches the admission policy to the whole-batch barrier
(all requests of a batch start and finish together).  The heavy lifting
lives in ``repro_torch.serve``; this module only parses flags, builds the
model from a seeded generator and the trace, and prints the measured
metrics.
"""
from __future__ import annotations

import argparse
import json


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="olmo-1b")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced smoke config (CPU-friendly)")
    ap.add_argument("--slots", type=int, default=4,
                    help="decode-batch slot capacity")
    ap.add_argument("--max-len", type=int, default=96,
                    help="KV cache length (prompt + generation budget)")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--rate", type=float, default=20.0,
                    help="Poisson arrival rate (requests/s)")
    ap.add_argument("--prompt-lens", type=int, nargs="+",
                    default=[16, 32, 48, 64])
    ap.add_argument("--gen-lens", type=int, nargs="+", default=[8, 16, 32])
    ap.add_argument("--static", action="store_true",
                    help="static-batch baseline admission policy")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    import torch

    from repro_torch.configs import registry
    from repro_torch.device import resolve_device
    from repro_torch.models import init_model
    from repro_torch.serve import ServeEngine, make_poisson_trace

    device = resolve_device(args.device)
    cfg = (registry.smoke_config(args.arch) if args.smoke
           else registry.get_config(args.arch))
    if not cfg.is_decoder():
        raise SystemExit(f"{args.arch} is encoder-only: no decode step")
    need = max(args.prompt_lens) + max(args.gen_lens) - 1
    if need > args.max_len:
        raise SystemExit(
            f"--max-len {args.max_len} too small for prompt+gen {need}")

    params = init_model(torch.Generator(device=device).manual_seed(0), cfg)
    engine = ServeEngine(cfg, params, num_slots=args.slots,
                         max_len=args.max_len, device=device)
    trace = make_poisson_trace(
        num_requests=args.requests, rate=args.rate,
        prompt_lens=args.prompt_lens, gen_lens=args.gen_lens,
        vocab_size=cfg.vocab_size, seed=args.seed,
    )
    engine.warmup(args.prompt_lens)

    policy = "static" if args.static else "continuous"
    report = engine.run(trace, policy=policy)
    m = report.metrics()
    print(f"# {policy} serving, {args.arch}"
          f"{' (smoke)' if args.smoke else ''}, slots={args.slots}, "
          f"device={device}")
    print(json.dumps(m, indent=2))
    sample = report.results[0]
    print("sample token ids:", sample.tokens[:16])


if __name__ == "__main__":
    main()
