"""Swapping round stages through the registry (the pipeline API), on the
PyTorch port.

The BFLC round is seven pluggable stages (``repro_torch.fl.pipeline``).
This demo registers a custom **Packer** that bypasses the committee — it
packs the first k collected updates unweighted, exactly Basic FL's
selection rule — and runs it inside the full BFLC runtime (chain,
election, incentives untouched).  Compared against the real committee
packer and the FLTrainer baseline under a 25% malicious population: the
no-committee packer loses the poisoning filter and tracks the undefended
baseline.  The port of ``examples/custom_stage.py``, with its sizes; it
runs on the GPU unless ``--device cpu`` is given.

  PYTHONPATH=src python examples/torch_custom_stage.py
  PYTHONPATH=src python examples/torch_custom_stage.py --device cpu
"""
import argparse

from repro_torch.api import build_runtime
from repro_torch.data import make_femnist_like
from repro_torch.fl import femnist_adapter, train_standalone
from repro_torch.fl.pipeline import register


@register("packer", "no_committee")
def pack_no_committee(ctx):
    """Basic FL selection inside BFLC: first k updates, no score filter,
    uniform weights.  Chain layout still needs exactly k update blocks."""
    k = ctx.cfg.k_updates
    ids = list(ctx.updates)[:k]
    while len(ids) < k:
        ids.append(ids[0])
    ctx.packed_ids = ids
    ctx.packed_scores = [0.0] * len(ids)
    ctx.packed_updates = [ctx.updates[u] for u in ids]
    ctx.weights = None
    for i, u in enumerate(ids):
        ctx.chain.append_update(ctx.packed_updates[i], u, 0.0)


def main(argv=None):
    """Runs the demo and returns {"committee": BFLCRuntime, "no_committee":
    BFLCRuntime, "baseline": FLTrainer}."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--clients", type=int, default=36)
    ap.add_argument("--warm-steps", type=int, default=150)
    args = ap.parse_args(argv)

    ds = make_femnist_like(num_clients=args.clients, mean_samples=60,
                           test_size=400, seed=2)
    adapter = femnist_adapter(width=8)
    cfg = dict(active_proportion=0.4, committee_fraction=0.3, k_updates=4,
               local_steps=8, local_batch=32, malicious_fraction=0.25,
               attack_sigma=1.5, seed=0)
    rounds = args.rounds
    # warm start: committee validation discriminates only once honest
    # scores separate from poisoned ones (same regime as Fig. 4)
    warm, _ = train_standalone(adapter, ds, steps=args.warm_steps, batch=32,
                               lr=0.05, eval_every=10**6, device=args.device)

    rt = build_runtime(adapter, ds, cfg, initial_params=warm,
                       device=args.device)
    rt.run(rounds, eval_every=rounds)
    print(f"committee packer   : acc {rt.logs[-1].test_accuracy:.3f}, "
          f"malicious packed {sum(l.packed_malicious for l in rt.logs)}"
          f"/{rounds * rt.cfg.k_updates}")

    rt2 = build_runtime(adapter, ds, cfg, initial_params=warm,
                        stages={"packer": "no_committee"}, device=args.device)
    rt2.run(rounds, eval_every=rounds)
    assert rt2.chain.verify()
    print(f"no-committee packer: acc {rt2.logs[-1].test_accuracy:.3f}, "
          f"malicious packed {sum(l.packed_malicious for l in rt2.logs)}"
          f"/{rounds * rt2.cfg.k_updates}")

    fl = build_runtime(adapter, ds,
                       {k: cfg[k] for k in ("active_proportion",
                                            "local_steps", "local_batch",
                                            "malicious_fraction",
                                            "attack_sigma", "seed")},
                       baseline=True, initial_params=warm,
                       device=args.device)
    fl.run(rounds, eval_every=rounds)
    print(f"FLTrainer baseline : acc {fl.accuracies[-1]:.3f} "
          f"(same pipeline, committee stages no-ops)")
    return {"committee": rt, "no_committee": rt2, "baseline": fl}


if __name__ == "__main__":
    main()
