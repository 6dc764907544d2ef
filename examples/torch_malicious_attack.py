"""Fig.4-style demo on the PyTorch port: BFLC vs FedAvg vs CwMed under a
collusive Gaussian-perturbation attack (30% malicious nodes).

The port of ``examples/malicious_attack.py``, with its sizes; it runs on
the GPU unless ``--device cpu`` is given.

  PYTHONPATH=src python examples/torch_malicious_attack.py
  PYTHONPATH=src python examples/torch_malicious_attack.py --device cpu
"""
import argparse

from repro_torch.data import make_femnist_like
from repro_torch.fl import (
    BFLCConfig,
    BFLCRuntime,
    FLConfig,
    FLTrainer,
    femnist_adapter,
)

MAL = 0.3


def main(argv=None):
    """Runs the demo and returns {"bflc": BFLCRuntime, "fedavg": FLTrainer,
    "cwmed": FLTrainer}."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--rounds", type=int, default=15)
    ap.add_argument("--clients", type=int, default=60)
    ap.add_argument("--local-steps", type=int, default=20)
    args = ap.parse_args(argv)
    rounds, eval_every = args.rounds, min(5, args.rounds)

    ds = make_femnist_like(num_clients=args.clients, mean_samples=80,
                           test_size=800, seed=1)
    adapter = femnist_adapter(width=16)

    print(f"=== BFLC with {MAL:.0%} malicious (collusive scoring) ===")
    cfg = BFLCConfig(active_proportion=0.3, committee_fraction=0.3,
                     k_updates=6, local_steps=args.local_steps,
                     local_lr=0.02, malicious_fraction=MAL,
                     attack="gaussian", attack_sigma=1.0, collusion=True,
                     seed=0)
    rt = BFLCRuntime(adapter, ds, cfg, device=args.device)
    logs = rt.run(rounds, eval_every=eval_every)
    packed_mal = sum(l.packed_malicious for l in logs)
    print(f"malicious updates packed on-chain: {packed_mal} / "
          f"{rounds * cfg.k_updates}")
    print(f"final accuracy: {logs[-1].test_accuracy:.3f}")
    print("chain verify:", rt.chain.verify())
    runs = {"bflc": rt}

    for name, agg in (("Basic FL (FedAvg)", "fedavg"), ("CwMed", "cwmed")):
        print(f"\n=== {name} with {MAL:.0%} malicious ===")
        fl = FLTrainer(adapter, ds, FLConfig(
            active_proportion=0.3, local_steps=args.local_steps,
            local_lr=0.02, aggregation=agg, malicious_fraction=MAL,
            attack="gaussian", attack_sigma=1.0, seed=0), device=args.device)
        accs = fl.run(rounds, eval_every=eval_every)
        print(f"final accuracy: {accs[-1]:.3f}")
        runs[agg] = fl
    return runs


if __name__ == "__main__":
    main()
