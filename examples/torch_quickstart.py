"""Quickstart on the PyTorch port: decentralized federated learning with
committee consensus.

Trains the paper's CNN on a synthetic FEMNIST-like federated dataset under
BFLC, prints per-round consensus stats, and verifies the chain.  The port
of ``examples/quickstart.py``, with its sizes; it runs on the GPU unless
``--device cpu`` is given.

  PYTHONPATH=src python examples/torch_quickstart.py
  PYTHONPATH=src python examples/torch_quickstart.py --device cpu --rounds 2
"""
import argparse

from repro_torch.data import make_femnist_like
from repro_torch.fl import BFLCConfig, BFLCRuntime, femnist_adapter


def main(argv=None, initial_params=None):
    """Runs the demo and returns the runtime.  ``initial_params`` warm-starts
    the model (a tree of tensors or numpy arrays) in place of the port's
    own seeded init."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--rounds", type=int, default=20)
    ap.add_argument("--clients", type=int, default=60)
    ap.add_argument("--local-steps", type=int, default=20)
    args = ap.parse_args(argv)

    print(f"Generating federated dataset ({args.clients} writers, "
          f"non-IID)...")
    dataset = make_femnist_like(num_clients=args.clients, mean_samples=80,
                                test_size=800, seed=1)
    adapter = femnist_adapter(width=16)

    cfg = BFLCConfig(
        active_proportion=0.3,      # k% of nodes participate per round
        committee_fraction=0.4,     # of active nodes -> committee
        k_updates=6,                # update blocks per round (chain layout k)
        local_steps=args.local_steps,
        local_lr=0.02,
        election_method="by_score",
        seed=0,
    )
    runtime = BFLCRuntime(adapter, dataset, cfg, initial_params=initial_params,
                          device=args.device)
    print(f"community: {dataset.num_clients} nodes | committee "
          f"{runtime.q_committee} | trainers/round {runtime.p_trainers} | "
          f"device {runtime.device}")

    for r in range(args.rounds):
        log = runtime.run_round(eval_test=(r % 5 == 4))
        line = (f"round {log.round:2d}: packed score "
                f"{log.mean_packed_score:.3f}, P*Q validations "
                f"{log.consensus_validations}")
        if log.test_accuracy is not None:
            line += f", test acc {log.test_accuracy:.3f}"
        print(line)

    print(f"\nchain height: {runtime.chain.height} "
          f"(1 genesis + {args.rounds} rounds x (1 model + "
          f"{cfg.k_updates} updates))")
    print("chain verify:", runtime.chain.verify())
    t, _ = runtime.chain.latest_model()
    print(f"latest model block: round {t} at height "
          f"{runtime.chain.model_index(t)} (O(1) lookup)")
    return runtime


if __name__ == "__main__":
    main()
