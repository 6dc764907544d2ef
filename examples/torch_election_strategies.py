"""§IV.B demo on the PyTorch port: compare the three committee-election
strategies under a moderate malicious presence.

The port of ``examples/election_strategies.py``, with its sizes; it runs
on the GPU unless ``--device cpu`` is given.

  PYTHONPATH=src python examples/torch_election_strategies.py
  PYTHONPATH=src python examples/torch_election_strategies.py --device cpu
"""
import argparse

from repro_torch.core.election import BY_SCORE, MULTI_FACTOR, RANDOM
from repro_torch.data import make_femnist_like
from repro_torch.fl import BFLCConfig, BFLCRuntime, femnist_adapter


def main(argv=None, initial_params=None):
    """Runs the demo and returns {method: runtime}.  ``initial_params``
    warm-starts every runtime in place of the port's own seeded init."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--rounds", type=int, default=12)
    ap.add_argument("--clients", type=int, default=60)
    ap.add_argument("--local-steps", type=int, default=15)
    args = ap.parse_args(argv)

    ds = make_femnist_like(num_clients=args.clients, mean_samples=80,
                           test_size=600, seed=1)
    adapter = femnist_adapter(width=16)
    runtimes = {}
    for method in (RANDOM, BY_SCORE, MULTI_FACTOR):
        cfg = BFLCConfig(active_proportion=0.3, committee_fraction=0.4,
                         k_updates=6, local_steps=args.local_steps,
                         local_lr=0.02, malicious_fraction=0.2,
                         attack_sigma=1.0, election_method=method, seed=0)
        rt = BFLCRuntime(adapter, ds, cfg, initial_params=initial_params,
                         device=args.device)
        logs = rt.run(args.rounds, eval_every=args.rounds)
        packed_mal = sum(l.packed_malicious for l in logs)
        print(f"{method:13s}: final acc {logs[-1].test_accuracy:.3f}, "
              f"malicious packed {packed_mal}/{args.rounds * cfg.k_updates}")
        runtimes[method] = rt
    return runtimes


if __name__ == "__main__":
    main()
