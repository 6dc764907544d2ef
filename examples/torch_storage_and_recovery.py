"""§IV.D + §IV.C demo on the PyTorch port: chain storage schemes and
post-attack failback.

1. trains a few BFLC rounds,
2. shows the three storage schemes (full / pruned / off-chain) and the int8
   update codec,
3. simulates a successful poisoning of the latest model block and recovers
   by failing back to a historical model block (the paper's §IV.C remedy).

The port of ``examples/storage_and_recovery.py``, with its sizes; it runs
on the GPU unless ``--device cpu`` is given.

  PYTHONPATH=src python examples/torch_storage_and_recovery.py
  PYTHONPATH=src python examples/torch_storage_and_recovery.py --device cpu
"""
import argparse

import torch

from repro_torch.core.blockchain import Chain
from repro_torch.core.storage import OffChainStore
from repro_torch.data import make_femnist_like
from repro_torch.fl import BFLCConfig, BFLCRuntime, femnist_adapter
from repro_torch.kernels.ops import dequantize_pytree, quantize_pytree
from repro_torch.tree import ravel_pytree, tree_leaves, tree_map


def nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def main(argv=None):
    """Runs the demo and returns its figures: pruned payload count, bytes
    before and after, the codec's ratio and round-trip error, the off-chain
    chain's resident bytes, the three accuracies and verify()."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--rounds", type=int, default=6)
    ap.add_argument("--clients", type=int, default=40)
    args = ap.parse_args(argv)

    ds = make_femnist_like(num_clients=args.clients, mean_samples=60,
                           test_size=400, seed=4)
    adapter = femnist_adapter(width=8)
    cfg = BFLCConfig(active_proportion=0.5, committee_fraction=0.4,
                     k_updates=6, local_steps=10, seed=0)
    rt = BFLCRuntime(adapter, ds, cfg, device=args.device)
    rt.run(args.rounds, eval_every=args.rounds)
    chain = rt.chain
    out = {"bytes_full": chain.storage_bytes()}
    print(f"chain height {chain.height}, resident bytes "
          f"{out['bytes_full']/1e6:.2f} MB")

    # --- storage optimization (§IV.D) ---
    out["pruned"] = chain.prune(keep_rounds=2)
    out["bytes_pruned"] = chain.storage_bytes()
    out["verify"] = chain.verify()
    print(f"pruned {out['pruned']} historical payloads -> "
          f"{out['bytes_pruned']/1e6:.2f} MB; verify={out['verify']}")

    # off-chain scheme: the chain keeps only the payload's digest
    off = Chain(cfg.k_updates, off_chain_store=OffChainStore())
    off.append_model(rt.global_params(), 0)
    out["bytes_off_chain"] = off.storage_bytes()
    print(f"off-chain model block: {out['bytes_off_chain']} B resident, "
          f"{off.store.size()} payload in the store; verify={off.verify()}")

    # int8 codec for a model-sized update (beyond-paper)
    update = tree_map(lambda x: 0.01 * torch.ones_like(x), rt.global_params())
    blob, unravel = quantize_pytree(update)
    raw = sum(nbytes(x) for x in tree_leaves(update))
    packed = nbytes(blob["q"]) + nbytes(blob["scales"])
    out["codec_ratio"] = raw / packed
    decoded = ravel_pytree(dequantize_pytree(blob, unravel))[0]
    out["codec_max_err"] = float((decoded - ravel_pytree(update)[0])
                                 .abs().max())
    print(f"int8 update codec: {raw} B -> {packed} B "
          f"({out['codec_ratio']:.1f}x), round-trip max error "
          f"{out['codec_max_err']:.2e}")

    # --- failback (§IV.C) ---
    t, good = chain.latest_model()
    out["acc_before"] = rt.evaluate()
    # a malicious committee majority packs a poisoned model block
    gen = torch.Generator(device=rt.device).manual_seed(0)
    poisoned = tree_map(
        lambda x: torch.randn(x.shape, generator=gen, device=x.device,
                              dtype=x.dtype), good)
    for _ in range(chain.k):
        chain.append_update(update, uploader=0, score=0.99)
    chain.append_model(poisoned, t + 1)
    out["acc_poisoned"] = rt.evaluate()
    # recovery: any honest node replays from a historical model block
    recovered = chain.model_at_round(t)
    rt.chain = Chain(cfg.k_updates)
    rt.chain.append_model(recovered, 0)
    out["acc_recovered"] = rt.evaluate()
    print(f"accuracy before={out['acc_before']:.3f} "
          f"poisoned={out['acc_poisoned']:.3f} "
          f"recovered={out['acc_recovered']:.3f}")
    assert abs(out["acc_recovered"] - out["acc_before"]) < 1e-6
    return out


if __name__ == "__main__":
    main()
