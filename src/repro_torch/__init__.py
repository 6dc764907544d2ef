"""repro_torch — the BFLC round in PyTorch, with hand-written CUDA kernels.

A port of ``repro`` (the JAX reference package) for one NVIDIA H100.  The
layout mirrors the reference module for module so each file's counterpart
is easy to find:

  kernels/   int8 chain codec + fused int8 aggregation (CUDA C++ under
             ``kernels/csrc``, each beside a plain PyTorch version)
  core/      chain, committee consensus, election, nodes, incentives,
             attacks, aggregation, the off-chain store
  data/      the synthetic FEMNIST-like community and the Markov-chain LM
             data (numpy, bit-equal to the reference's generators)
  configs/   the FEMNIST CNN over the reference's parameter dict, and the
             LM zoo's arch registry (``registry.get_config``)
  fl/        client local SGD and scoring, the round pipeline, the runtime
  models/    the LM zoo's dense attention decoders (init, forward,
             prefill, decode with a KV cache)
  optim/     SGD and AdamW over dicts of tensors, learning-rate schedules
  checkpoint/  msgpack checkpoints in the reference's format (a msgpack
             subset of the package's own)
  launch/    the train / prefill / decode steps, the training CLI and the
             serving CLI
  serve/     the continuous-batching engine that hot-swaps to each model
             block the chain commits or each checkpoint a trainer writes
  api.py     ``build_runtime``

Parameters are plain dicts of tensors with the reference's key names and
layouts (NHWC images, HWIO conv kernels, (in, out) dense weights, an LM's
stacked ``units`` leaves and ``tail`` tuple).  This
package imports torch and numpy only — never jax, and nothing of ``repro``.
"""
