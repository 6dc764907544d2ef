"""The sharded round engine's data layout, in one place.

Port of ``round_engine_pspecs`` / ``score_matrix_pspecs`` of
``repro/launch/shardings.py``.  Where the reference names a
``PartitionSpec`` over the 1-D ``("data",)`` mesh, each entry here is the
tensor dimension split over the mesh's ranks, or None for a tensor every
rank holds whole.  The sharded programs (``repro_torch.fl.client``,
``repro_torch.kernels.ops``) and stages (``repro_torch.fl.sharded``) split
with ``RoundMesh.shard`` and gather with ``RoundMesh.gather`` by these
dictionaries.  The LM's specs (``ShardingPolicy``, ``param_pspecs``,
``batch_pspecs``, ``cache_pspecs``) wait with the expert-parallel MoE
(ROADMAP.md Queue 1 item 11).
"""
from __future__ import annotations


def round_engine_pspecs() -> dict:
    """* ``clients``    — client-stacked leaves (P, ...): P split (local
      training batches in, update stacks out);
    * ``dshard``     — (K, Dpad) int8 stack and (K, nblk) scales: D split
      (each rank quantizes / reduces its slice);
    * ``dvec``       — (Dpad,) aggregated flat update: D split (gathered
      into the model block);
    * ``replicated`` — global params and the (K,) weight vector."""
    return {"clients": 0, "dshard": 1, "dvec": 0, "replicated": None}


def score_matrix_pspecs() -> dict:
    """* ``updates``    — candidate-stacked leaves (P, ...): P split (the
      update rows arrive split from the trainer);
    * ``int8_rows``  — (P, Dpad) int8 rows + (P, nblk) scales of the fused
      score-from-int8 path: P split (tiles are row-local, so the blobs
      equal the single-device codec's);
    * ``scores``     — the (P, Q) score matrix: P split, gathered at the
      validate stage's boundary;
    * ``replicated`` — global params and the (Q, vb, ...) member val
      batches."""
    return {"updates": 0, "int8_rows": 0, "scores": 0, "replicated": None}
