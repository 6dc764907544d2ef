"""Hot-swap parameter sources: where the serving engine gets fresh weights.

Port of ``repro/serve/params.py``.  BFLC stores the global model on-chain
(paper §III.A), so a serving node can always read the latest
committee-approved parameters.  The engine polls a source at tick
boundaries and swaps the whole parameter tree in one assignment:
in-flight requests keep their KV caches and continue decoding under the
new weights (no drain, no drop).

``ChainParamSource`` watches a live ``repro_torch.core.blockchain.Chain``.
The reference's ``CheckpointParamSource`` (a snapshot directory of
``model_round_<t>.msgpack`` files) waits for the checkpoint module,
ROADMAP.md Queue 1 item 13; ``checkpoint_name`` is its file naming.
"""
from __future__ import annotations

from typing import Any, Optional, Tuple


def checkpoint_name(round_t: int) -> str:
    return f"model_round_{round_t}.msgpack"


class ChainParamSource:
    """Poll a live chain for a newer model block (O(1) latest-model read)."""

    def __init__(self, chain):
        self.chain = chain
        self._seen = chain.current_round

    def poll(self) -> Optional[Tuple[int, Any]]:
        r = self.chain.current_round
        if r <= self._seen:
            return None
        self._seen = r
        round_t, model = self.chain.latest_model()
        return round_t, model

    @property
    def version(self) -> int:
        return self._seen
