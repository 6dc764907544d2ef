"""Hot-swap parameter sources: where the serving engine gets fresh weights.

Port of ``repro/serve/params.py``.  BFLC stores the global model on-chain
(paper §III.A), so a serving node can always read the latest
committee-approved parameters.  The engine polls a source at tick
boundaries and swaps the whole parameter tree in one assignment:
in-flight requests keep their KV caches and continue decoding under the
new weights (no drain, no drop).

Two sources:

* ``ChainParamSource``      — watches a live
  ``repro_torch.core.blockchain.Chain`` (the in-process round loop commits
  model blocks as training progresses).
* ``CheckpointParamSource`` — watches a directory for
  ``model_round_<t>.msgpack`` snapshots written through
  ``repro_torch.checkpoint`` (a serving node separate from the trainer).
  Snapshots may hold the raw f32 tree or an int8-codec chain blob; blobs
  are decoded through the chain's ``Int8UpdateCodec`` on the source's
  device (on CUDA by the dequantize kernel).
"""
from __future__ import annotations

import os
import re
from typing import Any, Optional, Tuple

from repro_torch.checkpoint import load_model_payload
from repro_torch.device import resolve_device

CKPT_RE = re.compile(r"^model_round_(\d+)\.msgpack$")


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


class CheckpointParamSource:
    """Poll a snapshot directory for a newer ``model_round_<t>.msgpack``.

    Each poll takes the newest round on disk; leaves load onto ``device``
    (CUDA unless the CPU is asked for)."""

    def __init__(self, directory: str, codec=None, start_round: int = -1,
                 device="cuda"):
        self.directory = directory
        self.codec = codec
        self.device = resolve_device(device)
        self._seen = start_round

    def _latest_on_disk(self) -> Optional[int]:
        try:
            names = os.listdir(self.directory)
        except FileNotFoundError:
            return None
        rounds = [int(m.group(1)) for n in names if (m := CKPT_RE.match(n))]
        return max(rounds) if rounds else None

    def poll(self) -> Optional[Tuple[int, Any]]:
        latest = self._latest_on_disk()
        if latest is None or latest <= self._seen:
            return None
        self._seen = latest
        path = os.path.join(self.directory, checkpoint_name(latest))
        return latest, load_model_payload(path, codec=self.codec,
                                          device=self.device)

    @property
    def version(self) -> int:
        return self._seen
