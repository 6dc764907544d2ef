"""Off-chain payload storage (paper §IV.D second scheme).

Port of ``repro/core/storage.py``.  "The blockchain only maintains the
network address where each model or updated file is located" — here the
address is the content digest and the store is an in-process (optionally
disk-backed, one checkpoint file per digest) content-addressed KV.
"""
from __future__ import annotations

import os
from typing import Any, Dict, Optional

from repro_torch.checkpoint.ckpt import load_pytree, save_pytree


class OffChainStore:
    """Content-addressed store: digest -> payload tree."""

    def __init__(self, directory: Optional[str] = None):
        self.directory = directory
        self._mem: Dict[str, Any] = {}
        if directory:
            os.makedirs(directory, exist_ok=True)

    def put(self, digest: str, payload: Any) -> None:
        if self.directory:
            save_pytree(os.path.join(self.directory, digest), payload)
        else:
            self._mem[digest] = payload

    def get(self, digest: str) -> Any:
        if self.directory:
            return load_pytree(os.path.join(self.directory, digest))
        return self._mem[digest]

    def __contains__(self, digest: str) -> bool:
        if self.directory:
            return os.path.exists(os.path.join(self.directory, digest))
        return digest in self._mem

    def size(self) -> int:
        if self.directory:
            return len(os.listdir(self.directory))
        return len(self._mem)
