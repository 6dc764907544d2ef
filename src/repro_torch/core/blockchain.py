"""The BFLC on-chain storage pattern (paper §III.A, Fig. 2).

Port of ``repro/core/blockchain.py``.  Block kinds on one alliance chain:

* **model block** at height ``t * period`` — the round-t global model;
* **update blocks** at heights ``[t*period+1, t*period+k]`` — the k scored
  local updates of round t;
* with ``tier2_block=True``, one **committee block** per round at height
  ``t*period + k + 1`` (the tiered layout; period ``k + 2``).

The chain enforces the layout, keeps the latest model addressable in O(1),
and can prune historical payloads while headers keep the hash chain
verifiable.  Hashes are SHA-256 over (prev_hash, header fields, payload
digest).  The payload digest here hashes each leaf's sorted key path,
dtype, shape and bytes — the reference hashes JAX's tree definition
string instead, so block hashes differ between the packages while the
payloads, layout and ``verify()`` agree.
"""
from __future__ import annotations

import hashlib
import threading
from dataclasses import dataclass
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.spans import count, span
from repro_torch.tree import tree_leaves, tree_paths

MODEL = "model"
UPDATE = "update"
COMMITTEE = "committee"


# A device leaf reaches the hash through two pinned host buffers of this many
# bytes, reused for the life of the process: the copy of one chunk runs while
# the host hashes the one before, and no round allocates host memory for it.
DIGEST_CHUNK = 64 << 20
_staging: List[torch.Tensor] = []
_staging_lock = threading.Lock()


def _np_dtype_str(dtype: torch.dtype) -> str:
    return torch.empty((), dtype=dtype).numpy().dtype.str


def _hash_device_bytes(h, flat: torch.Tensor, chunk: int) -> None:
    """Feed ``flat`` (a contiguous uint8 CUDA tensor) to ``h`` in order,
    chunk by chunk through the pinned buffers, copies ahead of the hash."""
    n = flat.numel()
    with _staging_lock, torch.cuda.device(flat.device):
        if not _staging or _staging[0].numel() < chunk:
            _staging[:] = [torch.empty(chunk, dtype=torch.uint8, pin_memory=True)
                           for _ in range(2)]
        events = [torch.cuda.Event(), torch.cuda.Event()]
        starts = list(range(0, n, chunk))

        def issue(i: int) -> None:
            a = starts[i]
            b = min(a + chunk, n)
            _staging[i % 2][:b - a].copy_(flat[a:b], non_blocking=True)
            events[i % 2].record()

        for i in range(min(2, len(starts))):
            issue(i)
        for i, a in enumerate(starts):
            events[i % 2].synchronize()
            h.update(_staging[i % 2][:min(chunk, n - a)].numpy())
            if i + 2 < len(starts):
                issue(i + 2)


def _hash_leaf(h, leaf: Any, chunk: int) -> int:
    """Hash one leaf's dtype, shape and C-order bytes; returns its bytes."""
    if isinstance(leaf, torch.Tensor) and leaf.is_cuda:
        h.update(_np_dtype_str(leaf.dtype).encode())
        h.update(str(tuple(leaf.shape)).encode())
        flat = leaf.detach().contiguous().reshape(-1).view(torch.uint8)
        _hash_device_bytes(h, flat, chunk)
        return flat.numel()
    arr = (leaf.detach().cpu().numpy() if isinstance(leaf, torch.Tensor)
           else np.asarray(leaf))
    h.update(arr.dtype.str.encode())
    h.update(str(arr.shape).encode())
    h.update(np.ascontiguousarray(arr).reshape(-1).view(np.uint8))
    return arr.nbytes


def pytree_digest(tree: Any, chunk: int = DIGEST_CHUNK) -> str:
    """SHA-256 over each leaf's key path, dtype, shape and bytes (device
    leaves streamed through pinned host buffers, ``chunk`` bytes at a time).
    In a recorded round the call is the span ``chain.digest`` and counts the
    leaves' bytes (``chain_hashed_bytes``)."""
    with span("chain.digest"):
        h = hashlib.sha256()
        hashed = 0
        for path, leaf in tree_paths(tree):
            h.update(repr(path).encode())
            hashed += _hash_leaf(h, leaf, chunk)
        count("chain_hashed_bytes", hashed)
        return h.hexdigest()


@dataclass
class Block:
    index: int
    kind: str                   # MODEL | UPDATE | COMMITTEE
    round: int
    prev_hash: str
    payload_digest: str
    # learning information (prunable; None after pruning)
    payload: Any = None
    # update-block fields (§III.A: uploader address + committee score)
    uploader: Optional[int] = None
    score: Optional[float] = None
    hash: str = ""
    pruned: bool = False
    # payload stored in the chain's codec format (e.g. int8 blob)
    encoded: bool = False

    def compute_hash(self) -> str:
        h = hashlib.sha256()
        h.update(self.prev_hash.encode())
        h.update(f"{self.index}|{self.kind}|{self.round}".encode())
        h.update(self.payload_digest.encode())
        h.update(f"{self.uploader}|{self.score}".encode())
        # the codec flag decides how the payload is read back
        h.update(f"{self.encoded}".encode())
        return h.hexdigest()


class LayoutError(RuntimeError):
    pass


class Chain:
    """The alliance-chain ledger for one BFLC training community."""

    def __init__(self, k_updates_per_round: int, off_chain_store=None,
                 update_codec=None, tier2_block: bool = False):
        if k_updates_per_round < 1:
            raise ValueError("k must be >= 1")
        self.k = k_updates_per_round
        self.tier2 = bool(tier2_block)
        self.blocks: List[Block] = []
        self._latest_model_idx: int = -1   # O(1) latest-model pointer
        self._latest_model_round: int = -1
        self.store = off_chain_store
        # optional payload codec for UPDATE blocks (§IV.D): hashes cover
        # the *encoded* payload, which is what the chain stores
        self.codec = update_codec

    # ------------------------------------------------------------------
    # layout arithmetic (paper §III.A)
    # ------------------------------------------------------------------
    @property
    def period(self) -> int:
        """Blocks per round: model + k updates (+ the committee block)."""
        return self.k + 1 + (1 if self.tier2 else 0)

    def model_index(self, t: int) -> int:
        return t * self.period

    def update_index_range(self, t: int) -> Tuple[int, int]:
        return t * self.period + 1, t * self.period + self.k

    def committee_index(self, t: int) -> int:
        if not self.tier2:
            raise LayoutError("flat chain has no committee blocks "
                              "(construct with tier2_block=True)")
        return t * self.period + self.k + 1

    @property
    def height(self) -> int:
        return len(self.blocks)

    @property
    def current_round(self) -> int:
        """Round whose updates are currently being collected."""
        return self._latest_model_round

    # ------------------------------------------------------------------
    # appends
    # ------------------------------------------------------------------
    def _append(self, block: Block) -> Block:
        block.prev_hash = self.blocks[-1].hash if self.blocks else "genesis"
        block.hash = block.compute_hash()
        self.blocks.append(block)
        return block

    def _stored(self, payload: Any) -> Tuple[str, Any]:
        digest = pytree_digest(payload)
        if self.store is not None:
            self.store.put(digest, payload)
            return digest, None
        return digest, payload

    def append_model(self, model: Any, round_t: int) -> Block:
        expect = self.model_index(round_t)
        if self.height != expect:
            raise LayoutError(
                f"model block for round {round_t} must sit at height {expect}, "
                f"chain height is {self.height} (need {self.k} update blocks "
                f"per round)"
            )
        digest, payload = self._stored(model)
        blk = self._append(Block(index=self.height, kind=MODEL, round=round_t,
                                 prev_hash="", payload_digest=digest,
                                 payload=payload))
        self._latest_model_idx = blk.index
        self._latest_model_round = round_t
        return blk

    def append_update(self, update: Any, uploader: int, score: float, *,
                      encoded: bool = False) -> Block:
        """Append one scored local update.  With a codec configured the
        payload is stored in codec format; pass ``encoded=True`` when the
        caller already encoded it (a whole round quantized in one launch)."""
        if self._latest_model_idx < 0:
            raise LayoutError("no genesis model block yet")
        t = self._latest_model_round
        lo, hi = self.update_index_range(t)
        if not (lo <= self.height <= hi):
            raise LayoutError(
                f"round {t} already holds {self.k} updates; aggregate first"
            )
        if encoded and self.codec is None:
            raise ValueError(
                "encoded=True requires a Chain update_codec (nothing could "
                "decode the blob on read)"
            )
        if self.codec is not None and not encoded:
            update = self.codec.encode(update)
            encoded = True
        digest, payload = self._stored(update)
        return self._append(Block(index=self.height, kind=UPDATE, round=t,
                                  prev_hash="", payload_digest=digest,
                                  payload=payload, uploader=uploader,
                                  score=float(score), encoded=encoded))

    def append_committee(self, record: Any) -> Block:
        """Append the round's tier-2 committee block (tiered chains only),
        stored verbatim between the last update block and the next model
        block."""
        if self._latest_model_idx < 0:
            raise LayoutError("no genesis model block yet")
        t = self._latest_model_round
        expect = self.committee_index(t)       # raises on flat chains
        if self.height != expect:
            raise LayoutError(
                f"committee block for round {t} must sit at height {expect} "
                f"(after {self.k} update blocks), chain height is "
                f"{self.height}"
            )
        digest, payload = self._stored(record)
        return self._append(Block(index=self.height, kind=COMMITTEE, round=t,
                                  prev_hash="", payload_digest=digest,
                                  payload=payload))

    def updates_this_round(self) -> int:
        return min(self.height - 1 - self._latest_model_idx, self.k)

    def round_complete(self) -> bool:
        return self.updates_this_round() >= self.k

    # ------------------------------------------------------------------
    # reads
    # ------------------------------------------------------------------
    def raw_payload(self, blk: Block) -> Any:
        """Stored (possibly codec-encoded) payload."""
        if blk.payload is not None:
            return blk.payload
        if self.store is not None:
            return self.store.get(blk.payload_digest)
        raise KeyError(f"block {blk.index} pruned and no off-chain store")

    def _payload(self, blk: Block) -> Any:
        raw = self.raw_payload(blk)
        if blk.encoded and self.codec is not None:
            return self.codec.decode(raw)
        return raw

    def latest_model(self) -> Tuple[int, Any]:
        """O(1): returns (round, model)."""
        if self._latest_model_idx < 0:
            raise LayoutError("empty chain")
        blk = self.blocks[self._latest_model_idx]
        return blk.round, self._payload(blk)

    def model_at_round(self, t: int) -> Any:
        """Failure fallback (§IV.C): recover any historical global model."""
        return self._payload(self.blocks[self.model_index(t)])

    def updates_at_round(self, t: int) -> List[Block]:
        lo, hi = self.update_index_range(t)
        return self.blocks[lo : min(hi, self.height - 1) + 1]

    def update_payloads_at_round(self, t: int, decode: bool = True) -> List[Any]:
        """Round-t update payloads; ``decode=False`` returns the stored
        codec-format blobs."""
        return [
            self._payload(b) if decode else self.raw_payload(b)
            for b in self.updates_at_round(t)
        ]

    def committee_at_round(self, t: int) -> Any:
        idx = self.committee_index(t)
        if idx >= self.height:
            raise LayoutError(f"round {t} has no committee block yet")
        return self._payload(self.blocks[idx])

    # ------------------------------------------------------------------
    # integrity + storage optimization
    # ------------------------------------------------------------------
    def verify(self) -> bool:
        prev = "genesis"
        for blk in self.blocks:
            if blk.prev_hash != prev or blk.hash != blk.compute_hash():
                return False
            if (blk.payload is not None
                    and pytree_digest(blk.payload) != blk.payload_digest):
                return False
            # position within the round's period decides the kind
            pos = blk.index % self.period
            want = (MODEL if pos == 0
                    else UPDATE if pos <= self.k
                    else COMMITTEE)
            if blk.kind != want:
                return False
            prev = blk.hash
        return True

    def prune(self, keep_rounds: int = 1) -> int:
        """§IV.D: drop historical payloads, keep headers + latest rounds.
        Returns the number of payloads dropped."""
        if self._latest_model_idx < 0:
            return 0
        cutoff_round = max(0, self._latest_model_round - keep_rounds + 1)
        cutoff_idx = self.model_index(cutoff_round)
        dropped = 0
        for blk in self.blocks[:cutoff_idx]:
            if blk.payload is not None:
                blk.payload = None
                blk.pruned = True
                dropped += 1
        return dropped

    def storage_bytes(self) -> int:
        """Approximate resident payload bytes (§IV.D)."""
        return sum(
            (leaf.numel() * leaf.element_size() if isinstance(leaf, torch.Tensor)
             else np.asarray(leaf).nbytes)
            for blk in self.blocks if blk.payload is not None
            for leaf in tree_leaves(blk.payload)
        )
