"""Roofline terms of a step as one rank of a mesh runs it.

Port of ``repro/launch/hlo_stats.py``.  The reference reads the HLO text
XLA compiles for one device: the FLOPs and bytes of its dot products and
the bytes of its collectives, multiplied through while-loop trip counts.
PyTorch compiles nothing here: the port runs the step itself, eagerly,
on ``FakeTensor``s (shapes and dtypes, no data, no storage), and
``DeviceOpsMode`` records what one rank executes as it goes.  Every
operation on a rank's local tensors passes through the fake mode, the
DTensor layer's local products and collectives included, so the counts
are a device's (the reference's ``post-SPMD`` numbers), loops and
recomputation counted as often as they run:

* ``compute_stats`` — matmul FLOPs by ``torch.utils.flop_counter.
  FlopCounterMode``'s formulas (mm, bmm, addmm, baddbmm, convolutions,
  the fused attention kernels), and the bytes of those products'
  operands and results (the reference's ``hlo_compute_stats``: a
  matmul-traffic lower bound on HBM traffic);
* ``collective_stats`` — bytes and counts by kind, under the reference's
  kind names, counting each collective's result bytes on this rank (the
  reference's ``_shape_bytes`` of each op's output shape).  The kinds are
  those of ``torch.distributed``'s functional collectives (what DTensor
  issues) and of its in-place c10d ops (what ``launch/mesh.py``'s
  expert-parallel exchange issues); no step of the port sends point to
  point, so ``collective-permute`` never appears;
* the peak bytes of the rank's live tensors: every storage a recorded
  operation makes counts from then until its last tensor is freed, with
  the storages the caller ``hold``s (the step's inputs) from the start.
  (``torch.distributed._tools.mem_tracker.MemTracker`` counts a DTensor
  at its global size on torch 2.11: 666.54 GB a device for olmo-1b's
  ``train_4k`` step.)

``CollectiveMeter`` counts the same collectives, by the same kinds and
bytes, for a step run on real tensors over a real process group.

Hardware model: one NVIDIA H100 SXM (NVIDIA H100 80GB HBM3, 700.00 W),
from NVIDIA's H100 data sheet: 989 TFLOP/s dense bf16, 3.35 TB/s HBM3,
900 GB/s NVLink (the sum of both directions over its 18 links).
"""
from __future__ import annotations

import contextlib
import weakref
from dataclasses import dataclass, field
from typing import Dict, Iterator, Optional

import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode
from torch.utils.weak import WeakIdKeyDictionary

PEAK_FLOPS = 989e12         # bf16 dense per card
HBM_BW = 3.35e12            # bytes/s per card
NVLINK_BW = 900e9           # bytes/s per card, both directions

# op name -> (kind, where its bytes are): "out" its result, "arg" its first
# argument (the in-place c10d ops write their output buffer, the first)
_COLLECTIVES = {
    "_c10d_functional.all_gather_into_tensor": ("all-gather", "out"),
    "_c10d_functional.all_gather_into_tensor_coalesced": ("all-gather", "out"),
    "_c10d_functional.all_reduce": ("all-reduce", "out"),
    "_c10d_functional.all_reduce_coalesced": ("all-reduce", "out"),
    "_c10d_functional.reduce_scatter_tensor": ("reduce-scatter", "out"),
    "_c10d_functional.reduce_scatter_tensor_coalesced": ("reduce-scatter",
                                                          "out"),
    "_c10d_functional.all_to_all_single": ("all-to-all", "out"),
    "c10d._allgather_base_": ("all-gather", "arg"),
    "c10d.allgather_": ("all-gather", "arg"),
    "c10d.allreduce_": ("all-reduce", "arg"),
    "c10d._reduce_scatter_base_": ("reduce-scatter", "arg"),
    "c10d.reduce_scatter_": ("reduce-scatter", "arg"),
    "c10d.alltoall_base_": ("all-to-all", "arg"),
}


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


@dataclass
class CollectiveStats:
    bytes_by_kind: Dict[str, int] = field(default_factory=dict)
    count_by_kind: Dict[str, int] = field(default_factory=dict)
    # the bytes of the largest single collective of each kind
    largest_by_kind: Dict[str, int] = field(default_factory=dict)

    @property
    def total_bytes(self) -> int:
        return sum(self.bytes_by_kind.values())

    def add(self, kind: str, nbytes: int, mult: int = 1):
        self.bytes_by_kind[kind] = self.bytes_by_kind.get(kind, 0) + nbytes * mult
        self.count_by_kind[kind] = self.count_by_kind.get(kind, 0) + mult
        self.largest_by_kind[kind] = max(self.largest_by_kind.get(kind, 0),
                                         nbytes)


@dataclass
class DeviceRecord:
    """What one rank ran while a ``DeviceOpsMode`` recorded."""

    dot_flops: int = 0
    dot_bytes: int = 0
    collectives: CollectiveStats = field(default_factory=CollectiveStats)
    live_bytes: int = 0
    peak_bytes: int = 0
    _storages: WeakIdKeyDictionary = field(
        default_factory=WeakIdKeyDictionary, repr=False)

    def hold(self, tree) -> None:
        """Counts the storages of ``tree``'s tensors (a DTensor's local
        one) as live until their last tensor is freed."""
        for t in tree_leaves(tree):
            if not isinstance(t, torch.Tensor):
                continue
            if hasattr(t, "to_local"):
                t = t.to_local()
            st = t.untyped_storage()
            if st in self._storages:
                continue
            n = st.nbytes()
            self._storages[st] = n
            self.live_bytes += n
            self.peak_bytes = max(self.peak_bytes, self.live_bytes)
            weakref.finalize(st, self._release, n)

    def _release(self, n: int) -> None:
        self.live_bytes -= n


class DeviceOpsMode(FakeTensorMode):
    """A ``FakeTensorMode`` whose operations are recorded while
    ``recording()`` is open: each matmul's FLOPs and operand and result
    bytes, each collective's result bytes by kind, and the storages the
    operations make (``DeviceRecord.hold``).  An operation that the fake
    mode runs by decomposing it into others counts once, at the outermost
    counted one.

    Build the inputs under ``with mode:`` and run the step outside it:
    operations on fake tensors dispatch to their mode either way, a
    DTensor's on its local tensors (the rank's operations; under an
    active fake mode a DTensor's operation would run whole), and
    DTensor's sharding propagation computes shard offsets with tensor
    operations that an active fake mode would turn into data it cannot
    read.  Tensors the step makes from scratch are real; the model makes
    its large ones from its inputs (``new_zeros``), so they are fake."""

    def __init__(self):
        super().__init__(allow_non_fake_inputs=True)
        self._flops_of = FlopCounterMode(display=False).flop_registry
        self._record: Optional[DeviceRecord] = None
        self._in_counted = False

    @contextlib.contextmanager
    def recording(self) -> Iterator[DeviceRecord]:
        record = DeviceRecord()
        self._record = record
        try:
            yield record
        finally:
            self._record = None

    def dispatch(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        packet = func._overloadpacket
        collective = _COLLECTIVES.get(
            f"{func.namespace}.{packet.__name__}")
        record = self._record
        if (record is None or self._in_counted
                or (collective is None and packet not in self._flops_of)):
            out = super().dispatch(func, types, args, kwargs)
            if record is not None and out is not NotImplemented:
                record.hold(out)
            return out
        self._in_counted = True
        try:
            out = super().dispatch(func, types, args, kwargs)
        finally:
            self._in_counted = False
        if out is NotImplemented:
            return out
        record.hold(out)
        if collective is not None:
            kind, where = collective
            record.collectives.add(
                kind, _nbytes(out if where == "out" else args[0]))
        else:
            record.dot_flops += int(
                self._flops_of[packet](*args, **kwargs, out_val=out))
            operands = [a for a in args if isinstance(a, torch.Tensor)][:2]
            record.dot_bytes += _nbytes(operands) + _nbytes(out)
        return out


class CollectiveMeter(TorchDispatchMode):
    """The collectives this process issues on real tensors while the mode
    is on, into ``stats`` (a ``CollectiveStats``), by the kinds and bytes
    ``DeviceOpsMode`` records: c10d's in-place ops (``launch/mesh.py``,
    the local maps) and the functional ones (a DTensor's
    redistribution), whose DTensor operations it lets DTensor take apart
    first.  Every operation passes through Python while it is on: meter
    a step apart from the steps that are timed."""

    def __init__(self):
        super().__init__()
        self.stats = CollectiveStats()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **(kwargs or {}))
        collective = _COLLECTIVES.get(
            f"{func.namespace}.{func._overloadpacket.__name__}")
        if collective is not None:
            kind, where = collective
            self.stats.add(kind, _nbytes(out if where == "out" else args[0]))
        return out


def collective_stats(record: DeviceRecord) -> CollectiveStats:
    """The collectives a rank ran, by kind."""
    return record.collectives


def compute_stats(record: DeviceRecord) -> Dict[str, int]:
    """Matmul FLOPs and matmul bytes a rank ran (the reference's
    ``hlo_compute_stats`` keys)."""
    return {"dot_flops": record.dot_flops, "dot_bytes": record.dot_bytes}


def decode_per_token_stats(record: DeviceRecord, batch: int) -> Dict[str, float]:
    """Modeled cost of ONE decoded token from a decode step's record.

    A decode step advances every sequence in the batch by exactly one token,
    so per-token cost is the step's total divided by the batch.  Only a
    decode step's record gives per-token numbers."""
    if batch < 1:
        raise ValueError(f"batch must be >= 1, got {batch}")
    comp = compute_stats(record)
    return {
        "dot_flops_per_token": comp["dot_flops"] / batch,
        "dot_bytes_per_token": comp["dot_bytes"] / batch,
        "collective_bytes_per_token":
            collective_stats(record).total_bytes / batch,
    }


def roofline_terms(
    *,
    flops: float,
    bytes_accessed: float,
    collective_bytes: float,
    chips: int,
) -> Dict[str, float]:
    """The three roofline terms, in seconds (per step, whole mesh), on
    H100s: whole-program totals divided by the mesh (pass a rank's
    numbers with ``chips=1``)."""
    compute_s = flops / (chips * PEAK_FLOPS)
    memory_s = bytes_accessed / (chips * HBM_BW)
    collective_s = collective_bytes / (chips * NVLINK_BW)
    dominant = max(
        ("compute", compute_s), ("memory", memory_s),
        ("collective", collective_s), key=lambda kv: kv[1],
    )[0]
    return {
        "compute_s": compute_s,
        "memory_s": memory_s,
        "collective_s": collective_s,
        "dominant": dominant,
    }
