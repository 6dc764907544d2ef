"""The port's roofline machinery (``repro_torch.launch.hlo_stats``).

* ``roofline_terms`` equals the reference's term by term once each term
  is rescaled by the ratio of the two hardware constants (the H100's
  989e12 FLOP/s, 3.35e12 B/s and 900e9 B/s for the TPU v5e's 197e12,
  819e9 and 50e9), and ``dominant`` names the largest term; no TPU
  constant is left in the port.
* ``collective_stats``: four collectives on a fake world of 8 ranks (a
  DTensor redistributed Shard(0) -> Replicate, Partial -> Replicate and
  Partial -> Shard(0), and ``launch/mesh.py``'s all-to-all of local
  blocks) give the kinds, counts and bytes the reference's
  ``collective_stats`` reads from the same collectives compiled on the
  suite's 8 CPU devices (all-gather, all-reduce, reduce-scatter and
  all-to-all of a (128, 32) f32 array split 8 ways).
* ``compute_stats``: a product's FLOPs and bytes, an ``einsum`` and a
  ``linear`` counted once each (their decompositions run inside the fake
  mode); ``decode_per_token_stats`` divides by the batch and refuses a
  batch under 1.
"""
import pathlib

import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from repro.launch import hlo_stats as ref
from repro_torch.launch import hlo_stats as H
from repro_torch.launch.dryrun import fake_world

ROOT = pathlib.Path(__file__).resolve().parents[1]
RESCALE = {"compute_s": H.PEAK_FLOPS / ref.PEAK_FLOPS,
           "memory_s": H.HBM_BW / ref.HBM_BW,
           "collective_s": H.NVLINK_BW / ref.ICI_BW}


@pytest.mark.parametrize("flops,nbytes,coll,chips", [
    (197e12, 819e9, 100e9, 1),
    (4.557e13, 3.37e11, 4.74e10, 1),
    (1e18, 1e12, 1e9, 256),
    (0.0, 0.0, 5e9, 512),
])
def test_roofline_terms_rescale_to_reference(flops, nbytes, coll, chips):
    kw = dict(flops=flops, bytes_accessed=nbytes, collective_bytes=coll,
              chips=chips)
    got, want = H.roofline_terms(**kw), ref.roofline_terms(**kw)
    for key, ratio in RESCALE.items():
        assert got[key] * ratio == pytest.approx(want[key], rel=1e-12)
    assert got["dominant"] == max(RESCALE, key=got.get)[:-2]


def test_no_tpu_constant_in_the_port():
    assert (H.PEAK_FLOPS, H.HBM_BW, H.NVLINK_BW) == (989e12, 3.35e12, 900e9)
    text = "\n".join(p.read_text()
                     for p in (ROOT / "src" / "repro_torch").rglob("*.py"))
    for tpu in ("197e12", "819e9", "50e9"):
        assert tpu not in text


def _reference_collectives():
    mesh = jax.make_mesh((8,), ("d",))
    x = jax.device_put(jnp.zeros((128, 32), jnp.float32),
                       NamedSharding(mesh, P("d")))

    def on_blocks(fn, out):
        return jax.shard_map(fn, mesh=mesh, in_specs=P("d"), out_specs=out)

    programs = {
        "all-gather": jax.jit(lambda a: a,
                              out_shardings=NamedSharding(mesh, P())),
        "all-reduce": jax.jit(on_blocks(lambda a: jax.lax.psum(a, "d"), P())),
        "reduce-scatter": jax.jit(on_blocks(
            lambda a: jax.lax.psum_scatter(a, "d", scatter_dimension=0,
                                           tiled=True), P("d"))),
        "all-to-all": jax.jit(on_blocks(
            lambda a: jax.lax.all_to_all(a, "d", 0, 1, tiled=True), P("d"))),
    }
    return {kind: ref.collective_stats(p.lower(x).compile().as_text())
            for kind, p in programs.items()}


def _port_collectives():
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import (
        DTensor,
        Partial,
        Replicate,
        Shard,
        distribute_tensor,
    )

    from repro_torch.launch.mesh import all_to_all

    out = {}
    with fake_world(8):
        mesh = init_device_mesh("cpu", (8,))
        fake = H.DeviceOpsMode()
        with fake:
            whole = distribute_tensor(torch.zeros(128, 32), mesh, (Shard(0),))
            partial = DTensor.from_local(torch.zeros(16, 32), mesh,
                                         (Partial(),), run_check=False)
            block = torch.zeros(16, 32)
        moves = {
            "all-gather": lambda: whole.redistribute(mesh, (Replicate(),)),
            "all-reduce": lambda: partial.redistribute(mesh, (Replicate(),)),
            "reduce-scatter": lambda: partial.redistribute(mesh, (Shard(0),)),
            "all-to-all": lambda: all_to_all(block, mesh.get_group()),
        }
        for kind, move in moves.items():
            with fake.recording() as record:
                move()
            out[kind] = H.collective_stats(record)
    return out


def test_collectives_match_reference_kinds_and_bytes():
    want, got = _reference_collectives(), _port_collectives()
    for kind in want:
        assert got[kind].bytes_by_kind == want[kind].bytes_by_kind, kind
        assert got[kind].count_by_kind == want[kind].count_by_kind, kind
        assert got[kind].count_by_kind == {kind: 1}


def test_compute_stats_counts_each_product_once():
    fake = H.DeviceOpsMode()
    with fake:
        a, b = torch.zeros(8, 16), torch.zeros(16, 32)
        x, w, bias = torch.zeros(4, 8, 16), torch.zeros(32, 16), torch.zeros(32)
    with fake.recording() as record:
        a @ b
    assert H.compute_stats(record) == {
        "dot_flops": 2 * 8 * 16 * 32, "dot_bytes": 4 * (8 * 16 + 16 * 32 + 8 * 32)}
    with fake.recording() as record:
        torch.einsum("bsd,ed->bse", x, w)
        torch.nn.functional.linear(x, w, bias)
    assert H.compute_stats(record)["dot_flops"] == 2 * (2 * 4 * 8 * 16 * 32)
    assert H.collective_stats(record).total_bytes == 0


def test_decode_per_token_stats_divides_by_batch():
    record = H.DeviceRecord(dot_flops=43008, dot_bytes=19200)
    record.collectives.add("all-reduce", 512)
    record.collectives.add("all-gather", 2048, 5)
    pt = H.decode_per_token_stats(record, 4)
    assert pt == {"dot_flops_per_token": 43008 / 4,
                  "dot_bytes_per_token": 19200 / 4,
                  "collective_bytes_per_token": (512 + 5 * 2048) / 4}
    assert H.decode_per_token_stats(record, 1)["dot_flops_per_token"] == 43008
    with pytest.raises(ValueError, match="batch must be >= 1"):
        H.decode_per_token_stats(record, 0)
