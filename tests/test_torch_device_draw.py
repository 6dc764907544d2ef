"""The batch draw from the device-resident community
(``repro_torch.fl.client.DeviceCommunity``).

The cohort's and the members' batches are gathered on the device from
one flat copy of the training shards, by indices drawn on the host with
the same rng calls the host gather made (``sample_client_batches``, one
per client in order).  Held here, on the CPU: the gathered batches equal
the numpy fancy-index gather bit for bit and leave the rng in the same
state, for a ``FederatedDataset`` of float32 images, a
``VirtualFederatedDataset`` (only its base is stored) and the LM round's
int32 token shards; the store equals the concatenated shards whatever
its upload runs; a recorded round copies only the indices and counts the
rows it gathered; a community that does not fit raises at build with its
byte count.
"""
import types

import numpy as np
import pytest
import torch

from repro_torch import spans
from repro_torch.api import build_runtime
from repro_torch.data import (
    FederatedDataset,
    MarkovLM,
    VirtualFederatedDataset,
    make_femnist_like,
)
from repro_torch.device import to_device
from repro_torch.fl.adapter import femnist_adapter
from repro_torch.fl.client import DeviceCommunity, sample_client_batches
from repro_torch.fl.pipeline import (
    RoundContext,
    sample_cohort_batches,
    sample_member_batches,
)

torch.set_num_threads(2)

STEPS, BATCH, VAL_BATCH = 3, 5, 7


def femnist():
    return make_femnist_like(num_clients=10, mean_samples=15, test_size=16,
                             seed=3)


def virtual():
    return VirtualFederatedDataset(femnist(), 37)


def lm_tokens():
    """int32 token rows and next tokens, as the LM round's shards."""
    lm = MarkovLM(64, seed=1)
    rng = np.random.default_rng(0)
    images, labels = [], []
    for n in (9, 4, 13, 6):
        rows = lm.sample(rng, n, 9)
        images.append(rows[:, :-1])
        labels.append(rows[:, 1:])
    return FederatedDataset(images, labels, images[0], labels[0])


DATASETS = {"femnist_f32": femnist, "virtual": virtual, "lm_int32": lm_tokens}


def context(data, seed=11):
    cfg = types.SimpleNamespace(local_steps=STEPS, local_batch=BATCH,
                                val_batch=VAL_BATCH)
    return RoundContext(cfg=cfg, rng=np.random.default_rng(seed),
                        adapter=None, data=data, params=None, round=0,
                        community=DeviceCommunity(data, "cpu"))


def clients_of(data, n, seed=5):
    return np.random.default_rng(seed).choice(
        data.num_clients, n, replace=False).tolist()


@pytest.mark.parametrize("name", DATASETS)
def test_cohort_draw_equals_the_host_gather(name):
    data = DATASETS[name]()
    ctx = context(data)
    ctx.trainers = clients_of(data, min(6, data.num_clients))
    host = np.random.default_rng(11)
    pairs = [sample_client_batches(host, data.client_images[i],
                                   data.client_labels[i], STEPS, BATCH)
             for i in ctx.trainers]
    xs, ys = sample_cohort_batches(ctx)
    want_x = np.stack([p[0] for p in pairs])
    want_y = np.stack([p[1] for p in pairs])
    assert xs.dtype == torch.from_numpy(want_x).dtype
    assert ys.dtype == torch.from_numpy(want_y).dtype
    np.testing.assert_array_equal(xs.numpy(), want_x)
    np.testing.assert_array_equal(ys.numpy(), want_y)
    assert ctx.rng.bit_generator.state == host.bit_generator.state


@pytest.mark.parametrize("name", DATASETS)
def test_member_draw_equals_the_host_gather(name):
    data = DATASETS[name]()
    ctx = context(data, seed=4)
    members = clients_of(data, min(5, data.num_clients), seed=8)
    host = np.random.default_rng(4)
    pairs = [sample_client_batches(host, data.client_images[j],
                                   data.client_labels[j], 1, VAL_BATCH)
             for j in members]
    vx, vy = sample_member_batches(ctx, members)
    np.testing.assert_array_equal(vx.numpy(),
                                  np.stack([p[0][0] for p in pairs]))
    np.testing.assert_array_equal(vy.numpy(),
                                  np.stack([p[1][0] for p in pairs]))
    assert ctx.rng.bit_generator.state == host.bit_generator.state


@pytest.mark.parametrize("chunk", (1, 3000, 1 << 30))
@pytest.mark.parametrize("name", DATASETS)
def test_the_store_is_the_concatenated_shards(name, chunk, monkeypatch):
    """Whatever its upload runs (one shard each, a few shards, all), the
    store holds the shards in order; a virtual community only its base."""
    data = DATASETS[name]()
    monkeypatch.setattr(DeviceCommunity, "CHUNK_BYTES", chunk)
    store = DeviceCommunity(data, "cpu")
    base = data.base if isinstance(data, VirtualFederatedDataset) else data
    np.testing.assert_array_equal(store.images.numpy(),
                                  np.concatenate(base.client_images))
    np.testing.assert_array_equal(store.labels.numpy(),
                                  np.concatenate(base.client_labels))
    assert store.nbytes == (store.images.numel() * store.images.element_size()
                            + store.labels.numel() * store.labels.element_size())
    assert len(store.sizes) == base.num_clients


def test_a_virtual_client_reads_its_base_shard():
    data = virtual()
    ctx = context(data)
    nb = data.base.num_clients
    ctx.trainers = [3, 3 + nb, 3 + 3 * nb]
    xs, _ = sample_cohort_batches(ctx)
    lo = int(ctx.community.offsets[3])
    rows = data.base.client_images[3]
    for x in xs.reshape(-1, *rows.shape[1:]):
        assert any(torch.equal(x, torch.from_numpy(r)) for r in rows)
    assert ctx.community.images.shape[0] == sum(
        len(y) for y in data.base.client_labels)
    assert lo == sum(len(y) for y in data.base.client_labels[:3])


def test_a_round_copies_indices_and_counts_gathered_rows():
    """A recorded flat round: h2d_bytes are the int64 indices of every
    gathered row and the k aggregation weights; gathered_rows is
    P x steps x batch over the cohorts + Q x val_batch."""
    data = femnist()
    cfg = dict(active_proportion=0.6, k_updates=2, local_steps=STEPS,
               local_batch=BATCH, val_batch=VAL_BATCH, quantize_chain=True,
               use_kernels=True)
    rt = build_runtime(femnist_adapter(8), data, cfg, device="cpu",
                       stages={"validator": "committee_int8"})
    committee = len(rt.committee)
    log = rt.run_round()
    counts = rt.stage_timings[0].counts
    rows = log.trainers * STEPS * BATCH + committee * VAL_BATCH
    assert counts["gathered_rows"] == rows
    assert counts["h2d_bytes"] == 8 * rows + 4 * cfg["k_updates"]
    assert rt.stage_timings[0].spans["train.draw"].parents.keys() == {"train"}
    assert rt.stage_timings[0].spans["h2d"].parents.keys() == \
        {"train", "validate", "aggregate"}


def test_a_community_that_does_not_fit_raises_with_its_bytes(monkeypatch):
    data = femnist()
    nbytes = (sum(x.nbytes for x in data.client_images)
              + sum(y.nbytes for y in data.client_labels))

    def refuse(*args, **kw):
        raise torch.OutOfMemoryError("CUDA out of memory")

    monkeypatch.setattr(torch, "empty", refuse)
    with pytest.raises(RuntimeError, match=f"{nbytes} bytes"):
        DeviceCommunity(data, "cpu")
    monkeypatch.undo()
    with pytest.raises(RuntimeError, match=f"{nbytes} bytes"):
        monkeypatch.setattr(torch, "empty", refuse)
        build_runtime(femnist_adapter(8), data, {}, device="cpu")


def test_to_device_passes_a_resident_tensor_through():
    t = torch.arange(6)
    with spans.recording(spans.Recorder("cpu")) as rec:
        assert to_device(t, "cpu") is t
        assert rec.counts == {} and rec.totals == {}
        to_device(t.numpy(), "cpu")
        assert rec.counts == {"h2d_bytes": t.numel() * 8}


def test_a_draw_without_a_store_says_so():
    ctx = RoundContext(cfg=types.SimpleNamespace(val_batch=2),
                       rng=np.random.default_rng(0), adapter=None,
                       data=femnist(), params=None, round=0)
    with pytest.raises(RuntimeError, match="ctx.community"):
        sample_member_batches(ctx, [0])
