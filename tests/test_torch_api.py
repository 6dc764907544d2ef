"""The port's entry points: CUDA by default, the CPU only on request, and
every option the port does not have yet refused by name; the kernel
wrappers: a tensor on neither the CPU nor CUDA gets no plain version."""
import pytest
import torch

from repro_torch.api import build_runtime
from repro_torch.data import make_femnist_like
from repro_torch.fl.adapter import femnist_adapter
from repro_torch.fl.pipeline import STAGE_TIMING_KEYS
from repro_torch.kernels import _build, launch_counts
from repro_torch.kernels.cwmed import cwmed_kernel, trimmed_mean_kernel
from repro_torch.kernels.fedavg_agg import fedavg_agg_kernel
from repro_torch.kernels.fused_score import fused_candidates_kernel

torch.set_num_threads(2)

SMALL = dict(active_proportion=0.5, k_updates=3, local_steps=2,
             local_batch=8, val_batch=16)


@pytest.fixture(scope="module")
def tiny_ds():
    return make_femnist_like(num_clients=12, mean_samples=20, test_size=64,
                             seed=2)


def test_default_device_is_cuda_and_raises_without_it(tiny_ds):
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default device is usable here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_runtime(femnist_adapter(8), tiny_ds, SMALL)


@pytest.mark.parametrize("kwargs, cfg, match", [
    (dict(mesh=object()), {}, "Queue 1 item 11"),
    (dict(tiers=2, mesh=object()), {}, "Queue 1 item 11"),
    (dict(schedule="async"), {}, "Queue 1 item 10"),
])
def test_unported_options_raise_not_implemented(tiny_ds, kwargs, cfg, match):
    with pytest.raises(NotImplementedError, match=match):
        build_runtime(femnist_adapter(8), tiny_ds, {**SMALL, **cfg},
                      device="cpu", **kwargs)


def test_tiers_build_the_tiered_round(tiny_ds):
    rt = build_runtime(femnist_adapter(8), tiny_ds, SMALL, tiers=2,
                       device="cpu")
    assert rt.cfg.tiers == 2 and rt.chain.tier2 and rt.chain.k == 2
    assert rt.hier_logs == []


def test_quantize_chain_requires_use_kernels(tiny_ds):
    with pytest.raises(ValueError, match="use_kernels=True"):
        build_runtime(femnist_adapter(8), tiny_ds,
                      {**SMALL, "quantize_chain": True}, device="cpu")


def test_cpu_round_from_the_ports_own_init(tiny_ds):
    before = launch_counts()
    rt = build_runtime(femnist_adapter(8), tiny_ds,
                       {**SMALL, "quantize_chain": True, "use_kernels": True},
                       device="cpu")
    log = rt.run_round(eval_test=True)
    assert rt.chain.verify() and rt.chain.height == 1 + rt.cfg.k_updates + 1
    assert 0.0 <= log.test_accuracy <= 1.0
    assert set(rt.stage_timings[0]) == set(STAGE_TIMING_KEYS)
    params = rt.global_params()
    assert all(bool(torch.isfinite(v).all()) for p in params.values()
               for v in p.values())
    # CPU tensors take the plain versions: no kernel was launched
    assert launch_counts() == before


def _meta(shape, dtype=torch.float32):
    return torch.zeros(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("launch", [
    lambda: fused_candidates_kernel(_meta((2048,)), _meta((2, 2048), torch.int8),
                                    _meta((2, 1))),
    lambda: fedavg_agg_kernel(_meta((3, 100)), _meta((3,))),
    lambda: cwmed_kernel(_meta((3, 100))),
    lambda: trimmed_mean_kernel(_meta((3, 100)), trim=1),
], ids=("fused_candidates", "fedavg_agg", "cwmed", "trimmed_mean"))
def test_new_wrappers_never_fall_back(launch):
    before = launch_counts()
    with pytest.raises(ValueError, match="no kernel for device meta"):
        launch()
    assert launch_counts() == before


@pytest.mark.parametrize("method", ("fedavg", "cwmed", "trimmed_mean"))
def test_cpu_f32_kernel_round_from_the_ports_own_init(tiny_ds, method):
    rt = build_runtime(femnist_adapter(8), tiny_ds,
                       {**SMALL, "use_kernels": True, "aggregation": method},
                       device="cpu")
    rt.run_round()
    assert rt.chain.verify() and rt.chain.height == 1 + rt.cfg.k_updates + 1


def test_kernel_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path)
    monkeypatch.setattr(_build, "nvcc_path", lambda: str(tmp_path / "no-nvcc"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build_all()
