"""Builds the CUDA sources under ``csrc/`` with nvcc and loads them.

Each ``csrc/<name>.cu`` becomes ``lib<name>.so`` with a plain C interface,
loaded through ``ctypes``: every pointer and the stream are ``c_void_p``,
every count a ``c_int`` (or ``c_longlong``), and every entry returns
``cudaGetLastError()`` as an int.  The build goes into
``build/repro_torch_kernels/<hash>/`` under the repository root, where the
hash covers every file in ``csrc/`` and the nvcc flags, so an edited source
rebuilds and an unchanged one is loaded as built.  It happens at first use
(or through ``build_all``), from the repository's sources only; all sources
compile in parallel, one nvcc each.  A failed build raises.  Each
library is compiled into a temporary file of its own and moved into place
with ``os.replace``, so processes that load at once (the ranks of one
card, say) see either no library or a whole one, never half of one.  nvcc's output,
with ptxas's registers, stack and spills for every kernel (``-Xptxas -v``),
is kept beside each library as ``lib<name>.log`` (``build_log``).

No ``--use_fast_math``: the codec's division and rounding must be IEEE,
as the reference's are.  The reductions spell out each rounding
(``__fmaf_rn``, ``__fadd_rn``, ``__fmul_rn``), which nvcc never contracts.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# source name -> {C entry: argtypes}
SIGNATURES: Dict[str, Dict[str, list]] = {
    "quantize": {
        "repro_quantize_rows": [_P, _P, _P, _I, _I, _P],
        "repro_dequantize": [_P, _P, _P, _L, _P],
    },
    "fused_agg": {
        "repro_fused_agg": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P,
                            _P],
    },
    "fused_score": {
        "repro_fused_candidates": [_P, _P, _P, _P, _I, _I, _P],
    },
    "f32_agg": {
        "repro_fedavg_agg": [_P, _P, _P, _I, _L, _P],
        "repro_sort_agg": [_P, _P, _I, _L, _I, _I, _I, _P, _P],
    },
    "client_gemm": {
        "repro_client_gemm": [_P, _L, _L, _L, _P, _L, _L, _L, _P, _L, _P,
                              _P, _I, _I, _I, _I, _I, _I, _I, _P, _P],
    },
}
SOURCES = tuple(SIGNATURES)

_loaded: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    return os.path.join(home, "bin", "nvcc")


def _build_dir() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.iterdir()):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def build_all(names: Iterable[str] = SOURCES) -> Dict[str, Path]:
    """Compile every named source that is not built yet, all at once.

    Returns name -> library path.  Raises RuntimeError with nvcc's output
    if any compile fails."""
    out_dir = _build_dir()
    paths = {n: out_dir / f"lib{n}.so" for n in names}
    todo = [n for n, p in paths.items() if not p.exists()]
    if not todo:
        return paths
    nvcc = nvcc_path()
    if not os.path.exists(nvcc):
        raise RuntimeError(
            f"cannot build the CUDA kernels {todo}: nvcc not found (looked "
            f"on PATH and at {nvcc}; set CUDA_HOME)"
        )
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in todo:
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp)
    failed = []
    for name, (proc, tmp) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            os.unlink(tmp)
            failed.append(f"nvcc {name}.cu (exit {proc.returncode}):\n{log}")
        else:
            (out_dir / f"lib{name}.log").write_text(log)
            os.replace(tmp, paths[name])
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return paths


def build_log(name: str) -> str:
    """nvcc's output for ``csrc/<name>.cu``, building it first if needed."""
    return build_all([name])[name].with_suffix(".log").read_text()


def load(name: str) -> ctypes.CDLL:
    """The built library for ``csrc/<name>.cu``, building it on first use."""
    lib = _loaded.get(name)
    if lib is not None:
        return lib
    path = build_all([name])[name]
    lib = ctypes.CDLL(str(path))
    for fn, argtypes in SIGNATURES[name].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    lib.repro_error_string.argtypes = [ctypes.c_int]
    lib.repro_error_string.restype = ctypes.c_char_p
    _loaded[name] = lib
    return lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a C entry returned a CUDA error."""
    if code != 0:
        msg = lib.repro_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")


def stream_handle(t) -> int:
    """PyTorch's current stream on the tensor's device, as a raw handle."""
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream


def check_f32_stack(stack, what: str) -> None:
    """Raise unless ``stack`` is a non-empty 2-D float32 (K, D) stack, the
    input every f32 aggregation wrapper takes."""
    import torch

    if stack.dtype != torch.float32 or stack.dim() != 2:
        raise TypeError(f"{what}: want a 2-D float32 stack, got "
                        f"{stack.dtype} {tuple(stack.shape)}")
    if stack.shape[0] == 0 or stack.shape[1] == 0:
        raise ValueError(f"{what}: empty stack {tuple(stack.shape)}")


def require_cuda(*ts, vector_loaded=()) -> None:
    """Raise unless every tensor is a contiguous CUDA tensor on one device;
    the ``vector_loaded`` ones (read 8 or 16 bytes at a time) must also be
    16-byte aligned."""
    dev = ts[0].device
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}: want cuda or cpu")
    for t in ts:
        if t.device != dev:
            raise ValueError(f"tensors on {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError("kernel inputs must be contiguous")
    for t in vector_loaded:
        if t.data_ptr() % 16:
            raise ValueError("vector-loaded kernel input is not 16-byte aligned")
