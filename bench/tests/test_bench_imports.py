"""What the benchmark loads: never JAX or the JAX package, and the
reference nothing of the port.  Top-level module names are compared
whole (the port's name begins with the JAX package's)."""
import json
import subprocess
import sys

from bench import harness

ROOT = harness.ROOT


def loaded_after(code: str) -> set:
    probe = (f"import sys; sys.path[:0] = [{str(ROOT)!r}, {str(ROOT / 'src')!r}]\n"
             f"{code}\n"
             "import json; print(json.dumps(sorted({m.split('.')[0] "
             "for m in list(sys.modules)})))")
    out = subprocess.run([sys.executable, "-c", probe], capture_output=True,
                         text=True, cwd=ROOT, timeout=300, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_the_runner_loads_no_jax():
    """Everything the runner imports for every cell: the harness, the
    families, the port's entry points and every metric reader."""
    code = "\n".join([
        "from bench import harness, calibrate, profiler",
        "import bench.drivers.flat_round",
        "import bench.run",
        "bm = harness.load_benchmark()",
        "for w in bm['workloads']:",
        "    spec = harness.cell_spec(w['name'])",
        "    fam = harness.family(spec.config)",
        "    fam.program_adapter(spec.config)",
        "    spec.driver",
        "    [harness.metric_reader(m['name']) for m in spec.per_layer]",
        "import repro_torch.api, repro_torch.data.synthetic",
    ])
    loaded = loaded_after(code)
    assert "repro_torch" in loaded
    assert not loaded & set(harness.FORBIDDEN), loaded & set(harness.FORBIDDEN)


def test_the_reference_loads_nothing_of_the_port():
    code = "\n".join(
        f"import bench.reference.{m}"
        for m in ("tree", "precision", "chain", "cnn", "round"))
    loaded = loaded_after(code)
    assert not loaded & {"repro_torch", *harness.FORBIDDEN}


def test_forbidden_modules_compares_whole_names():
    assert harness.forbidden_modules(["repro_torch.api", "numpy", "jaxtyping"]) == []
    assert harness.forbidden_modules(["repro.fl", "jax._src", "flax"]) == \
        ["flax", "jax", "repro"]
