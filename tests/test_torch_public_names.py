"""Every public top-level name of each reference module has a
counterpart in the port's module of the same path.

Names are read from the source with ``ast`` (neither package is
imported): functions, classes and assigned names at module level, and in
a package's ``__init__.py`` the names it imports (its re-exports).  A
name that starts with ``_`` is private.  ``EXCEPTIONS`` lists, with the
reason for each, the reference's names that need no counterpart; a
module of ``None`` needs none at all.
"""
import ast
import os

import pytest

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   "src")
REF, PORT = os.path.join(SRC, "repro"), os.path.join(SRC, "repro_torch")

EXCEPTIONS = {
    # XLA's flags for forcing host devices: the port's ranks are processes
    # (``hostdevices.spawn_world``)
    "hostdevices.py": {"DEFAULT_HOST_DEVICES", "FORCE_FLAG",
                       "force_host_devices"},
    # papers over ``shard_map`` moving between jax versions
    "shard_compat.py": None,
    # the pure-jnp kernel oracles: each kernel's plain PyTorch version sits
    # beside its wrapper in the port (the ``*_ref`` functions)
    "kernels/ref.py": None,
    # the Pallas kernel's in-kernel odd-even network over a list of rows;
    # the port's sorts are CUDA (``csrc/sort_net.cuh``)
    "kernels/cwmed.py": {"sort_rows"},
    # unjitted closures over the Pallas knobs for ``shard_map`` to compose;
    # the port's sharded paths call the wrappers on each rank's slice
    "kernels/fused_agg.py": {"make_fused_agg_fn"},
    "kernels/fused_score.py": {"make_fused_candidates_fn"},
    # the reference's blocked attention; the port's is ``models/flash.py``
    # (``KV_BLOCK`` there, the Q block an argument)
    "models/attention.py": {"Q_BLOCK", "KV_BLOCK"},
    # the chunk of the reference's chunked selective scan; the port scans
    # token by token
    "models/mamba.py": {"CHUNK"},
    # ``ShapeDtypeStruct`` stand-ins; the port's are fake tensors
    # (``make_inputs``, ``model_batch``)
    "launch/dryrun.py": {"sds", "make_input_specs", "make_val_batch_specs"},
    # a TPU link's rate (the port's is ``NVLINK_BW``) and the HLO text's
    # parser (the port counts a run: ``compute_stats``)
    "launch/hlo_stats.py": {"ICI_BW", "hlo_compute_stats"},
}


def public_names(path: str) -> set:
    tree = ast.parse(open(path).read())
    package = os.path.basename(path) == "__init__.py"
    names = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            for t in targets:
                for n in (t.elts if isinstance(t, ast.Tuple) else [t]):
                    if isinstance(n, ast.Name):
                        names.add(n.id)
        elif package and isinstance(node, (ast.Import, ast.ImportFrom)):
            names.update((a.asname or a.name).split(".")[0]
                         for a in node.names)
    return {n for n in names if not n.startswith("_")}


def reference_modules() -> list:
    out = []
    for root, _, files in os.walk(REF):
        out += [os.path.relpath(os.path.join(root, f), REF).replace(os.sep, "/")
                for f in files if f.endswith(".py")]
    return sorted(out)


@pytest.mark.parametrize("module", reference_modules())
def test_reference_module_has_port_counterpart(module):
    excepted = EXCEPTIONS.get(module, set())
    if module in EXCEPTIONS and excepted is None:
        return
    port = os.path.join(PORT, module)
    assert os.path.exists(port), f"no src/repro_torch/{module}"
    missing = public_names(os.path.join(REF, module)) - public_names(port)
    assert missing <= excepted, sorted(missing - excepted)


def test_exceptions_are_current():
    """Each exception names a reference module and names that it still
    defines and the port still lacks: a stale entry is taken out."""
    for module, names in EXCEPTIONS.items():
        ref = os.path.join(REF, module)
        assert os.path.exists(ref), module
        if names is None:
            continue
        port = public_names(os.path.join(PORT, module))
        assert names <= public_names(ref), module
        assert not names & port, (module, sorted(names & port))
