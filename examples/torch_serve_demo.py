"""Batched serving demo on the PyTorch port: prefill + decode with the
production decode step (smoke-sized gemma3: 5:1 local:global attention
with ring-buffer caches).

The port of ``examples/serve_demo.py``.  It runs the serving CLI with the
flags that CLI defines (``--slots``, ``--prompt-lens``, ``--gen-lens``),
on the GPU unless ``--device cpu`` is given; further arguments pass
through to the CLI.

  PYTHONPATH=src python examples/torch_serve_demo.py
  PYTHONPATH=src python examples/torch_serve_demo.py --device cpu
"""
import os
import subprocess
import sys


def main(argv=None) -> int:
    """Runs the CLI in a child process and returns its exit code."""
    argv = sys.argv[1:] if argv is None else list(argv)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    src = os.path.join(repo, "src")
    path = os.environ.get("PYTHONPATH")
    env = dict(os.environ, PYTHONPATH=src + (os.pathsep + path if path else ""))
    return subprocess.call(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "gemma3-4b", "--smoke", "--slots", "4", "--prompt-lens", "64",
         "--gen-lens", "16", *argv],
        env=env,
    )


if __name__ == "__main__":
    sys.exit(main())
