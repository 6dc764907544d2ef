"""The benchmark of the PyTorch / CUDA port (``src/repro_torch``): whole
BFLC rounds timed on one NVIDIA GPU.  ``python3 bench/run.py --help``."""
