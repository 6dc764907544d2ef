"""Single source of the kernels' lane tiling.

The int8 codec stores one scale per BLOCK_D-lane tile of the flattened
update, and the fused aggregation applies those scales tile by tile, so
every module (and the CUDA sources, which repeat the constant in
``csrc/common.cuh``) must agree on it.  It is the reference's tile
(``repro/kernels/tiling.py``): a different width would change every scale
on the chain.
"""
BLOCK_D = 2048
