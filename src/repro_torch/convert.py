"""Parameter trees and train states across the two packages, through numpy.

The reference's params become numpy with ``jax.tree.map(np.asarray, p)``;
``from_numpy_tree`` turns that nested dict into the port's dict of tensors
with the same keys, shapes and layouts (HWIO conv kernels, (in, out) dense
weights; an LM's ``units`` and ``tail`` stay tuples and its unit leaves
keep their leading ``num_units`` axis, so ``tree_paths`` walks the
reference's key paths in order; an MoE layer's ``router`` (D, E) and
expert ``gate`` / ``up`` (E, D, F) and ``down`` (E, F, D), an RWKV-6
layer's time-mix and channel-mix leaves, a Mamba layer's leaves with its
float32 ``A_log`` (d_inner, d_state) whatever the model's dtype, and the
audio frontend's ``mask_emb`` (D,) and ``conv_pos`` kernel (31, D/16, D)
and bias, cross as they are), and ``to_numpy_tree`` is its inverse.
bfloat16 arrays (the reference's ``moment_dtype=jnp.bfloat16`` moments,
numpy arrays of ``ml_dtypes.bfloat16``) cross through an int16 view;
going back, bfloat16 tensors become float32 arrays, which hold every
bfloat16 value exactly (numpy has no bfloat16 of its own).

``train_state_from_numpy`` / ``train_state_to_numpy`` carry a reference
``TrainState`` — its params, its optimizer state (AdamW's ``m`` and
``v``, SGD's ``mu`` or nothing) and its step — to the port's and back.
"""
from __future__ import annotations

from typing import Any, Tuple

import numpy as np
import torch

from repro_torch.tree import tree_map


def _tensor(a, device) -> torch.Tensor:
    arr = np.asarray(a)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16).copy()).view(
            torch.bfloat16).to(device)
    return torch.tensor(arr, device=device)


def _array(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.to(torch.float32)
    return t.numpy()


def from_numpy_tree(tree: Any, device="cpu") -> Any:
    return tree_map(lambda a: _tensor(a, device), tree)


def to_numpy_tree(tree: Any) -> Any:
    return tree_map(_array, tree)


def train_state_from_numpy(params: Any, opt_state: Any, step,
                           device="cpu"):
    """A reference train state's parts (numpy trees and the step) as the
    port's ``launch.steps.TrainState`` on ``device``."""
    from repro_torch.launch.steps import TrainState

    return TrainState(
        from_numpy_tree(params, device),
        from_numpy_tree(opt_state, device),
        torch.tensor(int(np.asarray(step)), dtype=torch.int32, device=device),
    )


def train_state_to_numpy(state) -> Tuple[Any, Any, np.ndarray]:
    """The port's ``TrainState`` as (params, opt_state, step) in numpy, the
    parts of the reference's ``TrainState``."""
    return (to_numpy_tree(state.params), to_numpy_tree(state.opt_state),
            np.asarray(int(state.step), np.int32))
