"""ModelAdapter: the minimal interface BFLC needs from a global model.

Port of ``repro/fl/adapter.py`` (``femnist_adapter``; the LM zoo's
``lm_adapter`` comes with ROADMAP.md Queue 1 item 12).
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch


class ModelAdapter(NamedTuple):
    init: Callable[[torch.Generator], Any]                 # generator -> params
    loss: Callable[[Any, Any, Any], torch.Tensor]          # (params, x, y) -> scalar
    accuracy: Callable[[Any, Any, Any], torch.Tensor]


def femnist_adapter(width: int = 32) -> ModelAdapter:
    from repro_torch.configs import femnist_cnn as cnn

    return ModelAdapter(
        init=lambda generator: cnn.init_params(generator, width=width),
        loss=cnn.loss_fn,
        accuracy=cnn.accuracy,
    )
