"""ModelAdapter: the minimal interface BFLC needs from a global model.

Port of ``repro/fl/adapter.py``: the chain stores parameter trees, the
committee needs loss and accuracy; the FEMNIST CNN of the paper's
experiments and the LM zoo plug in through this.
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


def lm_adapter(cfg) -> ModelAdapter:
    """Language-model adapter: x = tokens (B, S), y = next-token targets."""
    import torch.nn.functional as F

    from repro_torch.models import forward, init_model
    from repro_torch.models.transformer import Batch

    def batch_of(tokens, targets):
        positions = torch.arange(tokens.shape[1], dtype=torch.int32,
                                 device=tokens.device)[None].expand(
                                     tokens.shape)
        return Batch(tokens=tokens, positions=positions, targets=targets)

    def loss(params, tokens, targets):
        logits, aux = forward(params, cfg, batch_of(tokens, targets))
        logp = F.log_softmax(logits.to(torch.float32), dim=-1)
        nll = -torch.gather(logp, -1, targets.long()[..., None])[..., 0]
        return nll.mean() + aux

    def accuracy(params, tokens, targets):
        logits, _ = forward(params, cfg, batch_of(tokens, targets))
        return (logits.argmax(-1) == targets).to(torch.float32).mean()

    return ModelAdapter(
        init=lambda generator: init_model(generator, cfg),
        loss=loss,
        accuracy=accuracy,
    )
