"""msgpack checkpoints in the reference's format (port of
``repro.checkpoint``), over the package's own msgpack subset."""
from repro_torch.checkpoint.ckpt import (
    is_quantized_blob,
    load_model_payload,
    load_pytree,
    save_pytree,
)

__all__ = [
    "is_quantized_blob",
    "load_model_payload",
    "load_pytree",
    "save_pytree",
]
