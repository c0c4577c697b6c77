"""Text encoders behind ``prompt.model_id``.

Port of the JAX package's ``prompt/encoders.py::build_encode_fn``.  Only
the mock path is ported: ``"mock"`` or an empty id gives ``None``, which
makes the prompt processor use :func:`..processors.mock_encode`.  The
CLIP and T5 encoders that read a local model directory are a later slice.
"""

from __future__ import annotations

from typing import Callable, Optional


def build_encode_fn(model_id: str,
                    kind: Optional[str] = None) -> Optional[Callable]:
    """Resolve a prompt model_id to an encode_fn (None: mock embeddings)."""
    if not model_id or model_id == "mock":
        return None
    raise NotImplementedError(
        f"prompt.model_id {model_id!r}: the CLIP/T5 text encoders wait for "
        "the prompt-encoder slice; use model_id 'mock'")
