"""Optional sentence-transformers bridge (host torch), gated like the
reference's bench dependencies (reference: bench/st_embedding.py:1-12,
dev-requirements.txt). A copy of picovdb_tpu's `TorchSentenceEmbedder`;
`sentence_transformers` is imported only when one is constructed."""

from __future__ import annotations

import importlib.util
from typing import Iterable, Optional

import numpy as np

HAS_SENTENCE_TRANSFORMERS = (
    importlib.util.find_spec("sentence_transformers") is not None)


class TorchSentenceEmbedder:
    """Thin wrapper normalizing sentence-transformers output to float32."""

    def __init__(self, model_name: str = "all-MiniLM-L6-v2",
                 truncate_dim: Optional[int] = None) -> None:
        if not HAS_SENTENCE_TRANSFORMERS:
            raise ImportError(
                "sentence-transformers is not installed; use "
                "HashingEmbedder, BertMeanPoolEncoder or ByteMeanPoolEncoder "
                "instead"
            )
        from sentence_transformers import SentenceTransformer

        self.model = SentenceTransformer(model_name)
        self.truncate_dim = truncate_dim
        probe = self.model.encode(["probe"])
        self.dim = int(probe.shape[1] if truncate_dim is None else truncate_dim)

    def embed(self, texts: Iterable[str]) -> np.ndarray:
        out = np.asarray(self.model.encode(list(texts)), dtype=np.float32)
        if self.truncate_dim is not None:
            out = out[:, : self.truncate_dim]
        return out

    encode = embed
