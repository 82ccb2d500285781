"""Deterministic feature-hashing text embedder (no model weights).

Maps text to a dim-dimensional unit vector by hashing word n-grams into
buckets with signed counts — the classic hashing trick. Retrieval-grade for
lexical similarity, fully deterministic, zero dependencies: used by the
RAG demo (`python -m picovdb_tpu_torch.tools.rag_demo`) and tests the way
the reference's bench uses MiniLM (reference: bench/st_embedding.py:13-32),
without network or weights. A copy of picovdb_tpu's `HashingEmbedder`
(numpy only); the two give the same vectors bit for bit.
"""

from __future__ import annotations

import hashlib
import re
from typing import Iterable, List

import numpy as np

_TOKEN_RE = re.compile(r"[a-z0-9]+")


def _stable_hash(token: str) -> int:
    return int.from_bytes(
        hashlib.blake2b(token.encode("utf-8"), digest_size=8).digest(), "little"
    )


class HashingEmbedder:
    def __init__(self, dim: int = 384, ngrams: int = 2) -> None:
        self.dim = dim
        self.ngrams = ngrams

    def _tokens(self, text: str) -> List[str]:
        words = _TOKEN_RE.findall(text.lower())
        toks = list(words)
        for n in range(2, self.ngrams + 1):
            toks.extend(
                "_".join(words[i : i + n]) for i in range(len(words) - n + 1)
            )
        return toks

    def embed_one(self, text: str) -> np.ndarray:
        v = np.zeros(self.dim, dtype=np.float32)
        for tok in self._tokens(text):
            h = _stable_hash(tok)
            bucket = h % self.dim
            sign = 1.0 if (h >> 63) & 1 else -1.0
            v[bucket] += sign
        n = np.linalg.norm(v)
        if n:
            v /= n
        else:
            v[0] = 1.0
        return v

    def embed(self, texts: Iterable[str]) -> np.ndarray:
        return np.stack([self.embed_one(t) for t in texts])

    # sentence-transformers-compatible alias
    encode = embed
