"""Embedding models feeding the vector store (counterpart of
picovdb_tpu.models).

An embedder can run on the same CUDA device as the store, so corpus and
query embeddings stay on the card end to end: `embed_device` returns a
tensor that `PicoVectorDB.ingest_device` and `query_columnar` take with no
host round trip.

Four tiers:
  * HashingEmbedder — deterministic, dependency-free text embedder
    (feature-hashed n-grams), bit for bit picovdb_tpu's. Good for tests,
    demos and smoke benches.
  * BertMeanPoolEncoder — BERT encoder (MiniLM-L6 widths by default) as a
    torch module on the card, running real HuggingFace checkpoints via
    `convert_hf_state_dict` / `from_pretrained`, or `random_init(seed)`'s
    weights, the same as picovdb_tpu's for the same seed.
  * ByteMeanPoolEncoder — the counterpart of picovdb_tpu's
    FlaxMeanPoolEncoder: a small byte-level transformer with mean pooling;
    random weights by default, or a flax parameter tree.
  * TorchSentenceEmbedder — optional bridge to sentence-transformers on
    the host, gated on availability like the reference's bench deps.

Nothing here imports JAX, flax, `transformers` or `sentence_transformers`
when the package is imported.
"""

from .hashing import HashingEmbedder  # noqa: F401
from .bert_encoder import (  # noqa: F401
    BertConfig,
    BertMeanPoolEncoder,
    WordVocabTokenizer,
    convert_hf_state_dict,
    init_params,
    params_from_jax,
)
from .byte_encoder import ByteMeanPoolEncoder  # noqa: F401
from .torch_st import HAS_SENTENCE_TRANSFORMERS, TorchSentenceEmbedder  # noqa: F401

# picovdb_tpu's HAS_FLAX_ENCODER under the port's name: the byte encoder
# needs only torch, so it is always there
HAS_BYTE_ENCODER = True
