"""The port's embedding models and the on-device RAG pipeline on a card.

Marked `cuda`: each test skips with a reason where no CUDA device is
present, and runs on the card with

    python -m pytest tests/test_torch_cuda_models.py -q

The encoders on the card are held to their own forward on the CPU (same
weights): float32 within 2e-5 (summation order; TF32 is off for the
port's float32 products), bf16 at a minimum cosine of 0.999 against the
CPU's float32. `embed_device` -> `ingest_device` -> `query_columnar`
keeps every vector on the card: no host copy of a tensor of the
embedding's width is made, and each chunk retrieves itself first.
"""

import numpy as np
import pytest
import torch

from picovdb_tpu_torch import PicoVectorDB
from picovdb_tpu_torch.models import (
    BertConfig,
    BertMeanPoolEncoder,
    ByteMeanPoolEncoder,
)
from torch_port_setup import cap_torch_threads, record_host_copies

cap_torch_threads()

pytestmark = pytest.mark.cuda

CFG = dict(vocab_size=512, hidden_size=64, num_layers=2, num_heads=4,
           intermediate_size=128, max_position=64)
F32_ATOL = 2e-5
BF16_MIN_COS = 0.999


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda:0")


def _texts(n, seed=0, words=300, lo=12, hi=40):
    rng = np.random.default_rng(seed)
    vocab = np.asarray([f"w{i}" for i in range(words)])
    p = 1.0 / np.arange(1, words + 1)
    lens = rng.integers(lo, hi, n)
    draws = rng.choice(words, size=int(lens.sum()), p=p / p.sum())
    return [" ".join(vocab[d]) for d in np.split(draws, np.cumsum(lens)[:-1])]


def _min_cos(a, b):
    return float(((a * b).sum(1) / (np.linalg.norm(a, axis=1)
                                    * np.linalg.norm(b, axis=1))).min())


def test_bert_on_the_card_matches_its_cpu_forward(dev):
    texts = _texts(64)
    kw = dict(seed=3, corpus_texts=texts, max_len=48)
    host = BertMeanPoolEncoder.random_init(BertConfig(**CFG), compute_dtype=None,
                                           device="cpu", **kw).embed(texts)
    f32 = BertMeanPoolEncoder.random_init(BertConfig(**CFG), compute_dtype=None,
                                          device=dev, **kw)
    out = f32.embed_device(texts)
    assert out.device == dev and out.dtype == torch.float32
    np.testing.assert_allclose(out.cpu().numpy(), host, rtol=0, atol=F32_ATOL)
    bf16 = BertMeanPoolEncoder.random_init(BertConfig(**CFG), device=dev, **kw)
    assert _min_cos(bf16.embed(texts), host) >= BF16_MIN_COS


def test_byte_encoder_on_the_card_matches_its_cpu_forward(dev):
    texts = _texts(32, seed=1)
    kw = dict(dim=96, depth=2, heads=6, max_len=128, seed=5)
    host = ByteMeanPoolEncoder(device="cpu", **kw).embed(texts)
    out = ByteMeanPoolEncoder(device=dev, **kw).embed_device(texts)
    assert out.device == dev
    assert _min_cos(out.cpu().numpy(), host) >= BF16_MIN_COS


def test_device_pipeline_keeps_vectors_on_the_card(dev, tmp_path, monkeypatch):
    n = 33_000  # pads past SEGMAX_MIN_CAP: 2048-query chunks take K1 + K2
    texts = _texts(n, seed=2)
    enc = BertMeanPoolEncoder.random_init(BertConfig(**CFG), seed=7,
                                          corpus_texts=texts, max_len=48,
                                          device=dev)
    copies = record_host_copies(monkeypatch, CFG["hidden_size"])
    vecs = torch.cat([enc.embed_device(texts[s:s + 4096])
                      for s in range(0, n, 4096)])
    db = PicoVectorDB(embedding_dim=CFG["hidden_size"],
                      storage_file=str(tmp_path / "rag"), device=dev)
    db.ingest_device(vecs, ids=[f"c{i}" for i in range(n)])
    queries = enc.embed_device(texts[:2048])
    ids, scores = db.query_columnar(queries, top_k=10)
    assert db.last_query_debug()["strategy"] in ("segmax_mixed",
                                                 "segmax_mixed_stream")
    assert copies == [], copies
    assert [row[0] for row in ids] == [f"c{i}" for i in range(2048)]
    assert (scores[:, 0] > 0.999).all()


def test_rag_demo_on_the_card(dev, tmp_path, monkeypatch):
    from picovdb_tpu_torch.tools import rag_demo

    monkeypatch.chdir(tmp_path)
    copies = record_host_copies(monkeypatch, 384)
    got = rag_demo.main(["--device", "cuda", "--device-pipeline",
                         "--embedder", "bert-random"])
    assert got["mismatches"] == 0 and len(got["top"]) == 3
    assert copies == [], copies
