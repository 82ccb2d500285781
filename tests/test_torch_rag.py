"""The on-device RAG pipeline, port against picovdb_tpu on the CPU.

One seeded corpus of 33,000 word chunks is embedded in each package by
`BertMeanPoolEncoder.random_init(seed)` at hidden 32 (float32 compute: the
two forwards agree within 2e-5), then `ingest_device` feeds a store built
as tests/test_torch_engine.py builds its pair (`mixed_precision=True,
int8_tier=True, use_pallas=True`; 33,000 rows pad to 40,960 >=
SEGMAX_MIN_CAP, so a 64-query batch routes `segmax_mixed` in both: JAX in
Pallas interpret mode, the port through the kernels' plain versions), and
64 embedded text queries go through `query_columnar`, top-10.

Per the engine test's rule: the routes are equal, scores within
TOL_SCORE, ids equal wherever the exact k-th/(k+1)-th gap exceeds TOL_GAP.
The queries each route marks crowded (a -inf in its result, which the
engine re-serves exactly) are equal in both packages, except queries
whose float64 crowding gap (k-th minus k_sel-th exact score) lies within
TOL_GAP_MARGIN of the route's margin. A random-weight encoder's store is
nearly collinear; at hidden 32 the default margin marks none of these
queries, so one case widens it in both packages
(PICOVDB_TIE_MARGIN_SCALE=3) until the route marks a share of them, and
one case centres the store (the corpus mean subtracted, rows
renormalised, in each package on its own device arrays).

Last, the port's `tools.rag_demo --device-pipeline --embedder bert-random`
on the built-in sample gives 0 self-retrieval mismatches and the top-3 of
picovdb_tpu's `bench/rag_demo.py` with the same flags (run as a
subprocess), and copies no vector of width dim to the host.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import picovdb_tpu
import picovdb_tpu_torch
from picovdb_tpu.models import bert_encoder as jax_bert
from picovdb_tpu.ops.pallas_scan import _tie_margin
from picovdb_tpu_torch.models import BertConfig, BertMeanPoolEncoder
from picovdb_tpu_torch.tools import rag_demo
from torch_port_setup import cap_torch_threads, capped_env, record_host_copies

cap_torch_threads()

ROOT = Path(__file__).resolve().parent.parent
TOL_SCORE = 1e-5
TOL_GAP = 1e-4
TOL_GAP_MARGIN = 1e-5
N = 33_000
NQ = 64
K, GUARD = 10, 6  # the segmax route's band: k_sel = k + 6
CFG = dict(vocab_size=97, hidden_size=32, num_layers=2, num_heads=4,
           intermediate_size=64, max_position=48)
KNOBS = dict(mixed_precision=True, int8_tier=True, use_pallas=True)
WORDS = 160  # a Zipf-drawn word list larger than the 93-word vocabulary


def _corpus():
    rng = np.random.default_rng(16)
    words = np.asarray([f"w{i}" for i in range(WORDS)])
    p = 1.0 / np.arange(1, WORDS + 1)
    lens = rng.integers(30, 45, N)
    draws = rng.choice(WORDS, size=int(lens.sum()), p=p / p.sum())
    cuts = np.cumsum(lens)[:-1]
    texts = [" ".join(words[d]) for d in np.split(draws, cuts)]
    # queries: the first NQ / 2 chunks themselves (self-retrieval), then
    # the next NQ / 2 with a third of their words dropped
    queries = texts[:NQ // 2] + [
        " ".join(w for j, w in enumerate(t.split()) if j % 3 != 1)
        for t in texts[NQ // 2:NQ]]
    return texts, queries


@pytest.fixture(scope="module")
def embedded():
    """{package: (corpus vectors, query vectors)} as each package's own
    device arrays (jax.Array / CPU tensor)."""
    texts, queries = _corpus()
    jenc = jax_bert.BertMeanPoolEncoder.random_init(
        jax_bert.BertConfig(**CFG), seed=16, corpus_texts=texts, max_len=48,
        compute_dtype=None)
    tenc = BertMeanPoolEncoder.random_init(
        BertConfig(**CFG), seed=16, corpus_texts=texts, max_len=48,
        compute_dtype=None, device="cpu")
    out = {"jax": (jnp.concatenate([jenc.embed_device(texts[s:s + 8192])
                                    for s in range(0, N, 8192)]),
                   jenc.embed_device(queries)),
           "torch": (torch.cat([tenc.embed_device(texts[s:s + 8192])
                                for s in range(0, N, 8192)]),
                     tenc.embed_device(queries))}
    for a, b in zip(out["jax"], out["torch"]):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                   atol=2e-5)
    return out


def _centred(x, xp):
    x = x - x.mean(0, keepdims=True) if xp is jnp else x - x.mean(0, True)
    norm = (jnp.linalg.norm(x, axis=1, keepdims=True) if xp is jnp
            else torch.linalg.vector_norm(x, dim=1, keepdim=True))
    return x / norm


def _serve(pkg, tmp, corpus, queries):
    """ingest_device + one query_columnar in `pkg`; returns (ids, scores,
    route, queries the route marked for the exact retry)."""
    kw = {"device": "cpu"} if pkg is picovdb_tpu_torch else {}
    db = pkg.PicoVectorDB(embedding_dim=CFG["hidden_size"],
                          storage_file=str(tmp / pkg.__name__), **KNOBS,
                          **kw)
    db.ingest_device(corpus, ids=[f"c{i}" for i in range(N)])
    marks = []
    dispatch = db._dev.query_async

    def recording(chunk, k, *args, **kwargs):
        vd, xd, nq, ke = dispatch(chunk, k, *args, **kwargs)
        vals = (vd.numpy() if isinstance(vd, torch.Tensor)
                else np.asarray(vd))[:nq, :ke]
        marks.append(np.isneginf(vals).any(axis=1))
        return vd, xd, nq, ke

    db._dev.query_async = recording
    ids, scores = db.query_columnar(queries, top_k=K)
    return (ids, scores, db.last_query_debug()["strategy"],
            np.concatenate(marks))


def _exact(corpus, queries):
    v = np.asarray(corpus, dtype=np.float64)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    q = np.asarray(queries, dtype=np.float64)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    return -np.sort(-(q @ v.T), axis=1)[:, :K + GUARD]


@pytest.mark.parametrize("centred,margin_scale", [(False, 1.0), (False, 3.0),
                                                 (True, 1.0)])
def test_device_pipeline_matches_jax(tmp_path, monkeypatch, embedded,
                                     centred, margin_scale):
    # PICOVDB_TIE_MARGIN_SCALE widens the margin in both packages: at the
    # default no band of this store is crowded enough to be marked
    monkeypatch.setenv("PICOVDB_TIE_MARGIN_SCALE", str(margin_scale))
    served, exact = {}, None
    for name, pkg, xp in (("torch", picovdb_tpu_torch, torch),
                          ("jax", picovdb_tpu, jnp)):
        corpus, queries = embedded[name]
        if centred:
            corpus, queries = _centred(corpus, xp), _centred(queries, xp)
        if exact is None:
            exact = _exact(corpus, queries)
        # JAX's ingest_device donates its input: hand it a copy
        served[name] = _serve(pkg, tmp_path,
                              corpus.clone() if xp is torch else jnp.array(
                                  corpus), queries)
    (ids_t, sc_t, route_t, marks_t), (ids_j, sc_j, route_j, marks_j) = (
        served["torch"], served["jax"])
    assert route_t == route_j == "segmax_mixed"
    np.testing.assert_allclose(sc_t, sc_j, rtol=0, atol=TOL_SCORE)
    gap = exact[:, K - 1] - exact[:, K]
    for i in np.flatnonzero(gap > TOL_GAP):
        assert set(ids_t[i]) == set(ids_j[i]), i
    assert (ids_t != None).all()  # noqa: E711
    # the crowding mark: the same queries re-served in both packages,
    # outside the float tie band around the margin
    margin = _tie_margin("bf16", CFG["hidden_size"], margin_scale)
    band = np.abs((exact[:, K - 1] - exact[:, K + GUARD - 1]) - margin)
    differ = np.flatnonzero(marks_t != marks_j)
    assert (band[differ] <= TOL_GAP_MARGIN).all(), differ
    # at the widened margin the route marks a share of the queries
    assert 0 < marks_t.sum() < NQ if margin_scale > 1 else True


def test_rag_demo_matches_jax_demo(tmp_path, monkeypatch):
    flags = ["--device-pipeline", "--embedder", "bert-random"]
    env = capped_env(JAX_PLATFORMS="cpu")
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                       if p])
    (tmp_path / "jax").mkdir()
    (tmp_path / "torch").mkdir()
    proc = subprocess.Popen(
        [sys.executable, str(ROOT / "bench" / "rag_demo.py"), "--platform",
         "cpu", *flags], cwd=tmp_path / "jax", env=env, text=True,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    monkeypatch.chdir(tmp_path / "torch")
    copies = record_host_copies(monkeypatch, 384)
    got = rag_demo.main(["--device", "cpu", *flags])
    out, err = proc.communicate(timeout=240)
    assert proc.returncode == 0, err[-2000:]
    assert got["mismatches"] == 0 and got["chunks"] == 7
    assert f"self-retrieval mismatches: 0/{got['chunks']}" in out
    want = [line.split()[1].rstrip(":") for line in out.splitlines()
            if line.startswith("  ") and "chunk" in line]
    assert got["top"] == want and len(want) == 3
    assert copies == [], copies
