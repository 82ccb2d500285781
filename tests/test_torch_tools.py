"""picovdb_tpu_torch.tools (the API-driving tools) against picovdb_tpu's
bench scripts on the CPU.

The profiler: picovdb_tpu's bench/query_profiler.py is loaded by path
(bench/ on sys.path, the test's temporary directory as the working
directory); both packages' `_make_store` build the same 2,000 x 64 store
from one seed, their `scenario_generators` yield the same scenarios, and
every scenario at batch sizes 1, 4 and 64 answers alike: scores within
1e-5, ids equal wherever the float64 k-th / (k+1)-th gap over the rows
the scenario admits exceeds 1e-4. `run_suite`'s rows carry picovdb_tpu's
keys in its order. The other four tools run in process at 500 x 64 on
the CPU and print the lines picovdb_tpu's scripts print (one regex
matches both); each tool raises without a card when no device is named;
none imports JAX or picovdb_tpu.
"""

import importlib.util
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from picovdb_tpu_torch import K_ID, K_METRICS, PicoVectorDB
from picovdb_tpu_torch.tools import (
    batch_queries,
    many_upserts,
    queries,
    query_profiler,
    upserts,
)
from torch_port_setup import cap_torch_threads

cap_torch_threads()

ROOT = Path(__file__).resolve().parent.parent
BENCH = ROOT / "bench"
TOL_SCORE = 1e-5
TOL_GAP = 1e-4
N, DIM = 2000, 64
NUM = r"\d+(?:\.\d+)?"


def load_jax_profiler():
    """picovdb_tpu's bench/query_profiler.py as a module."""
    if str(BENCH) not in sys.path:
        sys.path.insert(0, str(BENCH))
    spec = importlib.util.spec_from_file_location("jax_query_profiler",
                                                  BENCH / "query_profiler.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    """Both packages' profiled stores from seed 0, and the queries each
    profiler draws after its store."""
    cwd = os.getcwd()
    os.chdir(tmp_path_factory.mktemp("profiler"))
    try:
        jqp = load_jax_profiler()
        rj, rt = np.random.default_rng(0), np.random.default_rng(0)
        jdb = jqp._make_store(N, DIM, rj, "host")
        tdb = query_profiler._make_store(N, DIM, rt, "host", device="cpu")
        qj = rj.standard_normal((64, DIM), dtype=np.float32)
        qt = rt.standard_normal((64, DIM), dtype=np.float32)
    finally:
        os.chdir(cwd)
    np.testing.assert_array_equal(qj, qt)
    return jqp, jdb, tdb, qt


def admitted(scenario):
    """Rows (= ids) the scenario's filter admits."""
    i = np.arange(N)
    return {"where_50pct": i % 2 == 0, "where_10pct": i % 10 == 0,
            "ids_10pct": i % 10 == 0, "ids_1pct": i % 100 == 0,
            "combined": i % 10 == 0}.get(scenario, np.ones(N, dtype=bool))


def test_scenarios_match_jax(stores):
    jqp = stores[0]
    mine, theirs = (query_profiler.scenario_generators(N),
                    jqp.scenario_generators(N))
    assert list(mine) == list(theirs)
    for name in mine:
        assert mine[name]() == theirs[name](), name


def test_make_store_builds_the_same_store(stores):
    _, jdb, tdb, _ = stores
    assert tdb.count() == jdb.count() == N
    for i in (0, 1, 999, N - 1):
        a, b = tdb.get(str(i)), jdb.get(str(i))
        assert a == b == {K_ID: str(i), "bucket2": i % 2, "bucket10": i % 10}


def _hits(res, bs):
    res = [res] if bs == 1 else res
    return ([[h[K_ID] for h in hits] for hits in res],
            [[h[K_METRICS] for h in hits] for hits in res])


@pytest.mark.parametrize("scenario", list(
    query_profiler.scenario_generators(N)))
def test_every_scenario_answers_as_jax(stores, scenario):
    _, jdb, tdb, qs = stores
    kwargs = query_profiler.scenario_generators(N)[scenario]()
    k = 5
    rows = np.random.default_rng(0).standard_normal((N, DIM),
                                                    dtype=np.float32)
    rows = rows.astype(np.float64)
    rows /= np.linalg.norm(rows, axis=1, keepdims=True)
    keep = admitted(scenario)
    for bs in (1, 4, 64):
        q = qs[0] if bs == 1 else qs[:bs]
        t_ids, t_sc = _hits(tdb.query(q, top_k=k, **kwargs), bs)
        j_ids, j_sc = _hits(jdb.query(q, top_k=k, **kwargs), bs)
        assert tdb.last_query_debug()["k_eff"] == k
        qn = np.atleast_2d(q).astype(np.float64)
        qn /= np.linalg.norm(qn, axis=1, keepdims=True)
        exact = np.where(keep[None, :], qn @ rows.T, -np.inf)
        for r in range(len(t_ids)):
            assert len(t_ids[r]) == len(j_ids[r]), (bs, r)
            np.testing.assert_allclose(t_sc[r], j_sc[r], rtol=0,
                                       atol=TOL_SCORE)
            ranked = np.sort(exact[r])[::-1]
            if ranked[k - 1] - ranked[k] > TOL_GAP:
                assert sorted(t_ids[r]) == sorted(j_ids[r]), (bs, r)
            assert all(keep[int(i)] for i in t_ids[r]), (bs, r)
            if "better_than" in kwargs:
                assert all(s >= kwargs["better_than"] for s in t_sc[r])


def test_run_suite_rows_carry_jax_keys_in_order(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    args = dict(db_sizes=[500], dim=16, num_queries=2, batch_sizes=[1, 4],
                top_k=5, pipeline=2)
    mine = query_profiler.run_suite(**args, device="cpu")
    theirs = load_jax_profiler().run_suite(**args)
    assert [list(r) for r in mine] == [list(r) for r in theirs]
    key = ("db_size", "dim", "scenario", "batch_size", "k_eff")
    assert ([tuple(r[c] for c in key) for r in mine]
            == [tuple(r[c] for c in key) for r in theirs])
    assert all(r["ops_per_sec"] > 0 and r["strategy"] for r in mine)


def test_profiler_main_writes_csv_and_json(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    rows = query_profiler.main([
        "--db-sizes", "300", "--dim", "16", "--num-queries", "2",
        "--batch-sizes", "1", "4", "--top-k", "3", "--gen", "device",
        "--csv", "out.csv", "--json", "out.json", "--device", "cpu"])
    out = capsys.readouterr().out
    assert re.search(r"^# store build \(device\): " + NUM + " s$", out, re.M)
    assert len(re.findall(r"^n=300 +\w+ bs= +\d+: mean " + NUM
                          + " ms, p95 " + NUM + " ms, " + NUM + " q/s$",
                          out, re.M)) == 14 == len(rows)
    import json

    assert json.loads((tmp_path / "out.json").read_text()) == rows
    assert (tmp_path / "out.csv").read_text().splitlines()[0].split(",") == \
        list(rows[0])


def test_device_gen_fills_from_one_numpy_draw():
    """--gen device: one draw of the numpy generator seeds the torch
    generator (the draw picovdb_tpu's profiler seeds jax.random with), so
    the queries drawn after the store are those picovdb_tpu's --gen device
    draws."""
    rng = np.random.default_rng(5)
    buf = query_profiler.device_corpus(300_000, 2, rng, torch.device("cpu"))
    seed = int(np.random.default_rng(5).integers(1 << 31))
    g = torch.Generator().manual_seed(seed)
    want = torch.cat([torch.randn(131_072, 2, generator=g),
                      torch.randn(131_072, 2, generator=g),
                      torch.randn(300_000 - 262_144, 2, generator=g)])
    assert torch.equal(buf, want)
    ref = np.random.default_rng(5)
    ref.integers(1 << 31)
    assert rng.standard_normal(3).tolist() == ref.standard_normal(3).tolist()


# The four simple tools: argv at 500 x 64, and the lines both packages'
# scripts print (one regex each, in order)
SIMPLE = {
    "upserts": (upserts, ["--n", "500", "--dim", "64"], [
        rf"insert 500x64: {NUM} s \({NUM} vec/s\), save: {NUM} s",
        r"  bench_upserts_db\.ids\.json: \d+\.\d MB",
        r"  bench_upserts_db\.vecs\.npy: \d+\.\d MB",
        r"  bench_upserts_db\.meta\.json: \d+\.\d MB"]),
    "many_upserts": (many_upserts, ["--n", "500", "--dim", "64"], [
        rf"500 single upserts: {NUM} s \({NUM} us/call, {NUM} vec/s\)"]),
    "queries": (queries, ["--n", "500", "--dim", "64", "--queries", "10"], [
        rf"10 single queries over 500: {NUM} s total, p50 {NUM} ms, "
        rf"p95 {NUM} ms"]),
    "batch_queries": (batch_queries, ["--n", "500", "--dim", "64",
                                      "--batches", "3", "--batch", "5"], [
        rf"reference mode \(3x5 query calls\): {NUM} s -> {NUM} QPS",
        rf"query_batched \(pipelined dicts\): {NUM} s -> {NUM} QPS",
        rf"query_columnar \(serving\): {NUM} s -> {NUM} QPS"]),
}


def assert_lines(out, patterns):
    lines = [ln for ln in out.splitlines() if ln.strip()]
    assert len(lines) == len(patterns), lines
    for ln, pat in zip(lines, patterns):
        assert re.fullmatch(pat, ln), (ln, pat)


@pytest.mark.parametrize("name", list(SIMPLE))
def test_simple_tool_on_cpu(name, tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    mod, argv, patterns = SIMPLE[name]
    got = mod.main(argv + ["--device", "cpu"])
    assert_lines(capsys.readouterr().out, patterns)
    if name == "upserts":
        assert got["inserted"] == 500 and len(got["files"]) == 3
        back = PicoVectorDB(embedding_dim=64, storage_file="bench_upserts_db",
                            device="cpu")
        assert back.count() == 500 and back.get("499")[K_ID] == "499"
    elif name == "many_upserts":
        assert got["calls"] == got["count"] == 500
    elif name == "queries":
        assert got["p50_ms"] <= got["p95_ms"]
        assert 0 < len(got["results"]) <= 10
        assert all(h[K_METRICS] >= 0.1 for h in got["results"])
    else:
        assert got["answers"] == {"reference": 15, "query_batched": 15,
                                  "query_columnar": 15}


@pytest.mark.parametrize("name", list(SIMPLE))
def test_jax_script_prints_the_same_line_shape(name, tmp_path):
    """The regexes above are picovdb_tpu's scripts' line shapes: run each
    script (a subprocess, JAX on the CPU) at a small size."""
    _, argv, patterns = SIMPLE[name]
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, str(BENCH / f"{name}.py")] + argv,
                         capture_output=True, text=True, cwd=tmp_path,
                         env=env, timeout=240, check=True).stdout
    assert_lines(out, patterns)


@pytest.mark.parametrize("name", list(SIMPLE) + ["query_profiler"])
def test_tool_raises_without_a_card(name, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    if name == "query_profiler":
        mod, argv = query_profiler, ["--db-sizes", "100", "--dim", "8"]
    else:
        mod, argv = SIMPLE[name][:2]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main(argv)
    if name == "query_profiler":
        with pytest.raises(RuntimeError, match="no CUDA device"):
            query_profiler._make_store(10, 8, np.random.default_rng(0),
                                       "host")


def test_tools_import_no_jax():
    code = (
        "import sys\n"
        "before = set(sys.modules)\n"
        "import picovdb_tpu_torch.tools.upserts, "
        "picovdb_tpu_torch.tools.many_upserts, "
        "picovdb_tpu_torch.tools.queries, "
        "picovdb_tpu_torch.tools.batch_queries, "
        "picovdb_tpu_torch.tools.query_profiler, "
        "picovdb_tpu_torch.graft_entry\n"
        "added = set(sys.modules) - before\n"
        "bad = sorted(m for m in added if m.split('.')[0] in "
        "('jax', 'jaxlib', 'ml_dtypes', 'picovdb_tpu', 'flax'))\n"
        "print(','.join(bad))\n"
    )
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                       if p])
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=ROOT, timeout=120, check=True)
    assert out.stdout.strip() == "", out.stdout
