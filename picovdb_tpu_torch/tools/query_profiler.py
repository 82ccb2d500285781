"""Scenario-matrix query profiler with CSV/JSON export.

Counterpart of picovdb_tpu's bench/query_profiler.py (the reference's
numpy_query_profiler, C25 in SURVEY.md §2): sweeps db sizes x batch
sizes across filter scenarios (baseline / where 50% / where 10% / ids
10% / ids 1% / better_than / combined) and reports mean/p50/p95 latency,
ops/sec, the route (`strategy`) and the effective k per cell, with the
same flags, rows and printed lines plus `--device cpu|cuda` (default:
the card).

`--gen host` draws the corpus with numpy exactly as picovdb_tpu's
profiler does, so both packages build the identical store from one seed.
`--gen device` fills it on the device, 131,072 rows at a time, from a
`torch.Generator` seeded by one draw of the numpy generator (the draw
picovdb_tpu's profiler seeds `jax.random` with), and adopts it through
`ingest_device`: the corpus never crosses from the host. Its rows differ
from picovdb_tpu's (another generator); the queries, drawn after it, are
the same.

Usage:
  python -m picovdb_tpu_torch.tools.query_profiler --db-sizes 10000 100000 \
      --dim 1024 --num-queries 32 --batch-sizes 1 8 64 --top-k 10 \
      [--gen host|device] [--pipeline 8] [--csv out.csv] [--json out.json] \
      [--device cpu|cuda]
"""

from __future__ import annotations

import argparse
import csv
import json
import statistics
import time

import numpy as np
import torch

from picovdb_tpu_torch import PicoVectorDB
from picovdb_tpu_torch.tools import add_device_flag, sync, tool_device

GEN_CHUNK = 131_072  # rows a generator call makes (either --gen)


def scenario_generators(n):
    """Scenario name -> query kwargs (mirrors the reference's scenarios)."""
    return {
        "baseline": lambda: {},
        "where_50pct": lambda: {"where": {"bucket2": 0}},
        "where_10pct": lambda: {"where": {"bucket10": 0}},
        "ids_10pct": lambda: {"ids": [str(i) for i in range(0, n, 10)]},
        "ids_1pct": lambda: {"ids": [str(i) for i in range(0, n, 100)]},
        "better_than": lambda: {"better_than": 0.05},
        "combined": lambda: {
            "where": {"bucket10": 0},
            "better_than": 0.0,
        },
    }


def device_corpus(n, dim, rng, device) -> torch.Tensor:
    """(n, dim) float32 standard normal rows made on `device`, GEN_CHUNK at
    a time, from a generator seeded by one draw of `rng`."""
    g = torch.Generator(device=device).manual_seed(int(rng.integers(1 << 31)))
    buf = torch.empty((n, dim), dtype=torch.float32, device=device)
    for s in range(0, n, GEN_CHUNK):
        e = min(n, s + GEN_CHUNK)
        buf[s:e] = torch.randn((e - s, dim), generator=g, device=device)
    return buf


def _make_store(n, dim, rng, gen, device=None):
    """Build the profiled store on `device` (None: the card). Row i has id
    str(i) and metadata {"bucket2": i % 2, "bucket10": i % 10}."""
    device = tool_device() if device is None else torch.device(device)
    metadata = [{"bucket2": i % 2, "bucket10": i % 10} for i in range(n)]
    ids = [str(i) for i in range(n)]
    db = PicoVectorDB(embedding_dim=dim, storage_file=f"profiler_db_{n}",
                      device=device)
    if gen == "device":
        db.ingest_device(device_corpus(n, dim, rng, device), ids=ids,
                         metadata=metadata)
    else:
        data = np.empty((n, dim), dtype=np.float32)
        for s in range(0, n, GEN_CHUNK):
            e = min(n, s + GEN_CHUNK)
            data[s:e] = rng.standard_normal((e - s, dim), dtype=np.float32)
        db.upsert_columnar(data, ids=ids, metadata=metadata, copy=False)
    return db


def run_suite(db_sizes, dim, num_queries, batch_sizes, top_k, seed=0,
              gen="host", pipeline=0, device=None):
    """Time every scenario x batch size on a store of each size in
    `db_sizes` (built by `_make_store` on `device`, None: the card);
    returns one row a cell, with picovdb_tpu's keys in its order."""
    device = tool_device() if device is None else torch.device(device)
    rng = np.random.default_rng(seed)
    rows = []
    for n in db_sizes:
        t0 = time.perf_counter()
        db = _make_store(n, dim, rng, gen, device)
        sync(device)
        print(f"# store build ({gen}): {time.perf_counter()-t0:.1f} s",
              flush=True)
        queries = rng.standard_normal(
            (max(batch_sizes) * num_queries, dim), dtype=np.float32
        )
        db.query(queries[0], top_k=top_k)  # warm: upload + mirrors (+ IVF)
        for scenario, kwargs_fn in scenario_generators(n).items():
            kwargs = kwargs_fn()
            for bs in batch_sizes:
                # per-(scenario, batch) warmup excluded from the stats, as
                # in picovdb_tpu's profiler (the first call of a filter
                # builds and caches its device mask)
                db.query(
                    queries[0] if bs == 1 else queries[:bs],
                    top_k=top_k,
                    **kwargs,
                )
                lats = []
                for it in range(num_queries):
                    q = (
                        queries[it * bs]
                        if bs == 1
                        else queries[it * bs : (it + 1) * bs]
                    )
                    t0 = time.perf_counter()
                    db.query(q, top_k=top_k, **kwargs)
                    lats.append(time.perf_counter() - t0)
                lats_ms = [x * 1000 for x in lats]
                per_query = sum(lats) / (num_queries * bs)
                rows.append(
                    {
                        "db_size": n,
                        "dim": dim,
                        "scenario": scenario,
                        "batch_size": bs,
                        "mean_ms": statistics.mean(lats_ms),
                        "p50_ms": statistics.median(lats_ms),
                        "p95_ms": sorted(lats_ms)[int(len(lats_ms) * 0.95)],
                        "ops_per_sec": 1.0 / per_query,
                        "strategy": db._last_topk_strategy,
                        "k_eff": db._last_k_eff,
                    }
                )
                print(
                    f"n={n} {scenario:>12} bs={bs:>4}: "
                    f"mean {rows[-1]['mean_ms']:.2f} ms, "
                    f"p95 {rows[-1]['p95_ms']:.2f} ms, "
                    f"{rows[-1]['ops_per_sec']:.0f} q/s",
                    flush=True,
                )
            if pipeline:
                # serving mode: `pipeline` back-to-back columnar batches at
                # the largest batch size, best of three (the filter's
                # device mask is cached, as for a production tenant filter)
                bs = max(batch_sizes)
                qb = [queries[i * bs:(i + 1) * bs] for i in range(2)]
                db.query_columnar(qb[0], top_k=top_k, **kwargs)  # warm
                best = float("inf")
                for _ in range(3):
                    t0 = time.perf_counter()
                    for i in range(pipeline):
                        db.query_columnar(qb[i % 2], top_k=top_k, **kwargs)
                    sync(device)
                    best = min(best, time.perf_counter() - t0)
                qps = pipeline * bs / best
                rows.append(
                    {
                        "db_size": n, "dim": dim,
                        "scenario": scenario + "+pipelined",
                        "batch_size": bs,
                        "mean_ms": best / pipeline * 1000,
                        "p50_ms": None, "p95_ms": None,
                        "ops_per_sec": qps,
                        "strategy": db._last_topk_strategy,
                        "k_eff": db._last_k_eff,
                    }
                )
                print(
                    f"n={n} {scenario:>12} bs={bs:>4} pipelined: "
                    f"{qps:.0f} q/s", flush=True,
                )
        del db  # free the device before the next size's store is built
    return rows


def main(argv=None) -> list:
    """Run the suite; returns its rows (and writes --csv / --json)."""
    p = argparse.ArgumentParser()
    p.add_argument("--db-sizes", type=int, nargs="+", default=[10_000])
    p.add_argument("--dim", type=int, default=1024)
    p.add_argument("--num-queries", type=int, default=16)
    p.add_argument("--batch-sizes", type=int, nargs="+", default=[1, 16, 256])
    p.add_argument("--top-k", type=int, default=10)
    p.add_argument("--gen", choices=["host", "device"], default="host",
                   help="device: corpus made on the device + ingest_device "
                        "(no host copy of the corpus)")
    p.add_argument("--pipeline", type=int, default=0,
                   help="also record a serving-mode (pipelined columnar) "
                        "QPS per scenario at the largest batch size")
    p.add_argument("--csv")
    p.add_argument("--json")
    add_device_flag(p)
    args = p.parse_args(argv)

    rows = run_suite(
        args.db_sizes, args.dim, args.num_queries, args.batch_sizes,
        args.top_k, gen=args.gen, pipeline=args.pipeline,
        device=tool_device(args.device),
    )
    if args.csv:
        with open(args.csv, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=list(rows[0].keys()))
            w.writeheader()
            w.writerows(rows)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(rows, f, indent=2)
    return rows


if __name__ == "__main__":
    main()
