"""Sequential single-query latency over a random corpus.

Counterpart of picovdb_tpu's bench/queries.py (the reference's 100
sequential 1024-d queries, top-10, better_than=0.1), with the same flags
and printed line plus `--device cpu|cuda` (default: the card). Each
`query` returns host dicts, so each call's time ends after the card's
work for it.

Usage:
  python -m picovdb_tpu_torch.tools.queries [--n 100000] [--dim 1024]
      [--queries 100] [--topk 10] [--device cpu|cuda]
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from picovdb_tpu_torch import K_ID, K_VECTOR, PicoVectorDB
from picovdb_tpu_torch.tools import add_device_flag, tool_device


def main(argv=None) -> dict:
    """Run the benchmark; returns {"total_s", "p50_ms", "p95_ms",
    "results": the last query's hits, "strategy": its route}."""
    p = argparse.ArgumentParser()
    p.add_argument("--n", type=int, default=100_000)
    p.add_argument("--dim", type=int, default=1024)
    p.add_argument("--queries", type=int, default=100)
    p.add_argument("--topk", type=int, default=10)
    add_device_flag(p)
    args = p.parse_args(argv)
    device = tool_device(args.device)

    rng = np.random.default_rng(0)
    data = rng.normal(size=(args.n, args.dim)).astype(np.float32)
    db = PicoVectorDB(embedding_dim=args.dim, storage_file="bench_queries_db",
                      device=device)
    db.upsert([{K_ID: str(i), K_VECTOR: data[i]} for i in range(args.n)])

    qs = rng.normal(size=(args.queries, args.dim)).astype(np.float32)
    db.query(qs[0], top_k=args.topk)  # warm: device upload + mirrors

    lat = []
    res = []
    t0 = time.perf_counter()
    for i in range(args.queries):
        t = time.perf_counter()
        res = db.query(qs[i], top_k=args.topk, better_than=0.1)
        lat.append(time.perf_counter() - t)
    total = time.perf_counter() - t0
    lat.sort()
    p50, p95 = lat[len(lat) // 2] * 1000, lat[int(len(lat) * 0.95)] * 1000
    print(f"{args.queries} single queries over {args.n}: {total:.3f} s total, "
          f"p50 {p50:.2f} ms, p95 {p95:.2f} ms")
    return {"total_s": total, "p50_ms": p50, "p95_ms": p95, "results": res,
            "strategy": db.last_query_debug()["strategy"]}


if __name__ == "__main__":
    main()
