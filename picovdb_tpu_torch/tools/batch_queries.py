"""Batched query throughput.

Counterpart of picovdb_tpu's bench/batch_queries.py (the reference's 20
batches x 50 queries over 100k x 1024-d, plus the `query_batched` and
`query_columnar` throughput modes), with the same flags and printed lines
plus `--device cpu|cuda` (default: the card). Every mode returns host
results (dicts, or `query_columnar`'s id and score arrays), which wait for
the card; each timed region also ends in a synchronize.

Usage:
  python -m picovdb_tpu_torch.tools.batch_queries [--n 100000] [--dim 1024]
      [--batches 20] [--batch 50] [--topk 10] [--device cpu|cuda]
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from picovdb_tpu_torch import K_ID, K_VECTOR, PicoVectorDB
from picovdb_tpu_torch.tools import add_device_flag, sync, tool_device


def main(argv=None) -> dict:
    """Run the benchmark; returns {mode: QPS} for "reference",
    "query_batched" and "query_columnar", and "answers": each mode's
    number of answered queries."""
    p = argparse.ArgumentParser()
    p.add_argument("--n", type=int, default=100_000)
    p.add_argument("--dim", type=int, default=1024)
    p.add_argument("--batches", type=int, default=20)
    p.add_argument("--batch", type=int, default=50)
    p.add_argument("--topk", type=int, default=10)
    add_device_flag(p)
    args = p.parse_args(argv)
    device = tool_device(args.device)

    rng = np.random.default_rng(0)
    data = rng.normal(size=(args.n, args.dim)).astype(np.float32)
    db = PicoVectorDB(embedding_dim=args.dim, storage_file="bench_batch_db",
                      device=device)
    db.upsert([{K_ID: str(i), K_VECTOR: data[i]} for i in range(args.n)])

    total_q = args.batches * args.batch
    qs = rng.normal(size=(total_q, args.dim)).astype(np.float32)
    db.query(qs[:args.batch], top_k=args.topk)  # warm
    out, answers = {}, {}

    t0 = time.perf_counter()
    ref = []
    for b in range(args.batches):
        ref.extend(db.query(qs[b * args.batch:(b + 1) * args.batch],
                            top_k=args.topk))
    sync(device)
    dt = time.perf_counter() - t0
    out["reference"], answers["reference"] = total_q / dt, len(ref)
    print(f"reference mode ({args.batches}x{args.batch} query calls): "
          f"{dt:.3f} s -> {total_q/dt:.0f} QPS")

    t0 = time.perf_counter()
    res = db.query_batched(qs, top_k=args.topk)
    sync(device)
    dt = time.perf_counter() - t0
    out["query_batched"], answers["query_batched"] = total_q / dt, len(res)
    print(f"query_batched (pipelined dicts): {dt:.3f} s -> {total_q/dt:.0f} QPS")

    t0 = time.perf_counter()
    col_ids, _ = db.query_columnar(qs, top_k=args.topk)
    sync(device)
    dt = time.perf_counter() - t0
    out["query_columnar"] = total_q / dt
    answers["query_columnar"] = col_ids.shape[0]
    print(f"query_columnar (serving): {dt:.3f} s -> {total_q/dt:.0f} QPS")
    return {**out, "answers": answers}


if __name__ == "__main__":
    main()
