"""Per-call upsert overhead: N single-item upsert calls.

Counterpart of picovdb_tpu's bench/many_upserts.py (the reference's 10k
one-at-a-time upserts), with the same flags and printed line plus
`--device cpu|cuda` (default: the card). As in picovdb_tpu, an upsert
updates the host's rows and marks the store dirty; the card's planes take
the new rows at the store's next read, so this times the host's per-call
bookkeeping.

Usage:
  python -m picovdb_tpu_torch.tools.many_upserts [--n 10000] [--dim 1024]
      [--db bench_many_upserts_db] [--device cpu|cuda]
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from picovdb_tpu_torch import K_ID, K_VECTOR, PicoVectorDB
from picovdb_tpu_torch.tools import add_device_flag, tool_device


def main(argv=None) -> dict:
    """Run the benchmark; returns {"calls", "seconds", "count"} (count: the
    store's rows after the calls)."""
    p = argparse.ArgumentParser()
    p.add_argument("--n", type=int, default=10_000)
    p.add_argument("--dim", type=int, default=1024)
    p.add_argument("--db", default="bench_many_upserts_db")
    add_device_flag(p)
    args = p.parse_args(argv)
    device = tool_device(args.device)

    rng = np.random.default_rng(0)
    data = rng.normal(size=(args.n, args.dim)).astype(np.float32)
    db = PicoVectorDB(embedding_dim=args.dim, storage_file=args.db,
                      device=device)

    t0 = time.perf_counter()
    for i in range(args.n):
        db.upsert([{K_ID: str(i), K_VECTOR: data[i]}])
    dt = time.perf_counter() - t0
    print(f"{args.n} single upserts: {dt:.3f} s "
          f"({dt / args.n * 1e6:.1f} us/call, {args.n / dt:.0f} vec/s)")
    return {"calls": args.n, "seconds": dt, "count": db.count()}


if __name__ == "__main__":
    main()
