"""Bulk-upsert benchmark: insert N x dim random vectors, then save.

Counterpart of picovdb_tpu's bench/upserts.py (the reference's 100k x
1024-d bulk insert + save timing), with the same flags and printed lines
plus `--device cpu|cuda` (default: the card). As in picovdb_tpu, the
upsert fills the host's rows and the card takes them at the store's next
read, which this tool does not make.

Usage:
  python -m picovdb_tpu_torch.tools.upserts [--n 100000] [--dim 1024]
      [--db bench_upserts_db] [--device cpu|cuda]
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np

from picovdb_tpu_torch import K_ID, K_VECTOR, PicoVectorDB
from picovdb_tpu_torch.tools import add_device_flag, tool_device

SUFFIXES = (".ids.json", ".vecs.npy", ".meta.json")


def main(argv=None) -> dict:
    """Run the benchmark; returns {"inserted", "insert_s", "save_s",
    "files": {path: bytes}}."""
    p = argparse.ArgumentParser()
    p.add_argument("--n", type=int, default=100_000)
    p.add_argument("--dim", type=int, default=1024)
    p.add_argument("--db", default="bench_upserts_db")
    add_device_flag(p)
    args = p.parse_args(argv)
    device = tool_device(args.device)

    rng = np.random.default_rng(0)
    data = rng.normal(size=(args.n, args.dim)).astype(np.float32)
    items = [{K_ID: str(i), K_VECTOR: data[i]} for i in range(args.n)]

    db = PicoVectorDB(embedding_dim=args.dim, storage_file=args.db,
                      device=device)
    t0 = time.perf_counter()
    report = db.upsert(items)
    t1 = time.perf_counter()
    db.save()
    t2 = time.perf_counter()
    print(f"insert {args.n}x{args.dim}: {t1 - t0:.3f} s "
          f"({args.n / (t1 - t0):.0f} vec/s), save: {t2 - t1:.3f} s")
    assert len(report["insert"]) == args.n
    files = {}
    for suffix in SUFFIXES:
        path = args.db + suffix
        if os.path.exists(path):
            files[path] = os.path.getsize(path)
            print(f"  {path}: {files[path] / 1e6:.1f} MB")
    return {"inserted": len(report["insert"]), "insert_s": t1 - t0,
            "save_s": t2 - t1, "files": files}


if __name__ == "__main__":
    main()
