#!/usr/bin/env python3
"""Smoke run of picovdb_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Builds the hand-written kernels from `picovdb_tpu_torch/csrc`, checks each
one against its plain PyTorch version on the card, then drives the exact
scan serving path through the public `PicoVectorDB` API on a 1M x 1024
float32 store and checks what comes back. Every phase prints one line;
any failure raises and the script exits non-zero without a result line.
It imports neither JAX nor picovdb_tpu, and refuses to run without a card.

Output, in order: one line per phase, the card's name and power limit as
`nvidia-smi` reports them, one JSON object with the per-kernel record, and
last `{"ok": true, "device": {...}}`.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

SEED = 1234
DIM = 1024
PHASE2_CAP = 131_072
MAIN_N = 1_000_000
TOL_SCORE = 1e-5  # rescored scores: both sides are float32 dot products
TOL_GAP = 1e-4  # id sets must agree where the k-th/(k+1)-th gap exceeds it

KERNELS = {
    # name: (launch-counter key, source, TPU kernel it replaces)
    "segmax_scan": ("segmax", "picovdb_tpu_torch/csrc/segmax.cu",
                    "picovdb_tpu/ops/pallas_scan.py:443"),
    "topk_packed_keys": ("topk_keys", "picovdb_tpu_torch/csrc/topk_keys.cu",
                         "picovdb_tpu/ops/pallas_scan.py:536"),
    "fused_topk_i8": ("scan_topk_i8", "picovdb_tpu_torch/csrc/scan_topk.cu",
                      "picovdb_tpu/ops/pallas_scan.py:865"),
    "fused_topk": ("scan_topk", "picovdb_tpu_torch/csrc/scan_topk.cu",
                   "picovdb_tpu/ops/pallas_scan.py:226"),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0].strip()


def cuda_ms(torch, fn, reps: int = 10) -> float:
    """Median per-call time of `fn` over `reps` runs, by CUDA events."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def ids_agree(torch, ids_a, ids_b, vals_b, k: int) -> float:
    """Fraction of queries whose top-k id sets differ although `vals_b`
    (k+1 descending reference scores) separates rank k from rank k+1 by
    more than TOL_GAP; must be 0."""
    a = ids_a[:, :k].cpu().numpy()
    b = ids_b[:, :k].cpu().numpy()
    v = vals_b.cpu().numpy()
    gap = v[:, k - 1] - v[:, k]
    bad = 0
    for i in range(a.shape[0]):
        if gap[i] > TOL_GAP and set(a[i]) != set(b[i]):
            bad += 1
    return bad / a.shape[0]


def phase_kernels(torch, scan, device, cap: int, dim: int, rng):
    """Each kernel against its plain version on the card, at main-path
    shapes; returns {kernel: (max_abs_err, ms, plain_ms)}."""
    from picovdb_tpu_torch.ops.exact import normalize_on_device

    corpus = normalize_on_device(
        torch.from_numpy(rng.standard_normal((cap, dim), dtype=np.float32))
        .to(device))
    lp = corpus.to(torch.bfloat16)
    v8, vs = scan.quantize_rows_i8(corpus)
    mask = torch.from_numpy(rng.random(cap) >= 0.1).to(device)
    rec = {}

    # K1 + K2 at Q = 2048, k = 10 (segmax route: k_sel = k + 6)
    k = 10
    q = normalize_on_device(
        torch.from_numpy(rng.standard_normal((2048, dim), dtype=np.float32))
        .to(device))
    qb = q.to(torch.bfloat16)
    keys = scan.segmax_scan(qb, lp, mask)
    keys_p = scan.segmax_scan_plain(qb, lp, mask)
    torch.cuda.synchronize()
    assert keys.shape == keys_p.shape, (keys.shape, keys_p.shape)

    def key_vals(kk):
        f = scan._from_sortable(kk & ~(scan.SEG - 1)).view(torch.float32)
        return torch.where(kk == scan.KEY_MIN, 0.0, f)

    assert torch.equal(keys == scan.KEY_MIN, keys_p == scan.KEY_MIN)
    err1 = float((key_vals(keys) - key_vals(keys_p)).abs().max())
    assert err1 <= 1e-4, f"segmax keys differ by {err1}"
    tk, ti = scan.topk_packed_keys(keys, k + 6)
    tk_p, ti_p = scan.topk_packed_keys_plain(keys, k + 6)
    assert torch.equal(tk, tk_p), "topk_packed_keys keys differ"
    assert torch.equal(torch.gather(keys, 1, ti.long()), tk), "bad columns"
    err2 = float((key_vals(tk) - key_vals(tk_p)).abs().max())

    def decode_rescore(tk, ti):
        gidx = (ti // 2) * scan.SEG + (tk & (scan.SEG - 1))
        empty = tk == scan.KEY_MIN
        vals = torch.where(empty, float("-inf"), 0.0)
        return scan.rescore_exact(q, corpus, vals, torch.where(empty, 0, gidx))

    ex_k, id_k = decode_rescore(tk, ti)
    ex_p, id_p = decode_rescore(*scan.topk_packed_keys_plain(keys_p, k + 6))
    assert float((ex_k[:, :k] - ex_p[:, :k]).abs().max()) <= TOL_SCORE
    assert ids_agree(torch, id_k, id_p, ex_p, k) == 0.0
    rec["segmax_scan"] = (
        err1, cuda_ms(torch, lambda: scan.segmax_scan(qb, lp, mask)),
        cuda_ms(torch, lambda: scan.segmax_scan_plain(qb, lp, mask)))
    rec["topk_packed_keys"] = (
        err2, cuda_ms(torch, lambda: scan.topk_packed_keys(keys, k + 6)),
        cuda_ms(torch, lambda: scan.topk_packed_keys_plain(keys, k + 6)))
    del keys, keys_p
    log(f"phase 2: K1 segmax_scan + K2 topk_packed_keys agree at Q=2048 "
        f"k={k} cap={cap} (K1 max |dkey value| {err1:.3g}, K2 exact)")

    def check_scan(name, qq, vv, scale, msk, ksel, rescore_q):
        if scale is None:
            got = scan.fused_topk(qq, vv, msk, ksel)
        else:
            got = scan.fused_topk_i8(qq, vv, scale, msk, ksel)
        ref = scan.scan_topk_plain(qq, vv, scale, msk, ksel + 1)
        torch.cuda.synchronize()
        err = float((got[0] - ref[0][:, :ksel]).abs().max())
        assert err <= TOL_SCORE, f"{name} scores differ by {err}"
        assert ids_agree(torch, got[1], ref[1], ref[0], ksel) == 0.0, name
        assert bool(msk[got[1].long()].all()), f"{name} returned masked rows"
        ex_k, id_k = scan.rescore_exact(rescore_q, corpus, got[0], got[1])
        ex_p, _ = scan.rescore_exact(rescore_q, corpus, ref[0][:, :ksel],
                                     ref[1][:, :ksel])
        assert float((ex_k - ex_p).abs().max()) <= TOL_SCORE, name
        return err

    # K3 at Q = 1, 8, 16, k = 10 (small-batch route: k_sel = k + 4)
    errs, ms, pms = [], [], []
    for nq in (1, 8, 16):
        qf = normalize_on_device(
            torch.from_numpy(rng.standard_normal((nq, dim), dtype=np.float32))
            .to(device))
        q8, _ = scan.quantize_rows_i8(qf)
        errs.append(check_scan("fused_topk_i8", q8, v8, vs, mask, 14, qf))
        ms.append(cuda_ms(torch, lambda: scan.fused_topk_i8(q8, v8, vs, mask, 14)))
        pms.append(cuda_ms(torch, lambda: scan.scan_topk_plain(q8, v8, vs, mask, 14)))
    rec["fused_topk_i8"] = (max(errs), ms[0], pms[0])
    log(f"phase 2: K3 fused_topk_i8 agrees at Q=1,8,16 k_sel=14 "
        f"(ms {', '.join(f'{m:.4f}' for m in ms)}; plain "
        f"{', '.join(f'{m:.4f}' for m in pms)})")

    # K4 on the bf16 mirror at Q = 64, k = 32 (k_sel 36) with a filter
    q64 = normalize_on_device(
        torch.from_numpy(rng.standard_normal((64, dim), dtype=np.float32))
        .to(device))
    fmask = mask & torch.from_numpy(rng.random(cap) < 0.3).to(device)
    e_bf = check_scan("fused_topk bf16", q64, lp, None, fmask, 36, q64)
    ms_bf = cuda_ms(torch, lambda: scan.fused_topk(q64, lp, fmask, 36))
    pms_bf = cuda_ms(torch, lambda: scan.scan_topk_plain(q64, lp, None, fmask, 36))
    # K4 on the f32 corpus at k_sel = 1024 (the exact retry's widest)
    e_f32 = check_scan("fused_topk f32", q64[:16], corpus, None, mask, 1024,
                       q64[:16])
    ms_f32 = cuda_ms(torch, lambda: scan.fused_topk(q64[:16], corpus, mask, 1024))
    pms_f32 = cuda_ms(
        torch, lambda: scan.scan_topk_plain(q64[:16], corpus, None, mask, 1024))
    rec["fused_topk"] = (max(e_bf, e_f32), ms_bf, pms_bf)
    log(f"phase 2: K4 fused_topk agrees: bf16 Q=64 k_sel=36 filtered "
        f"{ms_bf:.4f} ms (plain {pms_bf:.4f}); f32 Q=16 k_sel=1024 "
        f"{ms_f32:.4f} ms (plain {pms_f32:.4f})")
    del corpus, lp, v8, vs
    torch.cuda.empty_cache()
    return rec


def oracle_top10(torch, corpus_dev, queries_dev, live_rows):
    """Float64 top-10 rows per query over the live rows, on the card."""
    q = queries_dev.double()
    q = q / q.norm(dim=1, keepdim=True)
    best_v = torch.full((q.shape[0], 10), float("-inf"), dtype=torch.float64,
                        device=q.device)
    best_i = torch.zeros((q.shape[0], 10), dtype=torch.int64, device=q.device)
    step = 131_072
    for s in range(0, corpus_dev.shape[0], step):
        sc = q @ corpus_dev[s:s + step].double().T
        sc[:, ~live_rows[s:s + step]] = float("-inf")
        v, i = torch.cat([best_v, sc], 1), torch.cat(
            [best_i, torch.arange(s, s + sc.shape[1], device=q.device)
             .expand(q.shape[0], -1)], 1)
        best_v, pos = torch.topk(v, 10, dim=1)
        best_i = torch.gather(i, 1, pos)
    return best_i.cpu().numpy()


def phase_main(torch, scan, device, n: int, dim: int, rng, card: str,
               **db_kwargs):
    """The serving path through the public API on an n x dim store
    (`db_kwargs` go to every PicoVectorDB this phase builds)."""
    from picovdb_tpu_torch import K_ID, PicoVectorDB

    corpus = rng.standard_normal((n, dim), dtype=np.float32)
    ids = [f"v{i}" for i in range(n)]
    meta = [{"tag": i % 10} for i in range(n)]
    tmp = tempfile.mkdtemp(prefix="picovdb_smoke_", dir=os.getcwd())
    base = os.path.join(tmp, "store")
    scan.reset_launch_counts()  # count the main path's launches only

    db = PicoVectorDB(embedding_dim=dim, index="exact", storage_file=base,
                      device=device, **db_kwargs)
    t0 = time.perf_counter()
    db.upsert_columnar(corpus, ids=ids, metadata=meta, copy=False)
    db.rebuild_index()  # device upload + mirrors, part of the insert
    torch.cuda.synchronize()
    insert_s = time.perf_counter() - t0
    dbg = db.last_query_debug()
    assert dbg["mirrors"] == {"bf16": True, "int8": True}, dbg
    # `corpus` now holds the normalized rows (copy=False adopts it)

    # batch serving: CUDA-resident queries, chunks of 2048
    near = corpus[rng.integers(0, n, 8192)]
    qdev = torch.from_numpy(
        near + 0.01 * rng.standard_normal(near.shape, dtype=np.float32)
    ).to(device)
    out_ids, _ = db.query_columnar(qdev, top_k=10, batch_size=2048)
    assert db.last_query_debug()["strategy"] == "segmax_mixed_stream"
    assert (out_ids != None).all()  # noqa: E711
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    db.query_columnar(qdev, top_k=10, batch_size=2048)
    batch_s = time.perf_counter() - t0

    # single query: the int8 small-batch route
    one = qdev[0].cpu().numpy()
    res = db.query(one, top_k=10)
    assert db.last_query_debug()["strategy"] == "i8_fused_smallq"
    assert len(res) == 10
    q1_ms = cuda_ms(torch, lambda: db.query(one, top_k=10), reps=50)

    # filtered batch and wide-k batch: K4 over the bf16 mirror
    q64 = qdev[:64].cpu().numpy()
    res = db.query(q64, top_k=10, where={"tag": 3})
    assert db.last_query_debug()["strategy"] == "mixed_fused_batch_filtered"
    assert all(r["tag"] == 3 for hits in res for r in hits)
    assert all(len(hits) == 10 for hits in res)
    res = db.query(q64, top_k=32)
    assert db.last_query_debug()["strategy"] == "mixed_fused_batch"
    assert all(len(hits) == 32 for hits in res)

    # recall@10 against a float64 oracle on 64 queries
    corpus_dev = torch.from_numpy(corpus).to(device)
    live = torch.ones(n, dtype=torch.bool, device=device)
    truth = oracle_top10(torch, corpus_dev, qdev[:64], live)
    got, _ = db.query_columnar(qdev[:64], top_k=10)
    recall = np.mean([
        len({int(x[1:]) for x in got[i]} & set(truth[i].tolist())) / 10
        for i in range(64)
    ])
    assert recall >= 0.99, recall

    # delete 1000 ids, re-query: none of them comes back
    gone = [f"v{i}" for i in rng.choice(n, 1000, replace=False)]
    assert len(db.delete(gone)) == 1000
    gone_rows = np.asarray([int(g[1:]) for g in gone])
    back, _ = db.query_columnar(corpus[gone_rows[:256]], top_k=10)
    assert not (set(back[back != None].tolist()) & set(gone))  # noqa: E711
    counts = dict(scan.LAUNCHES)
    for name, (key, _, _) in KERNELS.items():
        assert counts[key] > 0, f"{name} never launched on the main path"
    log(f"phase 3: main path at {n} x {dim}: routes segmax_mixed_stream, "
        f"i8_fused_smallq, mixed_fused_batch_filtered, mixed_fused_batch; "
        f"recall@10 {recall:.4f} vs float64; delete ok; launches {counts}")

    # save, reload into a fresh instance, same answers
    probe = qdev[64:72].cpu().numpy()
    before = [[h[K_ID] for h in hits] for hits in db.query(probe, top_k=10)]
    db.save()
    del db
    db2 = PicoVectorDB(embedding_dim=dim, index="exact", storage_file=base,
                       device=device, **db_kwargs)
    assert db2.count() == n - 1000
    after = [[h[K_ID] for h in hits] for hits in db2.query(probe, top_k=10)]
    assert after == before, "reloaded store answers differently"
    log("phase 3: save + reload ok (same ids)")
    log(f"phase 3: insert {n / insert_s:.1f} vec/s; batch "
        f"{8192 / batch_s:.1f} QPS (query_columnar, 8192 queries); Q=1 "
        f"latency {q1_ms:.4f} ms (CUDA events around PicoVectorDB.query); "
        f"card {card}")
    shutil.rmtree(tmp)
    return counts


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card only",
              file=sys.stderr)
        return 2
    from picovdb_tpu_torch.ops import _build, scan

    device = torch.device("cuda:0")
    card = card_line()
    log(f"phase 1: card {card}")
    t0 = time.perf_counter()
    _build.library()
    log(f"phase 1: kernels built and loaded in {time.perf_counter() - t0:.2f} s"
        f" (nvcc {_build.build_seconds if _build.build_seconds else 0.0:.2f} s)")

    rng = np.random.default_rng(SEED)
    rec = phase_kernels(torch, scan, device, PHASE2_CAP, DIM, rng)
    counts = phase_main(torch, scan, device, MAIN_N, DIM, rng, card)

    kernels = [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": counts[key], "max_abs_err": rec[name][0],
         "ms": rec[name][1], "plain_ms": rec[name][2]}
        for name, (key, src, rep) in KERNELS.items()
    ]
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
