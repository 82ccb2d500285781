#!/usr/bin/env python3
"""Smoke run of picovdb_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Builds the hand-written kernels from `picovdb_tpu_torch/csrc`, checks each
one against its plain PyTorch version on the card, then drives the serving
paths through the public `PicoVectorDB` API and checks what comes back:
a 1M x 1024 float32 store (phase 3), a 1M x 1024 int8 store with the
host-f64 rescore and a quantized checkpoint (phase 4), a device-born
16M x 1024 int4 store (phase 5, an 8 GB packed plane), a 262,144 x 1024
bfloat16 store (phase 6), the IVF tier's classic layout over a clustered
2M x 1024 float32 store under index="auto" (phase 7), its int8-only
layout over a device-born, clustered 8M x 1024 int4 store and a sidecar
round trip (phase 8). Launch counts are zeroed just before each path
and read just after it. Every phase prints its lines; any failure raises
and the script exits non-zero without a result line. It imports neither
JAX nor picovdb_tpu, and refuses to run without a card.

Output, in order: the phase lines, the card's name and power limit as
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
MAIN_N = 1_000_000  # float32 store, phase 3
I8_N = 1_000_000  # int8 store, phase 4
I4_N = 1 << 24  # int4 store, phase 5: 16,777,216 rows, 8 GB packed
I4_CHUNK = 262_144  # rows generated and quantized on the card at a time
BF16_N = 262_144  # bfloat16 store, phase 6
IVF_N = 2_000_000  # float32 store, index="auto", phase 7 (8 GB of corpus)
IVF_I4_N = 8_000_000  # int4 store, index="ivf", device-born, phase 8
SIDECAR_N = 262_144  # float32 store, index="ivf", sidecar round trip
MIX_CENTRES = 4096  # gaussian-mixture centres of the IVF phases' data
MIX_SIGMA = 0.03  # per-coordinate noise: |noise| ~ 0.96 beside unit centres
TOL_SCORE = 1e-5  # float32 scores and K8's float keys: summation order only
TOL_GAP = 1e-4  # id sets must agree where the k-th/(k+1)-th gap exceeds it

KERNELS = {
    # name: (launch-counter key, source, TPU kernel it replaces, the phase
    # whose serving path must launch it)
    "segmax_scan": ("segmax", "picovdb_tpu_torch/csrc/segmax.cu",
                    "picovdb_tpu/ops/pallas_scan.py:443", 3),
    "topk_packed_keys": ("topk_keys", "picovdb_tpu_torch/csrc/topk_keys.cu",
                         "picovdb_tpu/ops/pallas_scan.py:536", 3),
    "fused_topk_i8": ("scan_topk_i8", "picovdb_tpu_torch/csrc/scan_topk.cu",
                      "picovdb_tpu/ops/pallas_scan.py:865", 3),
    "fused_topk": ("scan_topk", "picovdb_tpu_torch/csrc/scan_topk.cu",
                   "picovdb_tpu/ops/pallas_scan.py:226", 3),
    "segmax_scan_i8": ("segmax_i8", "picovdb_tpu_torch/csrc/segmax.cu",
                       "picovdb_tpu/ops/pallas_scan.py:960", 4),
    "fused_topk_i4": ("scan_topk_i4", "picovdb_tpu_torch/csrc/scan_topk.cu",
                      "picovdb_tpu/ops/pallas_scan.py:1315", 5),
    "ivf_scan_topk": ("ivf_scan_topk", "picovdb_tpu_torch/csrc/scan_topk.cu",
                      "picovdb_tpu/ops/ivf.py:1237", 7),
    "ivf_segmax_scan": ("ivf_segmax", "picovdb_tpu_torch/csrc/segmax.cu",
                        "picovdb_tpu/ops/ivf.py:1492", 7),
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

    # K5 over the int8 rows at Q = 2048, k = 10 (segmax_i8stor: k_sel 16).
    # The int32 sums are exact and each key is one float32 conversion and
    # one multiply, so the keys must agree bit for bit.
    q8, _ = scan.quantize_rows_i8(q)
    keys = scan.segmax_scan_i8(q8, v8, vs, mask)
    keys_p = scan.segmax_scan_i8_plain(q8, v8, vs, mask)
    torch.cuda.synchronize()
    assert torch.equal(keys == scan.KEY_MIN, keys_p == scan.KEY_MIN)
    err5 = float((key_vals(keys) - key_vals(keys_p)).abs().max())
    assert err5 <= 1e-4, f"segmax_scan_i8 keys differ by {err5}"

    def decode_rescore_i8(tk, ti):
        gidx = (ti // 2) * scan.SEG + (tk & (scan.SEG - 1))
        empty = tk == scan.KEY_MIN
        vals = torch.where(empty, float("-inf"), 0.0)
        return scan.rescore_exact_i8r(q, v8, vs, vals,
                                      torch.where(empty, 0, gidx))

    ex_k, id_k = decode_rescore_i8(*scan.topk_packed_keys(keys, k + 6))
    ex_p, id_p = decode_rescore_i8(*scan.topk_packed_keys_plain(keys_p, k + 6))
    assert float((ex_k[:, :k] - ex_p[:, :k]).abs().max()) <= TOL_SCORE
    assert ids_agree(torch, id_k, id_p, ex_p, k) == 0.0
    rec["segmax_scan_i8"] = (
        err5, cuda_ms(torch, lambda: scan.segmax_scan_i8(q8, v8, vs, mask)),
        cuda_ms(torch, lambda: scan.segmax_scan_i8_plain(q8, v8, vs, mask)))
    del keys, keys_p
    log(f"phase 2: K5 segmax_scan_i8 agrees at Q=2048 k={k} cap={cap} "
        f"(max |dkey value| {err5:.3g}; {rec['segmax_scan_i8'][1]:.4f} ms, "
        f"plain {rec['segmax_scan_i8'][2]:.4f} ms)")

    def check_scan(name, qq, vv, scale, msk, ksel, rescore_q, int4=False):
        if int4:
            got = scan.fused_topk_i4(qq, vv, scale, msk, ksel)
        elif scale is None:
            got = scan.fused_topk(qq, vv, msk, ksel)
        else:
            got = scan.fused_topk_i8(qq, vv, scale, msk, ksel)
        ref = scan.scan_topk_plain(qq, vv, scale, msk, ksel + 1, int4=int4)
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

    # K6 over the packed int4 rows at Q = 1, 8, 16, k_sel = 14 (i4stor_fused
    # at k = 10) and Q = 16, k_sel = 1024 (the widest the kernel serves)
    v4, vs4 = scan.quantize_rows_i4(corpus)
    errs, ms, pms = [], [], []
    for nq in (1, 8, 16):
        qf = normalize_on_device(
            torch.from_numpy(rng.standard_normal((nq, dim), dtype=np.float32))
            .to(device))
        q8, _ = scan.quantize_rows_i8(qf)
        errs.append(check_scan("fused_topk_i4", q8, v4, vs4, mask, 14, qf,
                               int4=True))
        ms.append(cuda_ms(torch, lambda: scan.fused_topk_i4(q8, v4, vs4, mask, 14)))
        pms.append(cuda_ms(torch, lambda: scan.scan_topk_plain(
            q8, v4, vs4, mask, 14, int4=True)))
    q8, _ = scan.quantize_rows_i8(q64[:16])
    errs.append(check_scan("fused_topk_i4 wide", q8, v4, vs4, mask, 1024,
                           q64[:16], int4=True))
    ms_w = cuda_ms(torch, lambda: scan.fused_topk_i4(q8, v4, vs4, mask, 1024))
    pms_w = cuda_ms(torch, lambda: scan.scan_topk_plain(
        q8, v4, vs4, mask, 1024, int4=True))
    rec["fused_topk_i4"] = (max(errs), ms[0], pms[0])
    log(f"phase 2: K6 fused_topk_i4 agrees at Q=1,8,16 k_sel=14 "
        f"(ms {', '.join(f'{m:.4f}' for m in ms)}; plain "
        f"{', '.join(f'{m:.4f}' for m in pms)}) and Q=16 k_sel=1024 "
        f"({ms_w:.4f} ms, plain {pms_w:.4f})")
    del corpus, lp, v8, vs, v4, vs4
    torch.cuda.empty_cache()
    return rec


def phase_ivf_kernels(torch, scan, device, cap: int, dim: int, rng, rec):
    """K7 and K8 against their plain versions over cap x dim IVF postings
    in each kind (float32, bf16, column-scaled int8), with a hot table of
    64 of the cap / 1024 tiles of which the first 40 are live, so dead
    steps occur. Adds the two kernels to `rec`."""
    from picovdb_tpu_torch.ops import ivf
    from picovdb_tpu_torch.ops.exact import normalize_on_device

    bn = ivf.IVF_BN
    n_tiles = cap // bn
    post = normalize_on_device(
        torch.from_numpy(rng.standard_normal((cap, dim), dtype=np.float32))
        .to(device))
    mask = torch.from_numpy(rng.random(cap) >= 0.1).to(device)
    hot = torch.from_numpy(np.sort(rng.choice(n_tiles, 64, replace=False))
                           .astype(np.int32)).to(device)
    n_hot = torch.tensor([40], dtype=torch.int32, device=device)
    live_rows = torch.zeros(cap, dtype=torch.bool, device=device)
    for t in hot[:40].tolist():
        live_rows[t * bn:(t + 1) * bn] = True
    v8, cs = scan.quantize_cols_i8(post)
    kinds = {"f32": post, "bf16": post.to(torch.bfloat16), "i8c": v8}

    def scan_inputs(kind, q):
        if kind == "i8c":
            return scan.fold_queries_i8(q, cs)
        return q.to(kinds[kind].dtype)

    # K7 at Q = 1 and 16 with k_sel 14 and 32 (the float and int8 guard
    # bands at k = 10), and Q = 16, k_sel 544 (the int4 host-rescore band)
    errs, lines, first = [], [], None
    for kind in kinds:
        for nq, k in ((1, 14), (16, 14), (1, 32), (16, 32), (16, 544)):
            qf = normalize_on_device(torch.from_numpy(
                rng.standard_normal((nq, dim), dtype=np.float32)).to(device))
            qs, vv = scan_inputs(kind, qf), kinds[kind]
            vals, idx = ivf.ivf_scan_topk(qs, vv, mask, hot, n_hot, k)
            rv, ri = ivf.ivf_scan_topk_plain(qs, vv, mask, hot, n_hot, k + 1)
            torch.cuda.synchronize()
            assert torch.equal(torch.isneginf(vals), torch.isneginf(rv[:, :k]))
            if kind == "i8c":  # integer scores, ties to the lower row
                assert torch.equal(vals, rv[:, :k]) and torch.equal(idx, ri[:, :k])
                err = 0.0
            else:
                fin = torch.isfinite(vals)
                err = float((vals[fin] - rv[:, :k][fin]).abs().max())
                assert err <= TOL_SCORE, f"K7 {kind} scores differ by {err}"
                assert ids_agree(torch, idx, ri, rv, k) == 0.0, f"K7 {kind}"
            got = idx[torch.isfinite(vals)].long()
            assert bool((mask & live_rows)[got].all()), f"K7 {kind} dead row"
            errs.append(err)
            ms = cuda_ms(torch, lambda: ivf.ivf_scan_topk(qs, vv, mask, hot,
                                                          n_hot, k))
            pms = cuda_ms(torch, lambda: ivf.ivf_scan_topk_plain(
                qs, vv, mask, hot, n_hot, k))
            first = first or (ms, pms)
            lines.append(f"{kind} Q={nq} k_sel={k} {ms:.4f} ms (plain "
                         f"{pms:.4f})")
    rec["ivf_scan_topk"] = (max(errs), first[0], first[1])
    log(f"phase 2: K7 ivf_scan_topk agrees over {cap} x {dim} postings, 40 "
        f"of 64 hot tiles live: " + "; ".join(lines))

    # K8 at Q = 64 with per_seg 4 and 8
    q64 = normalize_on_device(torch.from_numpy(
        rng.standard_normal((64, dim), dtype=np.float32)).to(device))
    ns = bn // scan.SEG

    def dec(kk):
        return scan._from_sortable(kk & ~(scan.SEG - 1)).view(torch.float32)

    def key_err(keys, ref, live):
        return float((dec(keys)[live] - dec(ref)[live]).abs().max())

    # Float keys must agree within TOL_SCORE: the sums differ only in their
    # order, which moves a key by at most one 128-ulp quantum (1.9e-6 below
    # a score of 0.25). A TF32 product (10-bit mantissa) would be off by
    # more; the plain version run in TF32 on the same inputs shows it does.
    errs, lines, first = [], [], None
    for kind in kinds:
        for per_seg in (4, 8):
            qs, vv = scan_inputs(kind, q64), kinds[kind]
            keys = ivf.ivf_segmax_scan(qs, vv, mask, hot, n_hot, per_seg)
            ref = ivf.ivf_segmax_scan_plain(qs, vv, mask, hot, n_hot, per_seg)
            torch.cuda.synchronize()
            live = keys != scan.KEY_MIN
            assert torch.equal(live, ref != scan.KEY_MIN), f"K8 {kind}"
            assert not bool(live[:, 40 * per_seg * ns:].any()), "K8 dead step"
            if kind == "i8c":
                assert torch.equal(keys, ref), "K8 i8c keys differ"
                err = 0.0
            else:
                err = key_err(keys, ref, live)
                assert err <= TOL_SCORE, f"K8 {kind} keys differ by {err}"
            errs.append(err)
            ms = cuda_ms(torch, lambda: ivf.ivf_segmax_scan(qs, vv, mask, hot,
                                                            n_hot, per_seg))
            pms = cuda_ms(torch, lambda: ivf.ivf_segmax_scan_plain(
                qs, vv, mask, hot, n_hot, per_seg))
            first = first or (ms, pms)
            lines.append(f"{kind} per_seg={per_seg} {ms:.4f} ms (plain "
                         f"{pms:.4f})")
    rec["ivf_segmax_scan"] = (max(errs), first[0], first[1])
    # what the limit must reject: the f32 plain version in TF32, and over
    # bf16-rounded inputs, against the f32 plain version
    ref = ivf.ivf_segmax_scan_plain(q64, post, mask, hot, n_hot, 8)
    live = ref != scan.KEY_MIN
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        tf32 = ivf.ivf_segmax_scan_plain(q64, post, mask, hot, n_hot, 8)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    err_tf32 = key_err(tf32, ref, live)
    err_bf16 = key_err(ivf.ivf_segmax_scan_plain(
        q64.to(torch.bfloat16), kinds["bf16"], mask, hot, n_hot, 8), ref, live)
    assert err_tf32 > TOL_SCORE, f"a TF32 K8 would pass: {err_tf32}"
    log(f"phase 2: K8 ivf_segmax_scan agrees at Q=64 (max |dkey value| "
        f"{max(errs):.3g}, limit {TOL_SCORE:g}; plain f32 in TF32 "
        f"{err_tf32:.3g}, over bf16 inputs {err_bf16:.3g}): "
        + "; ".join(lines))
    del post, v8, kinds
    torch.cuda.empty_cache()


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

    # filtered batches: a wide filter (100k survivors) rides K1 + K2 over
    # its compacted view; a narrow one (3000 ids, the view refused) and a
    # wide-k batch take K4 over the bf16 mirror
    q64 = qdev[:64].cpu().numpy()
    res_f = db.query(q64, top_k=10, where={"tag": 3})
    assert db.last_query_debug()["strategy"] == "fview_segmax"
    assert all(r["tag"] == 3 for hits in res_f for r in hits)
    assert all(len(hits) == 10 for hits in res_f)
    allow = [f"v{i}" for i in rng.choice(n, 3000, replace=False)]
    res = db.query(q64, top_k=10, ids=allow)
    assert db.last_query_debug()["strategy"] == "mixed_fused_batch_filtered"
    assert all(r["_id_"] in set(allow) for hits in res for r in hits)
    res = db.query(q64, top_k=32)
    assert db.last_query_debug()["strategy"] == "mixed_fused_batch"
    assert all(len(hits) == 32 for hits in res)

    # recall@10 against a float64 oracle on 64 queries, and of the
    # filter-view route against the filtered oracle
    corpus_dev = torch.from_numpy(corpus).to(device)
    tag3 = torch.from_numpy(np.arange(n) % 10 == 3).to(device)
    truth_f = oracle_top10(torch, corpus_dev, qdev[:64], tag3)
    recall_f = np.mean([
        len({int(h["_id_"][1:]) for h in res_f[i]} & set(truth_f[i].tolist()))
        / 10 for i in range(64)
    ])
    assert recall_f >= 0.99, recall_f
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
    for name, (key, _, _, phase) in KERNELS.items():
        if phase == 3:
            assert counts[key] > 0, f"{name} never launched on the main path"
    log(f"phase 3: main path at {n} x {dim}: routes segmax_mixed_stream, "
        f"i8_fused_smallq, fview_segmax, mixed_fused_batch_filtered, "
        f"mixed_fused_batch; recall@10 {recall:.4f} vs float64 (filter view "
        f"{recall_f:.4f} vs the filtered oracle); delete ok; launches "
        f"{counts}")

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


def recall_at_10(got_ids, truth, prefix: str) -> float:
    """Mean overlap of returned ids ("<prefix><row>") with oracle rows."""
    return float(np.mean([
        len({int(x[len(prefix):]) for x in got_ids[i] if x is not None}
            & set(truth[i].tolist())) / 10
        for i in range(truth.shape[0])
    ]))


def phase_int8(torch, scan, device, n: int, dim: int, rng, card: str,
               **db_kwargs):
    """int8 storage, host-born: the host-f64 rescore at small batches, K5
    + K2 for 2048-query chunks, K3 for Q = 1 at device precision, and a
    quantized checkpoint."""
    from picovdb_tpu_torch import PicoVectorDB
    from picovdb_tpu_torch.ops.exact import exact_topk_i8r, normalize_on_device

    corpus = rng.standard_normal((n, dim), dtype=np.float32)
    ids = [f"v{i}" for i in range(n)]
    meta = [{"tag": i % 10} for i in range(n)]
    tmp = tempfile.mkdtemp(prefix="picovdb_smoke_", dir=os.getcwd())
    base = os.path.join(tmp, "store_i8")
    scan.reset_launch_counts()  # count this path's launches only

    db = PicoVectorDB(embedding_dim=dim, index="exact", storage_file=base,
                      device=device, storage_dtype="int8", **db_kwargs)
    t0 = time.perf_counter()
    db.upsert_columnar(corpus, ids=ids, metadata=meta, copy=False)
    db.rebuild_index()  # quantized upload, part of the insert
    torch.cuda.synchronize()
    insert_s = time.perf_counter() - t0
    assert db.last_query_debug()["mirrors"] == {"bf16": False, "int8": False}
    near = corpus[rng.integers(0, n, 4096)]
    qdev = torch.from_numpy(
        near + 0.01 * rng.standard_normal(near.shape, dtype=np.float32)
    ).to(device)
    corpus_dev = torch.from_numpy(corpus).to(device)

    # Q = 1 and a filtered Q = 64 batch: k + 128 candidates from K3, then
    # the host-f64 rescore on the authentic float32 rows
    one = qdev[0].cpu().numpy()
    res = db.query(one, top_k=10)
    dbg = db.last_query_debug()
    assert dbg["strategy"] == "i8stor_fused_exact" and dbg["rescore"] == "host"
    assert len(res) == 10
    q1_ms = cuda_ms(torch, lambda: db.query(one, top_k=10), reps=20)
    q64 = qdev[:64].cpu().numpy()
    res = db.query(q64, top_k=10, where={"tag": 3})
    dbg = db.last_query_debug()
    assert dbg["strategy"] == "i8stor_fused_exact" and dbg["rescore"] == "host"
    assert all(len(h) == 10 and all(r["tag"] == 3 for r in h) for h in res)
    tag3 = torch.from_numpy(np.arange(n) % 10 == 3).to(device)
    truth_f = oracle_top10(torch, corpus_dev, qdev[:64], tag3)
    recall_f = recall_at_10([[r["_id_"] for r in h] for h in res], truth_f, "v")
    got, _ = db.query_columnar(q64, top_k=10)
    assert db.last_query_debug()["rescore"] == "host"
    live = torch.ones(n, dtype=torch.bool, device=device)
    truth = oracle_top10(torch, corpus_dev, qdev[:64], live)
    recall = recall_at_10(got, truth, "v")
    assert recall >= 0.99 and recall_f >= 0.99, (recall, recall_f)

    # 2048-query chunks of CUDA-resident queries: K5 + K2, then the
    # dequantizing rescore (storage precision: no host rescore for tensors)
    out_ids, _ = db.query_columnar(qdev, top_k=10, batch_size=2048)
    assert db.last_query_debug()["strategy"] == "segmax_i8stor_stream"
    assert (out_ids != None).all()  # noqa: E711
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    db.query_columnar(qdev, top_k=10, batch_size=2048)
    batch_s = time.perf_counter() - t0
    recall_dev = recall_at_10(out_ids[:64], truth, "v")
    # against the plain dense scan of the same int8 plane, wherever the
    # k-th/(k+1)-th gap passes the storage noise (3x the int8 tier's
    # score-noise rms: inside it the quantized selections may differ)
    dev = db._dev
    pv, pi = exact_topk_i8r(normalize_on_device(qdev[:256]), dev.vectors,
                            dev.vstore_scale, dev.active, 11)
    pv, pi = pv.cpu().numpy(), pi.cpu().numpy()
    noise = 3.0 * scan._tie_margin("i8", dim, 1.0)
    bad = 0
    for i in range(256):
        if pv[i, 9] - pv[i, 10] > noise:
            bad += {int(x[1:]) for x in out_ids[i]} != set(pi[i, :10].tolist())
    assert bad == 0, f"{bad} of 256 segmax_i8stor_stream id sets differ"
    del corpus_dev

    # a quantized checkpoint, reloaded lazily (device precision); Q = 1 at
    # rescore="device" takes the K3 small-batch route
    probe = qdev[64:320]
    before, _ = db.query_columnar(probe, top_k=10)
    db.save(quantized=True)
    del db
    db2 = PicoVectorDB(embedding_dim=dim, index="exact", storage_file=base,
                       device=device, storage_dtype="int8", rescore="device",
                       **db_kwargs)
    assert db2.count() == n
    after, _ = db2.query_columnar(probe, top_k=10)
    assert (after == before).all(), "reloaded int8 store answers differently"
    res = db2.query(one, top_k=10)
    assert db2.last_query_debug()["strategy"] == "i8stor_fused_smallq"
    assert len(res) == 10 and res[0]["_id_"] == out_ids[0][0]
    counts = dict(scan.LAUNCHES)
    assert counts["segmax_i8"] > 0, "segmax_scan_i8 never launched"
    log(f"phase 4: int8 storage at {n} x {dim}: routes i8stor_fused_exact "
        f"(host rescore), segmax_i8stor_stream, i8stor_fused_smallq; "
        f"recall@10 vs float64 {recall:.4f} (filtered {recall_f:.4f}) with "
        f"the host rescore, {recall_dev:.4f} at storage precision; "
        f"segmax_i8stor_stream ids = plain exact_topk_i8r outside the gap; "
        f"save(quantized=True) + reload ok; launches {counts}")
    log(f"phase 4: insert {n / insert_s:.1f} vec/s; batch "
        f"{4096 / batch_s:.1f} QPS (query_columnar, 4096 queries); Q=1 "
        f"latency {q1_ms:.4f} ms with the host rescore; card {card}")
    del db2
    shutil.rmtree(tmp)
    return counts


def phase_int4(torch, scan, device, n: int, dim: int, rng, card: str,
               **db_kwargs):
    """int4 storage, device-born: rows made on the card from a seeded
    generator, quantized and packed per chunk, adopted by ingest_device;
    every route is K6. The host keeps ids and metadata only."""
    from picovdb_tpu_torch import PicoVectorDB
    from picovdb_tpu_torch.ops.exact import normalize_on_device

    def rows_chunks():
        g = torch.Generator(device=device).manual_seed(SEED)
        for s in range(0, n, I4_CHUNK):
            yield s, normalize_on_device(torch.randn(
                min(I4_CHUNK, n - s), dim, generator=g, device=device))

    t0 = time.perf_counter()
    packed = torch.empty((n, dim // 2), dtype=torch.int8, device=device)
    scales = torch.empty((n,), dtype=torch.float32, device=device)
    for s, rows in rows_chunks():
        packed[s:s + rows.shape[0]], scales[s:s + rows.shape[0]] = \
            scan.quantize_rows_i4(rows)
    torch.cuda.synchronize()
    make_s = time.perf_counter() - t0
    ids = [f"w{i}" for i in range(n)]
    scan.reset_launch_counts()  # count this path's launches only
    db = PicoVectorDB(embedding_dim=dim, index="exact", device=device,
                      storage_file=os.path.join(os.getcwd(), "picovdb_smoke_i4"),
                      storage_dtype="int4", **db_kwargs)
    t0 = time.perf_counter()
    db.ingest_device(packed, ids, scales=scales, normalize=False)
    torch.cuda.synchronize()
    ingest_s = time.perf_counter() - t0
    del packed, scales, ids
    torch.cuda.empty_cache()
    dev = db._dev
    assert dev.vectors.shape[1] == dim // 2 and db.count() == n

    def dequant(slots):
        t = torch.from_numpy(slots).to(device)
        return scan.unpack_i4(dev.vectors[t]).float() * dev.vstore_scale[t, None]

    src = rng.integers(0, n, 2048)
    qdev = dequant(src)
    qdev = qdev + 0.01 * torch.randn(qdev.shape, device=device,
                                     generator=torch.Generator(
                                         device=device).manual_seed(SEED + 1))
    one = qdev[0].cpu().numpy()
    res = db.query(one, top_k=10)
    assert db.last_query_debug()["strategy"] == "i4stor_fused"
    assert res[0]["_id_"] == f"w{src[0]}", res[0]
    q1_ms = cuda_ms(torch, lambda: db.query(one, top_k=10), reps=10)
    out_ids, out_sc = db.query_columnar(qdev, top_k=10, batch_size=2048)
    assert db.last_query_debug()["strategy"] == "i4stor_fused"
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    db.query_columnar(qdev, top_k=10, batch_size=2048)
    torch.cuda.synchronize()
    batch_s = time.perf_counter() - t0

    # float64 oracles over the first 64 queries: the dequantized rows (the
    # ids must agree outside the gap) and the original float rows (recall)
    m = 64
    q = qdev[:m].double()
    q = q / q.norm(dim=1, keepdim=True)
    best = {"deq": (torch.full((m, 11), float("-inf"), dtype=torch.float64,
                               device=device),
                    torch.zeros((m, 11), dtype=torch.int64, device=device)),
            "orig": (torch.full((m, 11), float("-inf"), dtype=torch.float64,
                                device=device),
                     torch.zeros((m, 11), dtype=torch.int64, device=device))}
    for s, rows in rows_chunks():
        e = s + rows.shape[0]
        deq = (scan.unpack_i4(dev.vectors[s:e]).double()
               * dev.vstore_scale[s:e, None].double())
        for name, r in (("deq", deq), ("orig", rows.double())):
            sc = q @ r.T
            v, i = best[name]
            v, pos = torch.topk(torch.cat([v, sc], 1), 11, dim=1)
            cat_i = torch.cat([i, torch.arange(s, e, device=device)
                               .expand(m, -1)], 1)
            best[name] = (v, torch.gather(cat_i, 1, pos))
    dv, di = (t.cpu().numpy() for t in best["deq"])
    bad = sum(
        {int(x[1:]) for x in out_ids[i]} != set(di[i, :10].tolist())
        for i in range(m) if dv[i, 9] - dv[i, 10] > TOL_GAP)
    assert bad == 0, f"{bad} of {m} int4 id sets differ from the oracle"
    recall = recall_at_10(out_ids[:m], best["orig"][1][:, :10].cpu().numpy(),
                          "w")

    # delete 1000 ids: none of them comes back
    gone = rng.choice(n, 1000, replace=False)
    assert len(db.delete([f"w{i}" for i in gone])) == 1000
    back, _ = db.query_columnar(dequant(gone[:256]), top_k=10)
    assert not (set(back[back != None].tolist())  # noqa: E711
                & {f"w{i}" for i in gone})
    counts = dict(scan.LAUNCHES)
    assert counts["scan_topk_i4"] > 0, "fused_topk_i4 never launched"
    gb = dev.vectors.numel() / 2**30
    log(f"phase 5: int4 storage, device-born, {n} x {dim} ({gb:.2f} GiB "
        f"packed plane): route i4stor_fused at Q=1 and 2048; ids = float64 "
        f"oracle over the dequantized rows outside the gap; recall@10 "
        f"{recall:.4f} vs the original float rows; delete ok; launches "
        f"{counts}")
    log(f"phase 5: rows made + packed on the card in {make_s:.2f} s, "
        f"ingest_device {ingest_s:.2f} s; Q=1 latency {q1_ms:.4f} ms; batch "
        f"{2048 / batch_s:.1f} QPS (query_columnar, 2048 queries); peak "
        f"device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB;"
        f" card {card}")
    del db
    return counts


def mixture_chunks(torch, device, n: int, dim: int, seed: int,
                   chunk: int = 262_144):
    """A seeded gaussian mixture made on the card, chunk by chunk: rows =
    one of MIX_CENTRES unit centres + MIX_SIGMA * noise, normalized
    (picovdb_tpu's IVF calibration shape). Yields (start, rows f32)."""
    from picovdb_tpu_torch.ops.exact import normalize_on_device

    g = torch.Generator(device=device).manual_seed(seed)
    centres = normalize_on_device(
        torch.randn(MIX_CENTRES, dim, generator=g, device=device))
    for s in range(0, n, chunk):
        m = min(chunk, n - s)
        lab = torch.randint(0, MIX_CENTRES, (m,), generator=g, device=device)
        yield s, normalize_on_device(
            centres[lab] + MIX_SIGMA * torch.randn(m, dim, generator=g,
                                                   device=device))


def probed_slots(torch, db, qn, n_slots: int):
    """(n_slots,) bool: the corpus slots the IVF kernels scan for the
    batch `qn` (normalized, on the card): the probe preamble's row mask
    cut to the hot tiles it keeps."""
    from picovdb_tpu_torch.ops import ivf as tivf

    x = db._ivf
    npb = tivf.ef_to_nprobe(db._ef_search, x.nlist)
    row_mask, hot, n_hot, _ = tivf._probe_preamble(
        qn, x.centroids, x.active, x.seg_starts, x.cluster2tile, nprobe=npb,
        nlist=x.nlist, g_tiles=x.g_tiles(qn.shape[0], npb),
        cap_ivf=x.active.shape[0], n_tiles=x.n_tiles, bn=tivf.IVF_BN)
    tiles = torch.zeros(x.n_tiles, dtype=torch.bool, device=qn.device)
    tiles[hot[: int(n_hot)].long()] = True
    scanned = row_mask & tiles.repeat_interleave(tivf.IVF_BN)
    m = torch.zeros(n_slots, dtype=torch.bool, device=qn.device)
    m[x.slots[scanned]] = True
    return m


def oracle_masked(torch, chunks, queries, masks, k: int = 11):
    """Float64 top-k (scores, rows) per query over row chunks [(start,
    rows)], query i restricted to masks[i] (masks None: every row)."""
    q = queries.double()
    q = q / q.norm(dim=1, keepdim=True)
    best_v = torch.full((q.shape[0], k), float("-inf"), dtype=torch.float64,
                        device=q.device)
    best_i = torch.zeros((q.shape[0], k), dtype=torch.int64, device=q.device)
    for s, rows in chunks:
        sc = q @ rows.double().T
        if masks is not None:
            sc = sc.masked_fill(~masks[:, s:s + rows.shape[0]], float("-inf"))
        v = torch.cat([best_v, sc], 1)
        i = torch.cat([best_i, torch.arange(s, s + sc.shape[1], device=q.device)
                       .expand(q.shape[0], -1)], 1)
        best_v, pos = torch.topk(v, k, dim=1)
        best_i = torch.gather(i, 1, pos)
    return best_v.cpu().numpy(), best_i.cpu().numpy()


def ids_off_oracle(got_ids, prefix: str, ov, oi, k: int = 10) -> int:
    """Queries whose returned id set differs from the oracle's although
    the oracle's k-th/(k+1)-th gap exceeds TOL_GAP."""
    bad = 0
    for i in range(ov.shape[0]):
        if ov[i, k - 1] - ov[i, k] > TOL_GAP:
            got = {int(x[len(prefix):]) for x in got_ids[i] if x is not None}
            bad += got != set(oi[i, :k].tolist())
    return bad


def serve_singles(db, qs, strategy: str, k: int = 10):
    """Each query alone through PicoVectorDB.query; (Q, k) ids."""
    out = np.full((qs.shape[0], k), None, dtype=object)
    for i in range(qs.shape[0]):
        hits = db.query(qs[i], top_k=k)
        assert db.last_query_debug()["strategy"] == strategy
        out[i, :len(hits)] = [h["_id_"] for h in hits]
    return out


def phase_ivf_f32(torch, scan, device, n: int, dim: int, rng, card: str):
    """The IVF tier's classic layout: a clustered n x dim float32 store
    under index="auto" builds the tier at the sync after its bulk load;
    Q = 1 serves through K7 (route ivf), 32-query chunks through K8,
    256-query batches stay exact; then 1000 upserts take the incremental
    path and are found."""
    from picovdb_tpu_torch import PicoVectorDB
    from picovdb_tpu_torch.ops.exact import normalize_on_device

    corpus = np.empty((n, dim), dtype=np.float32)
    for s, rows in mixture_chunks(torch, device, n, dim, SEED + 7):
        corpus[s:s + rows.shape[0]] = rows.cpu().numpy()
    tmp = tempfile.mkdtemp(prefix="picovdb_smoke_", dir=os.getcwd())
    scan.reset_launch_counts()  # count this path's launches only
    db = PicoVectorDB(embedding_dim=dim, index="auto", device=device,
                      storage_file=os.path.join(tmp, "ivf"))
    db.upsert_columnar(corpus, ids=[f"p{i}" for i in range(n)], copy=False)
    qs = (corpus[rng.integers(0, n, 1024)] + 0.01 * rng.standard_normal(
        (1024, dim), dtype=np.float32))
    t0 = time.perf_counter()
    db.query(qs[0], top_k=10)  # the first sync: upload + IVF build
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    dbg = db.last_query_debug()
    op, bp = dbg["ann_operating_point"], dbg["ann_build_params"]
    assert dbg["ann_active"] and dbg["strategy"] == "ivf", dbg
    assert op["layout"] == "classic" and op["postings"] == "float32", op
    got1 = serve_singles(db, qs[:64], "ivf")  # K7
    q1_ms = cuda_ms(torch, lambda: db.query(qs[0], top_k=10), reps=50)
    gotb, _ = db.query_columnar(qs[:128], top_k=10, batch_size=32)  # K8
    assert db.last_query_debug()["strategy"] == "ivf"
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    db.query_columnar(qs, top_k=10, batch_size=32)
    batch_s = time.perf_counter() - t0
    db.query_columnar(qs[:256], top_k=10, batch_size=256)
    exact_route = db.last_query_debug()["strategy"]
    assert not exact_route.startswith("ivf"), exact_route  # union > 0.22
    counts = dict(scan.LAUNCHES)
    for name, (key, _, _, phase) in KERNELS.items():
        if phase == 7:
            assert counts[key] > 0, f"{name} never launched on the IVF path"

    # float64 oracles: restricted to the rows each dispatch scanned (the
    # ids must agree outside the gap), and over every row (recall)
    corpus_dev = torch.from_numpy(corpus).to(device)
    chunks = [(s, corpus_dev[s:s + 131_072]) for s in range(0, n, 131_072)]
    qn = normalize_on_device(torch.from_numpy(qs[:128]).to(device))
    m1 = torch.stack([probed_slots(torch, db, qn[i:i + 1], n)
                      for i in range(64)])
    bad1 = ids_off_oracle(got1, "p", *oracle_masked(torch, chunks, qn[:64], m1))
    assert bad1 == 0, f"{bad1} of 64 K7-route id sets differ (restricted)"
    mb = torch.cat([probed_slots(torch, db, qn[c:c + 32], n)[None]
                    .expand(32, -1) for c in range(0, 128, 32)])
    badb = ids_off_oracle(gotb, "p", *oracle_masked(torch, chunks, qn, mb))
    assert badb <= 0.01 * 128, f"{badb} of 128 K8-route id sets differ"
    _, oi = oracle_masked(torch, chunks, qn[:64], None)
    recall = recall_at_10(got1, oi[:, :10], "p")
    assert recall >= 0.95, recall
    del corpus_dev, chunks, m1, mb

    # 1000 upserts: the incremental path, and the new rows are found
    new = np.concatenate([r.cpu().numpy() for _, r in mixture_chunks(
        torch, device, 1000, dim, SEED + 8)])
    db.upsert_columnar(new, ids=[f"n{i}" for i in range(1000)])
    back = db.query(new[:8], top_k=3)
    dbg2 = db.last_query_debug()
    assert dbg2["ann_rebuild_mode"] == "incremental", dbg2
    assert dbg2["strategy"] == "ivf", dbg2
    assert [h[0]["_id_"] for h in back] == [f"n{i}" for i in range(8)]
    log(f"phase 7: IVF classic layout at {n} x {dim} float32, index=auto: "
        f"built at the first sync ({first_s:.2f} s incl. the device upload)"
        f", nlist {op['nlist']}, nprobe {op['nprobe_default']}, postings "
        f"{op['postings']}, build params {bp}; Q=1 route ivf (K7), 32-query "
        f"chunks ivf (K8), Q=256 {exact_route}; ids = restricted float64 "
        f"oracle outside the gap on 64/64 (K7) and {128 - badb}/128 (K8); "
        f"recall@10 {recall:.4f} at nprobe {op['nprobe_default']}; 1000 "
        f"upserts incremental and found; launches {counts}")
    log(f"phase 7: Q=1 latency {q1_ms:.4f} ms (CUDA events around "
        f"PicoVectorDB.query); batch {1024 / batch_s:.1f} QPS "
        f"(query_columnar, 1024 queries in 32-query chunks); card {card}")
    del db, corpus
    shutil.rmtree(tmp)
    return counts


def phase_ivf_int4(torch, scan, device, n: int, dim: int, rng, card: str):
    """The IVF tier's int8-only layout over a device-born, clustered
    n x dim int4 store (index="ivf"): the postings are column-scaled int8,
    the rescore reads the packed plane by slot; Q = 1 through K7 and
    32-query chunks through K8, both on int8 postings (route ivf_i8)."""
    from picovdb_tpu_torch import PicoVectorDB
    from picovdb_tpu_torch.ops.exact import normalize_on_device

    torch.cuda.reset_peak_memory_stats()
    packed = torch.empty((n, dim // 2), dtype=torch.int8, device=device)
    scales = torch.empty((n,), dtype=torch.float32, device=device)
    for s, rows in mixture_chunks(torch, device, n, dim, SEED + 9):
        packed[s:s + rows.shape[0]], scales[s:s + rows.shape[0]] = \
            scan.quantize_rows_i4(rows)
    scan.reset_launch_counts()
    db = PicoVectorDB(embedding_dim=dim, index="ivf", device=device,
                      storage_file=os.path.join(os.getcwd(), "picovdb_smoke_i4ivf"),
                      storage_dtype="int4")
    db.ingest_device(packed, [f"w{i}" for i in range(n)], scales=scales,
                     normalize=False)
    del packed, scales
    torch.cuda.empty_cache()
    dev = db._dev
    src = rng.integers(0, n, 1024)
    sl = torch.from_numpy(src).to(device)
    qdev = (scan.unpack_i4(dev.vectors[sl]).float() * dev.vstore_scale[sl, None])
    qdev = qdev + 0.01 * torch.randn(qdev.shape, device=device,
                                     generator=torch.Generator(
                                         device=device).manual_seed(SEED + 10))
    qs = qdev.cpu().numpy()
    t0 = time.perf_counter()
    db.query(qs[0], top_k=10)  # the first sync builds the postings
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    dbg = db.last_query_debug()
    op = dbg["ann_operating_point"]
    assert dbg["strategy"] == "ivf_i8" and op["layout"] == "int8_only", dbg
    got1 = serve_singles(db, qs[:64], "ivf_i8")  # K7, int8 postings
    q1_ms = cuda_ms(torch, lambda: db.query(qs[0], top_k=10), reps=20)
    gotb, _ = db.query_columnar(qs[:128], top_k=10, batch_size=32)  # K8
    assert db.last_query_debug()["strategy"] == "ivf_i8"
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    db.query_columnar(qs, top_k=10, batch_size=32)
    batch_s = time.perf_counter() - t0
    counts = dict(scan.LAUNCHES)
    assert counts["ivf_scan_topk"] > 0 and counts["ivf_segmax"] > 0, counts
    peak = torch.cuda.max_memory_allocated() / 2**30

    step = 131_072

    def dequant_chunks():
        for s in range(0, n, step):
            e = min(n, s + step)
            yield s, (scan.unpack_i4(dev.vectors[s:e]).double()
                      * dev.vstore_scale[s:e, None].double())

    qn = normalize_on_device(qdev[:128])
    m1 = torch.stack([probed_slots(torch, db, qn[i:i + 1], n)
                      for i in range(64)])
    bad1 = ids_off_oracle(got1, "w", *oracle_masked(torch, dequant_chunks(),
                                                    qn[:64], m1))
    assert bad1 <= 0.01 * 64, f"{bad1} of 64 K7-route id sets differ"
    del m1
    mb = torch.cat([probed_slots(torch, db, qn[c:c + 32], n)[None]
                    .expand(32, -1) for c in range(0, 128, 32)])
    badb = ids_off_oracle(gotb, "w", *oracle_masked(torch, dequant_chunks(),
                                                    qn, mb))
    assert badb <= 0.01 * 128, f"{badb} of 128 K8-route id sets differ"
    del mb
    _, oi = oracle_masked(torch, mixture_chunks(torch, device, n, dim, SEED + 9),
                          qn[:64], None)
    recall = recall_at_10(got1, oi[:, :10], "w")
    log(f"phase 8: IVF int8-only layout over a device-born {n} x {dim} int4 "
        f"store, index=ivf: built at the first sync ({first_s:.2f} s), nlist "
        f"{op['nlist']}, nprobe {op['nprobe_default']}, postings "
        f"{op['postings']}; routes ivf_i8 at Q=1 (K7) and in 32-query chunks "
        f"(K8); ids = restricted float64 oracle over the dequantized rows "
        f"outside the gap on {64 - bad1}/64 (K7) and {128 - badb}/128 (K8); "
        f"recall@10 {recall:.4f} vs the original float rows; launches {counts}")
    log(f"phase 8: Q=1 latency {q1_ms:.4f} ms; batch {1024 / batch_s:.1f} QPS "
        f"(query_columnar, 1024 queries in 32-query chunks); peak device "
        f"memory {peak:.2f} GiB; card {card}")
    del db, dev
    torch.cuda.empty_cache()
    return counts


def phase_sidecar(torch, device, n: int, dim: int):
    """An index="ivf" float32 store saved with its .ivf.npz sidecar and
    reopened: the tier comes back from the sidecar (same centroids, no
    k-means), answers the same, and `persistence.load_ann` reads it."""
    from picovdb_tpu_torch import PicoVectorDB, persistence

    corpus = np.concatenate([r.cpu().numpy() for _, r in mixture_chunks(
        torch, device, n, dim, SEED + 11)])
    tmp = tempfile.mkdtemp(prefix="picovdb_smoke_", dir=os.getcwd())
    base = os.path.join(tmp, "side")
    db = PicoVectorDB(embedding_dim=dim, index="ivf", device=device,
                      storage_file=base)
    db.upsert_columnar(corpus, ids=[f"s{i}" for i in range(n)], copy=False)
    probe = corpus[:16]
    before, _ = db.query_columnar(probe, top_k=10)
    assert db.last_query_debug()["strategy"] == "ivf"
    cent = db._ivf.centroids.cpu().numpy()
    db.save()
    blob = persistence.load_ann(base)
    assert blob is not None and np.array_equal(blob["centroids"],
                                               cent[: int(blob["nlist"])])
    del db
    t0 = time.perf_counter()
    db2 = PicoVectorDB(embedding_dim=dim, index="ivf", device=device,
                       storage_file=base)
    load_s = time.perf_counter() - t0
    dbg = db2.last_query_debug()
    assert dbg["ann_build_params"]["warm"] == "sidecar", dbg
    assert np.array_equal(db2._ivf.centroids.cpu().numpy(), cent)
    after, _ = db2.query_columnar(probe, top_k=10)
    assert (after == before).all(), "reopened IVF store answers differently"
    log(f"phase 8: sidecar round trip at {n} x {dim}: reopened from the "
        f".ivf.npz without k-means in {load_s:.2f} s (same centroids, same "
        f"ids); persistence.load_ann reads nlist {int(blob['nlist'])}")
    del db2
    shutil.rmtree(tmp)


def phase_bf16(torch, scan, device, n: int, dim: int, rng, **db_kwargs):
    """bfloat16 storage: batches take K4 over the bf16 rows
    (`pallas_fused`), Q = 1 the route picovdb_tpu picks (`xla_topk`)."""
    from picovdb_tpu_torch import PicoVectorDB

    corpus = rng.standard_normal((n, dim), dtype=np.float32)
    db = PicoVectorDB(embedding_dim=dim, index="exact", device=device,
                      storage_file=os.path.join(os.getcwd(), "picovdb_smoke_bf"),
                      storage_dtype="bfloat16", **db_kwargs)
    db.upsert_columnar(corpus, ids=[f"b{i}" for i in range(n)], copy=False)
    before = scan.LAUNCHES["scan_topk"]
    q = corpus[rng.integers(0, n, 64)] + 0.01 * rng.standard_normal(
        (64, dim), dtype=np.float32)
    got, _ = db.query_columnar(q, top_k=10)
    dbg = db.last_query_debug()
    assert dbg["strategy"] == "pallas_fused" and dbg["rescore"] == "host"
    assert scan.LAUNCHES["scan_topk"] > before
    truth = oracle_top10(torch, torch.from_numpy(corpus).to(device),
                         torch.from_numpy(q).to(device),
                         torch.ones(n, dtype=torch.bool, device=device))
    recall = recall_at_10(got, truth, "b")
    assert recall >= 0.99, recall
    db.query(q[0], top_k=10)
    assert db.last_query_debug()["strategy"] == "xla_topk"
    log(f"phase 6: bfloat16 storage at {n} x {dim}: Q=64 pallas_fused (K4 "
        f"over bf16 rows) + host rescore, recall@10 {recall:.4f}; Q=1 "
        f"xla_topk")
    del db


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
    phase_ivf_kernels(torch, scan, device, PHASE2_CAP, DIM, rng, rec)
    counts = {3: phase_main(torch, scan, device, MAIN_N, DIM, rng, card)}
    torch.cuda.empty_cache()
    counts[4] = phase_int8(torch, scan, device, I8_N, DIM, rng, card)
    torch.cuda.empty_cache()
    counts[5] = phase_int4(torch, scan, device, I4_N, DIM, rng, card)
    torch.cuda.empty_cache()
    phase_bf16(torch, scan, device, BF16_N, DIM, rng)
    torch.cuda.empty_cache()
    counts[7] = phase_ivf_f32(torch, scan, device, IVF_N, DIM, rng, card)
    torch.cuda.empty_cache()
    counts[8] = phase_ivf_int4(torch, scan, device, IVF_I4_N, DIM, rng, card)
    torch.cuda.empty_cache()
    phase_sidecar(torch, device, SIDECAR_N, DIM)

    kernels = [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": counts[phase][key], "max_abs_err": rec[name][0],
         "ms": rec[name][1], "plain_ms": rec[name][2]}
        for name, (key, src, rep, phase) in KERNELS.items()
    ]
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
