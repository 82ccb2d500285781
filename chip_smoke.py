#!/usr/bin/env python3
"""Smoke run of picovdb_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Builds the hand-written kernels from `picovdb_tpu_torch/csrc`, checks each
one against its plain PyTorch version on the card, then drives the serving
paths through the public `PicoVectorDB` API and checks what comes back:
a 1M x 1024 float32 store (phase 3), a 131,072 x 1020 float32 store whose
rows TMA cannot read, served by K1's wmma tile (phase 3b), a 1M x 1024
int8 store with the
host-f64 rescore and a quantized checkpoint (phase 4), a device-born
16M x 1024 int4 store (phase 5, an 8 GB packed plane), a 262,144 x 1024
bfloat16 store (phase 6), the IVF tier's classic layout over a clustered
2M x 1024 float32 store under index="auto" (phase 7), its int8-only
layout over a device-born, clustered 8M x 1024 int4 store and a sidecar
round trip (phase 8), the opt-in selection tiers A/B over one 1M x 1024
float32 corpus (phase 9: defaults, PICOVDB_SEGMAX_I8, the column-scaled
int8 routes, scan_mode="approx"), and the two bench probes (phase 10).
Launch counts are zeroed just before each path and read just after it.
Every phase prints its lines; any failure raises and the script exits
non-zero without a result line. It imports neither JAX nor picovdb_tpu,
and refuses to run without a card.

Output, in order: the phase lines (phase 10 adds one JSON line per
probe), the card's name and power limit as `nvidia-smi` reports them,
one JSON object with the per-kernel record (time, plain time, bound,
library call, launches), and last `{"ok": true, "device": {...}}`.
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
WMMA_N = 131_072  # float32 store at dim 1020, phase 3b (K1's wmma tile)
I8_N = 1_000_000  # int8 store, phase 4
I4_N = 1 << 24  # int4 store, phase 5: 16,777,216 rows, 8 GB packed
I4_CHUNK = 262_144  # rows generated and quantized on the card at a time
BF16_N = 262_144  # bfloat16 store, phase 6
IVF_N = 2_000_000  # float32 store, index="auto", phase 7 (8 GB of corpus)
IVF_I4_N = 8_000_000  # int4 store, index="ivf", device-born, phase 8
SIDECAR_N = 262_144  # float32 store, index="ivf", sidecar round trip
TIERS_N = 1_000_000  # float32 store, the opt-in tiers' A/B, phase 9
MIX_CENTRES = 4096  # gaussian-mixture centres of the IVF phases' data
MIX_SIGMA = 0.03  # per-coordinate noise: |noise| ~ 0.96 beside unit centres
TOL_SCORE = 1e-5  # float32 scores and K8's float keys: summation order only
TOL_GAP = 1e-4  # id sets must agree where the k-th/(k+1)-th gap exceeds it
# The least time the card could take (bound_ms): bytes over the HBM rate,
# operations over the peak for their type (NVIDIA H100 SXM data sheet,
# dense rates at the 700 W limit).
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bf16": 989e12, "int8": 1979e12, "f32": 67e12}

KERNELS = {
    # name: (launch-counter key, source, TPU kernel it replaces, the phase
    # whose serving path must launch it). K1 is two kernels: the TMA +
    # wgmma mainloop (csrc/wgmma_tiles.cuh) wherever dim % 8 == 0, and the
    # wmma tile it keeps for other widths, which phase 3b's dim-1020 store
    # drives ("segmax_wmma": K1 launches less the wgmma ones). P1 has a row
    # per kind, both on the mainloop; K9's row is its one-query sweep
    # (csrc/sweep_topk.cu), which serves every Q <= 16 call of phase 9.
    "segmax_scan": ("segmax_wgmma", "picovdb_tpu_torch/csrc/segmax.cu",
                    "picovdb_tpu/ops/pallas_scan.py:443", 3),
    "segmax_scan_wmma": ("segmax_wmma", "picovdb_tpu_torch/csrc/segmax.cu",
                         "picovdb_tpu/ops/pallas_scan.py:443", "3b"),
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
    "fused_topk_i8c": ("scan_topk_i8c_sweep",
                       "picovdb_tpu_torch/csrc/sweep_topk.cu",
                       "picovdb_tpu/ops/pallas_scan.py:1705", 9),
    "segmax_scan_i8c": ("segmax_i8c", "picovdb_tpu_torch/csrc/segmax.cu",
                        "picovdb_tpu/ops/pallas_scan.py:1528", 9),
    "dot_rowmax": ("dot_rowmax_wgmma", "picovdb_tpu_torch/csrc/probe.cu",
                   "bench/segmax_sweep_probe.py:73", 10),
    "dot_rowmax_i8": ("dot_rowmax_i8_wgmma", "picovdb_tpu_torch/csrc/probe.cu",
                      "bench/segmax_sweep_probe.py:73", 10),
}


def entry(err, ms, plain_ms, nbytes, ops, kind, library_ms=None) -> dict:
    """One kernel's record at the shape it was timed: agreement with its
    plain version, times, and what its least time is computed from (bytes
    each input read once and each output written once; operations of
    type `kind`), counting only the rows this run's mask leaves live."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[kind] * 1e3
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": library_ms}


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
    from picovdb_tpu_torch.probes import cuda_ms as timed

    return timed(fn, reps)


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


def exact_err(torch, got, ref) -> float:
    """Max |got - ref| over two key slabs or score arrays whose -inf
    entries coincide, in float64 (exact for int32 keys and sums); 0.0 for
    equal tensors."""
    g, r = got.double(), ref.double()
    fin = torch.isfinite(r)
    assert torch.equal(fin, torch.isfinite(g)), "-inf entries differ"
    return float((g[fin] - r[fin]).abs().max()) if bool(fin.any()) else 0.0


def key_values(torch, scan, kk):
    """Decoded float32 values of packed keys, 0 where a key is KEY_MIN."""
    f = scan._from_sortable(kk & ~(scan.SEG - 1)).view(torch.float32)
    return torch.where(kk == scan.KEY_MIN, 0.0, f)


def check_segmax_keys(torch, scan, keys, keys_p, qf, rows, k: int, what):
    """K1's keys against the plain slab: KEY_MIN pattern equal, decoded
    values within 1e-4, K2 (k_sel = k + 6) equal to its plain version, and
    the rows K2 picks (decoded (c // 2) * 128 + (key & 127)) rescoring
    equal to the plain slab's outside the TOL_GAP gap. Returns K1's and
    K2's max |dkey value|."""
    assert torch.equal(keys == scan.KEY_MIN, keys_p == scan.KEY_MIN), what
    err = float((key_values(torch, scan, keys)
                 - key_values(torch, scan, keys_p)).abs().max())
    assert err <= 1e-4, f"{what} keys differ by {err}"
    tk, ti = scan.topk_packed_keys(keys, k + 6)
    tk_p, _ = scan.topk_packed_keys_plain(keys, k + 6)
    assert torch.equal(tk, tk_p), "topk_packed_keys keys differ"
    assert torch.equal(torch.gather(keys, 1, ti.long()), tk), "bad columns"

    def decode_rescore(tk, ti):
        gidx = (ti // 2) * scan.SEG + (tk & (scan.SEG - 1))
        empty = tk == scan.KEY_MIN
        vals = torch.where(empty, float("-inf"), 0.0)
        return scan.rescore_exact(qf, rows, vals, torch.where(empty, 0, gidx))

    ex_k, id_k = decode_rescore(tk, ti)
    ex_p, id_p = decode_rescore(*scan.topk_packed_keys_plain(keys_p, k + 6))
    assert float((ex_k[:, :k] - ex_p[:, :k]).abs().max()) <= TOL_SCORE, what
    assert ids_agree(torch, id_k, id_p, ex_p, k) == 0.0, what
    return err, float((key_values(torch, scan, tk)
                       - key_values(torch, scan, tk_p)).abs().max())


def k9_template_ms(torch, scan, q8, v8, mask, k: int) -> float:
    """K9's template (`pv_scan_topk` kind 4), which its one-query sweep
    replaced on these shapes, run on the same inputs: held to the plain
    version bit for bit (it still serves Q > 16, k > 128 and other
    widths) and timed, the yardstick of the sweep's times. Its launches
    are not counted."""
    num_q, dim = q8.shape
    cap = v8.shape[0]
    chunk = scan._scan_chunk(cap, 1, num_q, k, q8.device)  # one 16-query tile
    n = -(-cap // chunk)
    partial = torch.empty((num_q * n * k,), dtype=torch.int64, device=q8.device)
    vals = torch.empty((num_q, k), dtype=torch.float32, device=q8.device)
    idx = torch.empty((num_q, k), dtype=torch.int32, device=q8.device)

    def run():
        scan._launch(q8, "fused_topk_i8c", "pv_scan_topk", scan._KIND_I8C,
                     q8.data_ptr(), v8.data_ptr(), None, mask.data_ptr(),
                     partial.data_ptr(), vals.data_ptr(), idx.data_ptr(),
                     num_q, cap, dim, k, chunk)

    run()
    ref = scan.fused_topk_i8c_plain(q8, v8, mask, k)
    torch.cuda.synchronize()
    assert torch.equal(vals, ref[0]) and torch.equal(idx, ref[1]), "template"
    return cuda_ms(torch, run)


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
    live = int(mask.sum())  # rows a kernel must read and score

    # K1 + K2 at Q = 2048, k = 10 (segmax route: k_sel = k + 6)
    k = 10
    q = normalize_on_device(
        torch.from_numpy(rng.standard_normal((2048, dim), dtype=np.float32))
        .to(device))
    qb = q.to(torch.bfloat16)
    before = scan.LAUNCHES["segmax_wgmma"]
    keys = scan.segmax_scan(qb, lp, mask)
    assert scan.LAUNCHES["segmax_wgmma"] == before + 1, "K1 missed wgmma"
    keys_p = scan.segmax_scan_plain(qb, lp, mask)
    torch.cuda.synchronize()
    assert keys.shape == keys_p.shape, (keys.shape, keys_p.shape)

    def key_vals(kk):
        return key_values(torch, scan, kk)

    def check_k1(keys, keys_p, qf, rows, what):
        return check_segmax_keys(torch, scan, keys, keys_p, qf, rows, k, what)

    err1, err2 = check_k1(keys, keys_p, q, corpus, "K1 (wgmma)")
    nq = q.shape[0]
    slab = nq * 2 * (cap // scan.SEG) * 4
    rec["segmax_scan"] = entry(
        err1, cuda_ms(torch, lambda: scan.segmax_scan(qb, lp, mask)),
        cuda_ms(torch, lambda: scan.segmax_scan_plain(qb, lp, mask)),
        nq * dim * 2 + live * dim * 2 + cap + slab, 2 * nq * live * dim, "bf16")
    rec["topk_packed_keys"] = entry(
        err2, cuda_ms(torch, lambda: scan.topk_packed_keys(keys, k + 6)),
        cuda_ms(torch, lambda: scan.topk_packed_keys_plain(keys, k + 6)),
        slab + nq * (k + 6) * 8, 0, "int8",
        cuda_ms(torch, lambda: torch.topk(keys, k + 6, dim=1)))
    del keys, keys_p
    log(f"phase 2: K1 segmax_scan (TMA + wgmma) + K2 topk_packed_keys agree "
        f"at Q=2048 k={k} cap={cap} (K1 max |dkey value| {err1:.3g}, K2 "
        f"exact, rescored rows = plain outside the gap; K1 "
        f"{rec['segmax_scan']['ms']:.4f} ms, plain "
        f"{rec['segmax_scan']['plain_ms']:.4f} ms, bound "
        f"{rec['segmax_scan']['bound_ms']:.4f} ms)")

    # K1's retained wmma tile, at a width TMA cannot read (dim 1020, rows
    # of 2040 bytes): the same checks, and its own row in the record
    d2 = dim - 4
    q2, c2 = normalize_on_device(q[:, :d2]), normalize_on_device(corpus[:, :d2])
    q2b, lp2 = q2.to(torch.bfloat16), c2.to(torch.bfloat16)
    before = dict(scan.LAUNCHES)
    keys = scan.segmax_scan(q2b, lp2, mask)
    assert scan.LAUNCHES["segmax"] == before["segmax"] + 1
    assert scan.LAUNCHES["segmax_wgmma"] == before["segmax_wgmma"], "dim 1020"
    keys_p = scan.segmax_scan_plain(q2b, lp2, mask)
    torch.cuda.synchronize()
    err_w, _ = check_k1(keys, keys_p, q2, c2, "K1 (wmma, dim 1020)")
    rec["segmax_scan_wmma"] = entry(
        err_w, cuda_ms(torch, lambda: scan.segmax_scan(q2b, lp2, mask)),
        cuda_ms(torch, lambda: scan.segmax_scan_plain(q2b, lp2, mask)),
        nq * d2 * 2 + live * d2 * 2 + cap + slab, 2 * nq * live * d2, "bf16")
    del keys, keys_p, q2, c2, q2b, lp2
    log(f"phase 2: K1's wmma tile agrees at dim {d2} Q=2048 cap={cap} (max "
        f"|dkey value| {err_w:.3g}; {rec['segmax_scan_wmma']['ms']:.4f} ms, "
        f"plain {rec['segmax_scan_wmma']['plain_ms']:.4f} ms)")

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
    rec["segmax_scan_i8"] = entry(
        err5, cuda_ms(torch, lambda: scan.segmax_scan_i8(q8, v8, vs, mask)),
        cuda_ms(torch, lambda: scan.segmax_scan_i8_plain(q8, v8, vs, mask)),
        nq * dim + live * (dim + 4) + cap + slab, 2 * nq * live * dim, "int8")
    del keys, keys_p
    log(f"phase 2: K5 segmax_scan_i8 agrees at Q=2048 k={k} cap={cap} "
        f"(max |dkey value| {err5:.3g}; {rec['segmax_scan_i8']['ms']:.4f} ms, "
        f"plain {rec['segmax_scan_i8']['plain_ms']:.4f} ms)")

    # K10 over the column-scaled int8 mirror at Q = 2048 (segmax_i8c: the
    # same keys route through K2 at k_sel = k + 8): integer keys, so bit
    # for bit the plain version's
    v8c, cs = scan.quantize_cols_i8(corpus)
    q8c = scan.fold_queries_i8(q, cs)
    keys = scan.segmax_scan_i8c(q8c, v8c, mask)
    keys_p = scan.segmax_scan_i8c_plain(q8c, v8c, mask)
    torch.cuda.synchronize()
    assert torch.equal(keys, keys_p), "segmax_scan_i8c keys differ"
    err10 = exact_err(torch, keys, keys_p)
    tk, ti = scan.topk_packed_keys(keys, k + 8)
    assert torch.equal(tk, scan.topk_packed_keys_plain(keys, k + 8)[0])
    rec["segmax_scan_i8c"] = entry(
        err10, cuda_ms(torch, lambda: scan.segmax_scan_i8c(q8c, v8c, mask)),
        cuda_ms(torch, lambda: scan.segmax_scan_i8c_plain(q8c, v8c, mask)),
        nq * dim + live * dim + cap + slab, 2 * nq * live * dim, "int8")
    del keys, keys_p
    log(f"phase 2: K10 segmax_scan_i8c keys = plain bit for bit at Q=2048 "
        f"cap={cap} ({rec['segmax_scan_i8c']['ms']:.4f} ms, plain "
        f"{rec['segmax_scan_i8c']['plain_ms']:.4f} ms; K5 "
        f"{rec['segmax_scan_i8']['ms']:.4f}, K1 {rec['segmax_scan']['ms']:.4f})")

    # P1 over the whole corpus at Q = 2048: the product alone. int8 row
    # maxima (here over the column-scaled mirror) are integers: bit for
    # bit; bf16 maxima within TOL_SCORE (summation order only)
    from picovdb_tpu_torch import probes

    before = scan.LAUNCHES["dot_rowmax_i8_wgmma"]
    got = probes.dot_rowmax(q8c, v8c)
    assert scan.LAUNCHES["dot_rowmax_i8_wgmma"] == before + 1, "P1 int8 wgmma"
    ref_i8 = probes.dot_rowmax_plain(q8c, v8c)
    torch.cuda.synchronize()
    assert torch.equal(got, ref_i8), "P1 int8"
    err_p1i = exact_err(torch, got, ref_i8)
    del ref_i8
    before = scan.LAUNCHES["dot_rowmax_wgmma"]
    got = probes.rowmax_value(probes.dot_rowmax(qb, lp))
    assert scan.LAUNCHES["dot_rowmax_wgmma"] == before + 1, "P1 missed wgmma"
    ref = probes.rowmax_value(probes.dot_rowmax_plain(qb, lp))
    torch.cuda.synchronize()
    err_p1 = float((got - ref).abs().max())
    assert err_p1 <= TOL_SCORE, f"dot_rowmax bf16 maxima differ by {err_p1}"
    rec["dot_rowmax"] = entry(
        err_p1, cuda_ms(torch, lambda: probes.dot_rowmax(qb, lp)),
        cuda_ms(torch, lambda: probes.dot_rowmax_plain(qb, lp)),
        nq * dim * 2 + cap * dim * 2 + nq * 4, 2 * nq * cap * dim, "bf16",
        cuda_ms(torch, lambda: torch.matmul(qb, lp.T)))
    rec["dot_rowmax_i8"] = entry(
        err_p1i, cuda_ms(torch, lambda: probes.dot_rowmax(q8c, v8c)),
        cuda_ms(torch, lambda: probes.dot_rowmax_plain(q8c, v8c)),
        nq * dim + cap * dim + nq * 4, 2 * nq * cap * dim, "int8",
        cuda_ms(torch, lambda: torch._int_mm(q8c, v8c.T)))
    p1i = rec["dot_rowmax_i8"]
    log(f"phase 2: P1 dot_rowmax agrees at Q=2048 cap={cap}: bf16 (wgmma) "
        f"{rec['dot_rowmax']['ms']:.4f} ms (max |d| {err_p1:.3g}; torch.matmul "
        f"{rec['dot_rowmax']['library_ms']:.4f} ms), int8 (wgmma s8) "
        f"{p1i['ms']:.4f} ms (bit for bit; bound {p1i['bound_ms']:.4f} ms, "
        f"torch._int_mm {p1i['library_ms']:.4f} ms, plain "
        f"{p1i['plain_ms']:.4f} ms)")

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
    rec["fused_topk_i8"] = entry(max(errs), ms[0], pms[0],
                                 dim + live * (dim + 4) + cap + 14 * 8,
                                 2 * live * dim, "int8")
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
    flive = int(fmask.sum())
    rec["fused_topk"] = entry(max(e_bf, e_f32), ms_bf, pms_bf,
                              64 * dim * 4 + flive * dim * 2 + cap + 64 * 36 * 8,
                              2 * 64 * flive * dim, "bf16")
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
    rec["fused_topk_i4"] = entry(max(errs), ms[0], pms[0],
                                 dim + live * (dim // 2 + 4) + cap + 14 * 8,
                                 2 * live * dim, "int8")
    log(f"phase 2: K6 fused_topk_i4 agrees at Q=1,8,16 k_sel=14 "
        f"(ms {', '.join(f'{m:.4f}' for m in ms)}; plain "
        f"{', '.join(f'{m:.4f}' for m in pms)}) and Q=16 k_sel=1024 "
        f"({ms_w:.4f} ms, plain {pms_w:.4f})")

    # K9 over the column-scaled int8 mirror at Q = 1, 8, 16, k_sel 16
    # (i8c_fused_smallq at k = 10: guard 6). It ranks the exact int32
    # sums, ties to the lower row: bit for bit the plain version.
    errs, ms, pms, tms = [], [], [], []
    for nq1 in (1, 8, 16):
        qf = normalize_on_device(
            torch.from_numpy(rng.standard_normal((nq1, dim), dtype=np.float32))
            .to(device))
        q8 = scan.fold_queries_i8(qf, cs)
        before = scan.LAUNCHES["scan_topk_i8c_sweep"]
        got = scan.fused_topk_i8c(q8, v8c, mask, 16)
        assert scan.LAUNCHES["scan_topk_i8c_sweep"] == before + 1, \
            f"K9 missed the sweep at Q={nq1}"
        ref = scan.fused_topk_i8c_plain(q8, v8c, mask, 16)
        torch.cuda.synchronize()
        assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1]), \
            f"fused_topk_i8c differs at Q={nq1}"
        errs.append(exact_err(torch, got[0], ref[0]))
        ms.append(cuda_ms(torch, lambda: scan.fused_topk_i8c(q8, v8c, mask, 16)))
        pms.append(cuda_ms(torch, lambda: scan.fused_topk_i8c_plain(
            q8, v8c, mask, 16)))
        tms.append(k9_template_ms(torch, scan, q8, v8c, mask, 16))
    rec["fused_topk_i8c"] = entry(max(errs), ms[0], pms[0],
                                  dim + live * dim + cap + 16 * 8,
                                  2 * live * dim, "int8")
    log(f"phase 2: K9 fused_topk_i8c (one-query sweep) = plain bit for bit "
        f"at Q=1,8,16 k_sel=16 (ms {', '.join(f'{m:.4f}' for m in ms)}; "
        f"bound {rec['fused_topk_i8c']['bound_ms']:.4f} ms at Q=1; the "
        f"template it replaced {', '.join(f'{m:.4f}' for m in tms)}; plain "
        f"{', '.join(f'{m:.4f}' for m in pms)}; K3 at Q=1 "
        f"{rec['fused_topk_i8']['ms']:.4f})")
    del corpus, lp, v8, vs, v4, vs4, v8c
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
    hot_live = int((mask & live_rows).sum())  # the live hot tiles' live rows
    rec["ivf_scan_topk"] = entry(max(errs), first[0], first[1],
                                 dim * 4 + hot_live * dim * 4 + cap + 14 * 8,
                                 2 * hot_live * dim, "f32")
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
    rec["ivf_segmax_scan"] = entry(
        max(errs), first[0], first[1],
        64 * dim * 4 + hot_live * dim * 4 + cap + 64 * 64 * 4 * ns * 4,
        2 * 64 * hot_live * dim, "f32")
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


def phase_main(torch, scan, device, n: int, dim: int, rng, card: str, rec,
               **db_kwargs):
    """The serving path through the public API on an n x dim store
    (`db_kwargs` go to every PicoVectorDB this phase builds). Raises K1's
    max_abs_err in `rec` to what it saw on the store's mirror."""
    from picovdb_tpu_torch import K_ID, PicoVectorDB
    from picovdb_tpu_torch.ops.exact import normalize_on_device

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
    # K1 alone at one 2048-query chunk on the store's own mirror and mask
    # (after the count: not the path's): held against its plain version,
    # run over 131,072-row slices (its keys are per 128-row segment), and
    # timed beside the chunk's wall time
    dev = db._dev
    qf = normalize_on_device(qdev[:2048])
    qb = qf.to(torch.bfloat16)
    keys = scan.segmax_scan(qb, dev.vectors_lp, dev.active)
    step = 131_072
    keys_p = torch.cat([
        scan.segmax_scan_plain(qb, dev.vectors_lp[s:s + step],
                               dev.active[s:s + step])
        for s in range(0, dev.vectors_lp.shape[0], step)], 1)
    torch.cuda.synchronize()
    assert keys.shape == keys_p.shape, (keys.shape, keys_p.shape)
    err1, _ = check_segmax_keys(torch, scan, keys, keys_p, qf, dev.vectors,
                                10, "K1 (wgmma) on the store's mirror")
    rec["segmax_scan"]["max_abs_err"] = max(rec["segmax_scan"]["max_abs_err"],
                                            err1)
    del keys, keys_p
    k1_ms = cuda_ms(torch, lambda: scan.segmax_scan(qb, dev.vectors_lp,
                                                    dev.active))
    chunk_ms = batch_s / 4 * 1e3
    del qb, qf
    log(f"phase 3: main path at {n} x {dim}: routes segmax_mixed_stream, "
        f"i8_fused_smallq, fview_segmax, mixed_fused_batch_filtered, "
        f"mixed_fused_batch; recall@10 {recall:.4f} vs float64 (filter view "
        f"{recall_f:.4f} vs the filtered oracle); delete ok; launches "
        f"{counts}")
    log(f"phase 3: K1 (wgmma) keys at Q=2048 over the store's "
        f"{dev.vectors_lp.shape[0]}-row mirror agree with the plain version "
        f"(max |dkey value| {err1:.3g}, KEY_MIN pattern equal, K2 + rescored "
        f"rows = plain outside the gap)")

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
        f"{8192 / batch_s:.1f} QPS (query_columnar, 8192 queries); a "
        f"2048-query chunk {chunk_ms:.3f} ms of wall, K1 {k1_ms:.4f} ms of it "
        f"({100 * k1_ms / chunk_ms:.1f} %, CUDA events on the store's "
        f"{dev.vectors_lp.shape[0]}-row bf16 mirror); Q=1 latency "
        f"{q1_ms:.4f} ms (CUDA events around PicoVectorDB.query); card {card}")
    shutil.rmtree(tmp)
    return counts


def phase_wmma_store(torch, scan, device, n: int, dim: int, rng,
                     **db_kwargs):
    """A float32 store whose width TMA cannot read (dim % 8 != 0): its
    2048-query chunks take segmax_mixed_stream through K1's wmma tile;
    recall@10 against a float64 oracle."""
    from picovdb_tpu_torch import PicoVectorDB

    corpus = rng.standard_normal((n, dim), dtype=np.float32)
    near = corpus[rng.integers(0, n, 2048)]
    qdev = torch.from_numpy(
        near + 0.01 * rng.standard_normal(near.shape, dtype=np.float32)
    ).to(device)
    scan.reset_launch_counts()  # count this path's launches only
    db = PicoVectorDB(embedding_dim=dim, index="exact", device=device,
                      storage_file=os.path.join(os.getcwd(), "picovdb_smoke_w"),
                      **db_kwargs)
    db.upsert_columnar(corpus, ids=[f"w{i}" for i in range(n)], copy=False)
    got, _ = db.query_columnar(qdev, top_k=10, batch_size=2048)
    assert db.last_query_debug()["strategy"] == "segmax_mixed_stream"
    counts = dict(scan.LAUNCHES)
    counts["segmax_wmma"] = counts["segmax"] - counts["segmax_wgmma"]
    assert counts["segmax_wmma"] > 0 and counts["segmax_wgmma"] == 0, counts
    truth = oracle_top10(torch, torch.from_numpy(corpus).to(device),
                         qdev[:64], torch.ones(n, dtype=torch.bool,
                                               device=device))
    recall = recall_at_10(got[:64], truth, "w")
    assert recall >= 0.99, recall
    log(f"phase 3b: a {n} x {dim} float32 store (bf16 mirror rows of "
        f"{dim * 2} bytes, not a multiple of 16): route segmax_mixed_stream through "
        f"K1's wmma tile, recall@10 {recall:.4f} vs float64; launches {counts}")
    del db
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


# The opt-in selection tiers of phase 9: (name, environment, PicoVectorDB
# keywords, batch route, Q = 1 route, counter keys the path must launch)
TIERS = [
    ("a defaults", {}, {}, "segmax_mixed_stream", "i8_fused_smallq",
     ("segmax", "topk_keys", "scan_topk_i8")),
    ("b PICOVDB_SEGMAX_I8=1", {"PICOVDB_SEGMAX_I8": "1"}, {},
     "segmax_i8_stream", "i8_fused_smallq",
     ("segmax_i8", "topk_keys", "scan_topk_i8")),
    ("c PICOVDB_SEGMAX_I8C=1 PICOVDB_SMALLQ_I8C=1",
     {"PICOVDB_SEGMAX_I8C": "1", "PICOVDB_SMALLQ_I8C": "1"}, {},
     "segmax_i8c_stream", "i8c_fused_smallq",
     ("segmax_i8c", "topk_keys", "scan_topk_i8c")),
    ("d scan_mode=approx", {}, {"scan_mode": "approx"}, "xla_approx",
     "xla_approx", ()),
]


def route_kernel_ms(torch, scan, dev, qdev, name: str):
    """The batch route's key kernel on the store's planes at one
    2048-query chunk, and the Q = 1 route's selection kernel (k_sel of
    k = 10 with the route's guard); (None, None) for the dense route."""
    from picovdb_tpu_torch.ops.exact import normalize_on_device

    qn = normalize_on_device(qdev[:2048])
    q1 = qn[:1]
    act = dev.active
    if name.startswith("a"):
        qb = qn.to(torch.bfloat16)
        q8, _ = scan.quantize_rows_i8(q1)
        return (cuda_ms(torch, lambda: scan.segmax_scan(qb, dev.vectors_lp, act)),
                cuda_ms(torch, lambda: scan.fused_topk_i8(
                    q8, dev.vectors_i8, dev.vscale, act, 14)))
    if name.startswith("b"):
        qq, _ = scan.quantize_rows_i8(qn)
        return (cuda_ms(torch, lambda: scan.segmax_scan_i8(
            qq, dev.vectors_i8, dev.vscale, act)), None)
    if name.startswith("c"):
        qq = scan.fold_queries_i8(qn, dev.cscale)
        return (cuda_ms(torch, lambda: scan.segmax_scan_i8c(qq, dev.vectors_i8c, act)),
                cuda_ms(torch, lambda: scan.fused_topk_i8c(
                    qq[:1], dev.vectors_i8c, act, 16)))
    return None, None


def check_i8c_on_store(torch, scan, dev, qdev, rec) -> str:
    """K10 on one 2048-query chunk and K9 at Q = 1 and 16 (k_sel 16) over
    store (c)'s own column-scaled mirror, the planes its routes read,
    against their plain versions: integer keys and sums, so bit for bit.
    The plain K10 runs over 131,072-row slices (its keys are per 128-row
    segment). Raises each kernel's max_abs_err in `rec` to what it saw."""
    from picovdb_tpu_torch.ops.exact import normalize_on_device

    qq = scan.fold_queries_i8(normalize_on_device(qdev[:2048]), dev.cscale)
    v8c, act = dev.vectors_i8c, dev.active
    keys = scan.segmax_scan_i8c(qq, v8c, act)
    err10, step = 0.0, 131_072
    for s in range(0, v8c.shape[0], step):
        ref = scan.segmax_scan_i8c_plain(qq, v8c[s:s + step], act[s:s + step])
        got = keys[:, 2 * s // scan.SEG:][:, :ref.shape[1]]
        assert torch.equal(got, ref), f"K10 keys differ in rows {s}.."
        err10 = max(err10, exact_err(torch, got, ref))
    del keys
    err9, sweep_ms, tmpl_ms = 0.0, [], []
    for nq in (1, 16):
        before = scan.LAUNCHES["scan_topk_i8c_sweep"]
        got = scan.fused_topk_i8c(qq[:nq], v8c, act, 16)
        assert scan.LAUNCHES["scan_topk_i8c_sweep"] == before + 1
        ref = scan.fused_topk_i8c_plain(qq[:nq], v8c, act, 16)
        assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1]), \
            f"K9 differs at Q={nq} on the store's mirror"
        err9 = max(err9, exact_err(torch, got[0], ref[0]))
        q1 = qq[:nq]
        sweep_ms.append(cuda_ms(torch, lambda: scan.fused_topk_i8c(q1, v8c, act,
                                                                   16)))
        tmpl_ms.append(k9_template_ms(torch, scan, q1, v8c, act, 16))
    for name, err in (("segmax_scan_i8c", err10), ("fused_topk_i8c", err9)):
        rec[name]["max_abs_err"] = max(rec[name]["max_abs_err"], err)
    return (f"; K10 keys (2048 queries) and K9 (one-query sweep, Q=1, 16, "
            f"k_sel 16) = plain bit for bit over the store's "
            f"{v8c.shape[0]}-row mirror, K9 at Q=1, 16 {sweep_ms[0]:.4f}, "
            f"{sweep_ms[1]:.4f} ms, the template it replaced "
            f"{tmpl_ms[0]:.4f}, {tmpl_ms[1]:.4f} ms")


def phase_tiers(torch, scan, device, n: int, dim: int, rng, card: str, rec,
                **db_kwargs):
    """The opt-in selection tiers A/B: one seeded n x dim float32 corpus and
    one query set, served by one store at a time through the public API
    under (a) the defaults, (b) PICOVDB_SEGMAX_I8=1, (c) the column-scaled
    int8 routes, (d) scan_mode="approx". Per store: routes, launches,
    recall@10 against a float64 oracle, batch QPS, Q = 1 latency and the
    route's kernel time. Store (c) also takes 1,000 upserts with one row
    past its column maxima (the mirror is requantized at the next
    dispatch), runs the serial Q = 1 loop, and holds K10 and K9 against
    their plain versions on its mirror (`check_i8c_on_store`, into
    `rec`)."""
    from picovdb_tpu_torch import PicoVectorDB

    corpus = rng.standard_normal((n, dim), dtype=np.float32)
    corpus /= np.linalg.norm(corpus, axis=1, keepdims=True)
    ids = [f"t{i}" for i in range(n)]
    near = corpus[rng.integers(0, n, 8192)]
    qdev = torch.from_numpy(
        near + 0.01 * rng.standard_normal(near.shape, dtype=np.float32)
    ).to(device)
    one = qdev[0].cpu().numpy()
    corpus_dev = torch.from_numpy(corpus).to(device)
    chunks = [(s, corpus_dev[s:s + 131_072]) for s in range(0, n, 131_072)]
    ov, oi = oracle_masked(torch, chunks, qdev[:64], None)  # top-11
    del chunks, corpus_dev
    torch.cuda.empty_cache()
    new = rng.standard_normal((1000, dim), dtype=np.float32)
    new[0] = 0.0
    new[0, 0] = 1.0  # unit norm, past column 0's maximum (~0.17 at dim 1024)
    tmp = tempfile.mkdtemp(prefix="picovdb_smoke_", dir=os.getcwd())
    out = {}
    for name, envs, kw, batch_route, q1_route, keys in TIERS:
        saved = {e: os.environ.get(e) for e in envs}
        os.environ.update(envs)
        try:
            scan.reset_launch_counts()  # count this store's path only
            db = PicoVectorDB(embedding_dim=dim, index="exact", device=device,
                              storage_file=os.path.join(tmp, name[0]), **kw,
                              **db_kwargs)
            t0 = time.perf_counter()
            db.upsert_columnar(corpus, ids=ids)
            db.rebuild_index()
            torch.cuda.synchronize()
            insert_s = time.perf_counter() - t0
            got, _ = db.query_columnar(qdev, top_k=10, batch_size=2048)
            assert db.last_query_debug()["strategy"] == batch_route, name
            assert (got != None).all()  # noqa: E711
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            db.query_columnar(qdev, top_k=10, batch_size=2048)
            batch_s = time.perf_counter() - t0
            before = scan.LAUNCHES["scan_topk_i8c_sweep"]
            res = db.query(one, top_k=10)
            assert db.last_query_debug()["strategy"] == q1_route, name
            assert len(res) == 10
            if name.startswith("c"):
                assert scan.LAUNCHES["scan_topk_i8c_sweep"] > before, \
                    "i8c_fused_smallq missed K9's sweep"
            q1_ms = cuda_ms(torch, lambda: db.query(one, top_k=10), reps=50)
            recall = recall_at_10(got[:64], oi[:, :10], "t")
            assert recall >= 0.99, (name, recall)
            extra = ""
            if name.startswith("c"):
                extra = tiers_mutations(torch, db, new, qdev[:64], ov, oi)
            counts = dict(scan.LAUNCHES)
            for key in keys:
                assert counts[key] > 0, f"{key} never launched on store {name}"
            k_ms, q1_k_ms = route_kernel_ms(torch, scan, db._dev, qdev, name)
            if name.startswith("c"):  # after the count: not the path's
                extra += check_i8c_on_store(torch, scan, db._dev, qdev, rec)
        finally:
            for e, v in saved.items():
                if v is None:
                    os.environ.pop(e, None)
                else:
                    os.environ[e] = v
        out[name[0]] = {"qps": 8192 / batch_s, "q1_ms": q1_ms,
                        "recall": recall, "kernel_ms": k_ms,
                        "q1_kernel_ms": q1_k_ms, "counts": counts}
        fmt = lambda x: "n/a" if x is None else f"{x:.4f}"  # noqa: E731
        log(f"phase 9: store ({name}) at {n} x {dim} float32: routes "
            f"{batch_route} (8192 queries, 2048-query chunks) and {q1_route}"
            f" (Q=1); recall@10 {recall:.4f} vs float64; batch "
            f"{8192 / batch_s:.1f} QPS; Q=1 latency {q1_ms:.4f} ms; route "
            f"kernel {fmt(k_ms)} ms per 2048-query chunk, Q=1 selection "
            f"kernel {fmt(q1_k_ms)} ms; insert {n / insert_s:.1f} vec/s"
            f"{extra}; launches {counts}")
        del db
        torch.cuda.empty_cache()
    shutil.rmtree(tmp)
    a = out["a"]
    rel = lambda x, y: f"{x / y:.3f}x"  # noqa: E731
    wins_batch = [t for t in "bcd" if out[t]["qps"] > a["qps"]]
    wins_q1 = [t for t in "bcd" if out[t]["q1_ms"] < a["q1_ms"]]
    log(f"phase 9 A/B (do the opt-in tiers win on Hopper? card {card}): batch "
        f"QPS a {a['qps']:.1f}, b {out['b']['qps']:.1f} "
        f"({rel(out['b']['qps'], a['qps'])} of a), c {out['c']['qps']:.1f} "
        f"({rel(out['c']['qps'], a['qps'])}), d {out['d']['qps']:.1f} "
        f"({rel(out['d']['qps'], a['qps'])}); Q=1 ms a {a['q1_ms']:.4f}, b "
        f"{out['b']['q1_ms']:.4f}, c {out['c']['q1_ms']:.4f}, d "
        f"{out['d']['q1_ms']:.4f}; batch key kernel per chunk K1 "
        f"{a['kernel_ms']:.4f} ms, K5 {out['b']['kernel_ms']:.4f}, K10 "
        f"{out['c']['kernel_ms']:.4f}; Q=1 selection K3 "
        f"{a['q1_kernel_ms']:.4f} ms, K9 {out['c']['q1_kernel_ms']:.4f}; "
        f"faster than the defaults: batch {wins_batch or 'none'}, Q=1 "
        f"{wins_q1 or 'none'}")
    return {t: v["counts"] for t, v in out.items()}


def tiers_mutations(torch, db, new, q64, ov, oi) -> str:
    """Store (c): 1,000 upserts, one of them past the column maxima, drop
    the column-scaled mirror; the next dispatch requantizes it (timed) and
    every new row is found at rank 1. Then the serial Q = 1 loop, whose
    ids must equal the per-call route's outside the oracle's gap and whose
    every query must launch K9's sweep; it is timed beside the cost of the
    device guard each launch runs under."""
    from picovdb_tpu_torch.ops import scan

    dev = db._dev
    cmax = float(dev.cscale.max())
    db.upsert_columnar(new, ids=[f"u{i}" for i in range(new.shape[0])])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    hits = db.query(new[0], top_k=1)
    torch.cuda.synchronize()
    rebuild_s = time.perf_counter() - t0
    assert db.last_query_debug()["strategy"] == "i8c_fused_smallq"
    assert hits[0]["_id_"] == "u0" and float(dev.cscale.max()) > cmax
    back, _ = db.query_columnar(new, top_k=1)
    assert db.last_query_debug()["strategy"] == "segmax_i8c_stream"
    assert [r[0] for r in back] == [f"u{i}" for i in range(new.shape[0])]
    before = dict(scan.LAUNCHES)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    vals, slots = db.query_serial_loop(q64.cpu().numpy(), top_k=10)
    torch.cuda.synchronize()
    loop_ms = (time.perf_counter() - t0) * 1e3 / q64.shape[0]
    assert dev.last_strategy == "i8c_fused_smallq_loop"
    sweeps = scan.LAUNCHES["scan_topk_i8c_sweep"] - before["scan_topk_i8c_sweep"]
    assert sweeps == q64.shape[0], f"serial loop: {sweeps} sweep launches"
    launches = sum(v - before[key] for key, v in scan.LAUNCHES.items()
                   if not key.endswith(("_sweep", "_wgmma")))  # _launch calls
    # what the device guard (torch.cuda.device around each launch) costs
    n_guard = 20_000
    t0 = time.perf_counter()
    for _ in range(n_guard):
        with torch.cuda.device(dev.active.device):
            pass
    guard_us = (time.perf_counter() - t0) * 1e6 / n_guard
    loop_ids = [[db._ids[s] for s in row] for row in slots]
    per_call = [[h["_id_"] for h in db.query(q, top_k=10)]
                for q in q64.cpu().numpy()]
    bad = sum(set(loop_ids[i]) != set(per_call[i])
              for i in range(64) if ov[i, 9] - ov[i, 10] > TOL_GAP)
    assert bad == 0, f"{bad} of 64 serial-loop id sets differ from per-call"
    return (f"; 1000 upserts (one row past the column maxima): mirror "
            f"requantized by the next dispatch in {rebuild_s:.3f} s (Q=1 "
            f"incl. the scatter), every new row found at rank 1; "
            f"query_serial_loop i8c_fused_smallq_loop ids = per-call route "
            f"on 64/64, {loop_ms:.4f} ms a query (host clock), K9's sweep "
            f"once a query, {launches / q64.shape[0]:.0f} counted launch(es) "
            f"a query, each under a device guard of {guard_us:.2f} us "
            f"(torch.cuda.device entered and left, host clock, "
            f"{n_guard} times)")


def phase_probes(torch, scan, device, card: str):
    """The two bench probes at their shape (8192 x 102,400 x 1024), one
    JSON line each; P1's agreement with its plain version is checked."""
    from picovdb_tpu_torch import probes

    scan.reset_launch_counts()
    sweep = probes.segmax_sweep(device)
    stages = probes.i8c_stages(device)
    counts = dict(scan.LAUNCHES)
    assert counts["dot_rowmax"] > 0, "dot_rowmax never launched by the probes"
    assert sweep["p1_i8_equal_plain"], "P1 int8 maxima differ from plain"
    assert sweep["p1_i8_wgmma"] and counts["dot_rowmax_i8_wgmma"] > 0, \
        "P1 int8 missed the wgmma mainloop"
    # unnormalized gaussian data: maxima near 140, so a relative limit; a
    # TF32 product would miss it by ~10x (2^-11 per product)
    assert sweep["p1_bf16_max_rel_err"] <= 1e-5, sweep["p1_bf16_max_rel_err"]
    for name, res in (("segmax_sweep", sweep), ("i8c_stages", stages)):
        print(json.dumps({"phase": 10, "probe": name, "card": card, **res}),
              flush=True)
    log(f"phase 10: P1 is {sweep['p1_bf16_ms'] / sweep['k1_segmax_bf16_ms']:.3f}"
        f" of K1's time (bf16), {sweep['p1_i8_ms'] / sweep['k10_segmax_i8c_ms']:.3f}"
        f" of K10's (int8); full i8c route {stages['full_i8c_ms']:.4f} ms vs "
        f"bf16 {stages['full_bf16_ms']:.4f} ms; launches {counts}")
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
    phase_ivf_kernels(torch, scan, device, PHASE2_CAP, DIM, rng, rec)
    counts = {3: phase_main(torch, scan, device, MAIN_N, DIM, rng, card, rec)}
    torch.cuda.empty_cache()
    counts["3b"] = phase_wmma_store(torch, scan, device, WMMA_N, DIM - 4, rng)
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
    torch.cuda.empty_cache()
    counts[9] = phase_tiers(torch, scan, device, TIERS_N, DIM, rng, card,
                           rec)["c"]
    torch.cuda.empty_cache()
    counts[10] = phase_probes(torch, scan, device, card)

    kernels = [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": counts[phase][key], **rec[name]}
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
