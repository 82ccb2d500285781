#!/usr/bin/env python3
"""Smoke run of picovdb_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Builds the hand-written kernels from `picovdb_tpu_torch/csrc`, checks each
one against its plain PyTorch version on the card, then drives the serving
paths through the public `PicoVectorDB` API and checks what comes back:
a 1M x 1024 float32 store (phase 3), a 131,072 x 1020 float32 store whose
rows TMA cannot read, served by K1's mainloop fed by cp.async, and a
131,072 x 1019 one (odd width) served by K1's mainloop fed by its
realigning producer (phase 3b), a 1M x 1024 int8
store with the host-f64 rescore and a quantized checkpoint (phase 4, its
Q = 64 batches on K3's tensor-core scan), a device-born
16M x 1024 int4 store (phase 5, an 8 GB packed plane), a 262,144 x 1024
bfloat16 store (phase 6), the IVF tier's classic layout over a clustered
2M x 1024 float32 store under index="auto" (phase 7), its int8-only
layout over a device-born, clustered 8M x 1024 int4 store and a sidecar
round trip (phase 8), the opt-in selection tiers A/B over one 1M x 1024
float32 corpus (phase 9: defaults, PICOVDB_SEGMAX_I8, the column-scaled
int8 routes, scan_mode="approx"), the two bench probes (phase 10), and
last the mesh stores (phase 11, its own generator): `mesh=` over four
devices (cuda:i % count: four shards on one card, one a card on four),
2M x 1024 float32 with K4 on every shard beside the one-device store,
the plain sharded scan and a dp = 2 x 2 mesh; int8 / int4 storage with K3
/ K6 on every shard and the host rescore; a clustered 2M x 1024
index="ivf" store (ShardedIVF, K7 on every shard). Each mesh store's
launches must equal shards x the row-calls it made. Phase 12 (its own
generator) serves one store across processes: the script starts its
ranks (`--mp-rank`), one a card under NCCL on two or more cards, else two
on cuda:0 under gloo, and every rank must pass: 12a a 2M x 1024 float32
checkpoint loaded distributed (each rank reads its own file), K4 a local
shard, a mutation epoch, the distributed save and reload; 12b int8
storage upserted on every rank (K3 a local shard, host rescore); 12c 4M
packed int4 rows through make_sharded_topk (K6 a local shard); 12d
ShardedIVF across ranks (K7 a local shard). Launches are local shards x
calls on every rank. Phase 13 (its own generator, run after phase 10)
drives the embedding model and the on-device RAG pipeline: (a)
BertMeanPoolEncoder at MiniLM-L6's widths (`random_init`) embeds 131,072
seeded chunks on the card, held to its host forward on 256 of them; (b)
`ingest_device` of those vectors and self-retrieval of every chunk
through `query_columnar`, the crowding mark held to the float64 oracle;
(c) K1 + K2's own answers on a centred copy of that store and on an
isotropic store, and K1-K4 at dim 384 against their plain versions; (d)
text queries, a Q = 1 `query` (K3) and a `where=` batch (K4); (e) the
`picovdb_tpu_torch.tools.rag_demo --device-pipeline` tool in a
subprocess. `--rag` runs the build and phase 13 alone. Phase 14 (its
own generator, run last) drives the API tools and the entry points as a
user runs them: (a) `python -m picovdb_tpu_torch.tools.upserts`,
`queries` and `batch_queries` at 100,000 x 1024 and `many_upserts` at
10,000 x 1024, each a subprocess that must exit 0 (the saved store
reloads with every row); (b) the query profiler's `run_suite` at 100,000
rows (numpy corpus) and 1,000,000 (made on the card, `ingest_device`),
batch sizes 1 / 16 / 256, then every scenario x batch size on a store
built from the same seed held to a float64 oracle over the rows its
filter admits (the IVF tier's cells over the rows their probe scanned),
with each cell's route and launches; (c) `graft_entry.entry()` (K4 at
256 x 102,400 x 1024 against its plain step, the oracle, its bound and
the library pair) and `dryrun_multichip(4)` over cuda:i % count
(launches = shards x row-calls). `--tools` runs the build and phase 14
alone.
Launch counts are zeroed just before each path and read just after it.
Where a kernel was redesigned, the kernel it replaced at those shapes is
held to the same plain version and timed beside it on the same inputs
(K9, K7, K6, K3, K4: the template; K10, K5: the mma.sync tile; K8: its
first kernel; K1 at dims 1020 and 1019: the wmma tile); K2 is timed
beside torch.topk at its launch shapes, and every other kernel of phase
2 beside the PyTorch calls that compute its function on the same inputs
(`library_ms`, `library_call`: the product alone for K1 / K5 / K10 / P1,
the product + torch.topk for K3 / K4 / K9, a gather of the probed tiles'
rows first for K7 / K8; none for K6, whose packed nibbles no PyTorch call
multiplies); phases 3 and 7 also time
K4's tensor-core scan and its template at Q = 1 ... 256, and phase 4 K3's
sweep and tensor-core scan at Q = 1 ... 64 (the crossovers behind their
ready rules). `python3 chip_smoke.py --q64-latency` times only the int8
store's Q = 64 host-rescored batches through the public API, on a store
of its own, so that a checkout without this script's other phases can be
timed beside this one; `--mesh` runs the build and phase 11 alone (the
pass with one shard a card on a four-card machine, where only phase 11
uses more than one card); `--multiprocess` runs the build and phase 12
alone (one rank a card on a machine of several) with a trace of each
rank's 12a chunks, and `--trace-mesh`
traces phase 11a's store's 2048-query chunks with torch.profiler (where
each card's scans run, and which host step waits). Every
phase prints its lines; any failure raises and the script exits
non-zero without a result line. It imports neither JAX nor picovdb_tpu,
and refuses to run without a card.

Output, in order: the phase lines (phase 10 adds one JSON line per
probe), the card's name and power limit as `nvidia-smi` reports them,
one JSON object with the per-kernel record (time, plain time, bound,
library call and its time, launches; K3 / K4 / K6 / K7 also
`mesh_launches`, phase 11's, and `mp_launches`, phase 12's summed over
the ranks; K1-K4 also `rag_launches`, phase 13's, and `rag_384`, their
times at dim 384; K1-K4, K6-K8 `tools_launches`, phase 14's), and last
`{"ok": true, "device": {...}}`. Phase 14 adds one JSON line of its
numbers (`{"phase14": ...}`: the tools' parsed lines, the profiler's
rows and checks, the entry's record) before the card's line.
"""

from __future__ import annotations

import contextlib
import json
import os
import re
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
WMMA_N = 131_072  # float32 stores at dim 1020 (K1's cp.async producer) and
ODD_DIM = 1019  # 1019 (K1's wmma tile), phase 3b
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
# "f32" is the CUDA cores' float32 rate, "tf32" the tensor cores' TF32
# rate (495 TFLOP/s).
PEAK_OPS_PER_S = {"bf16": 989e12, "int8": 1979e12, "f32": 67e12,
                  "tf32": 495e12}
# The query counts phase 5 holds and times K6 at: those its path launches
# (1, 256, 2048) and those around the ready rules' limits
K6_SHAPES = (1, 2, 4, 5, 8, 16, 17, 64, 256, 2048)
# K6's kernels besides its template, by their launch counters
K6_KERNELS = {"sweep": "scan_topk_i4_sweep",
              "tensor-core scan": "scan_topk_i4_wgmma"}
# K3's kernels besides its template, by their launch counters
K3_KERNELS = {"sweep": "scan_topk_i8_sweep",
              "tensor-core scan": "scan_topk_i8_wgmma"}
# The (Q, k_sel) shapes phase 3 holds and times K3 at on the store's int8
# mirror: its Q = 1 route (k = 10 + 4), the small batches around the
# sweep's limit, and the host-rescore band (k + 128 + 4)
K3_SHAPES = tuple((nq, k) for k in (14, 142) for nq in (1, 2, 4, 8, 16))
# The (Q, k_sel) shapes phase 4 holds and times K3 at on the int8 store's
# own plane: the host-rescore band's launches (Q = 1 and the Q = 64
# batches at k_sel 142) and Q = 17 / 128 around them, the small-batch band
# (k_sel 14) at Q = 64 and a 2048-query batch, then the crossover between
# the sweep and the tensor-core scan (Q = 1 ... 64, k_sel 14 and 142)
K3_PHASE4 = ((1, 142), (17, 142), (64, 142), (128, 142), (64, 14),
             (2048, 14))
K3_CROSSOVER = tuple((nq, k) for k in (14, 142)
                     for nq in (1, 2, 4, 8, 16, 17, 32, 64))
# A kernel slower than this (ms) on its first timed run is timed once
SLOW_MS = 100.0
# The (Q, k_sel) shapes phases 3 and 7 time K4's tensor-core scan and its
# template at, on the 1M bf16 mirror and the 2M float32 rows: the batch
# routes' guard bands at k = 10 and 32, Q from 1 to the exact route's 256
K4_SHAPES = tuple((nq, k) for k in (14, 36)
                  for nq in (1, 2, 4, 8, 16, 32, 64, 256))

KERNELS = {
    # name: (launch-counter key, source, TPU kernel it replaces, the phase
    # whose serving path must launch it). K1 is three kernels: the TMA +
    # wgmma mainloop (csrc/wgmma_tiles.cuh) wherever dim % 8 == 0, the same
    # mainloop fed by cp.async at other even widths, which phase 3b's
    # dim-1020 store drives, and fed by its realigning producer at odd
    # widths (and 2-byte aligned views), which phase 3b's dim-1019 store
    # drives. K2's row is its split-row warp select. P1 has a row
    # per kind, both on the mainloop, and so does K10 (its int8
    # instantiation). K9's and K7's rows are their one-query sweep
    # (csrc/sweep_topk.cu), which serves every Q <= 16 call of phases 9 and
    # 7 / 8. K6 has a row per kernel: the sweep's int4 kind serves phase
    # 5's Q = 1 calls, the tensor-core scan (csrc/scan_i4_wgmma.cu) its
    # 2048- and 256-query batches. K3's row is the sweep's row-scaled int8
    # kind, which serves phase 3's Q = 1 calls (and phase 4's host-rescore
    # band at Q = 1), and its tensor-core scan's int8 kind
    # (csrc/scan_topk_wgmma.cu), which serves phase 4's Q = 64 batches of
    # the host-rescore band. K8 has a row per postings kind, both on its tensor-core
    # segment scan (csrc/ivf_segmax_wgmma.cu): float32 on phase 7's
    # 32-query chunks, int8 on phase 8's. K4's row is its tensor-core scan
    # (csrc/scan_topk_wgmma.cu), which serves phase 3's Q = 64 batches and
    # phase 7's Q = 256 batch; K5's the int8 instantiation of the
    # mainloop, which serves phase 4's chunks.
    "segmax_scan": ("segmax_wgmma", "picovdb_tpu_torch/csrc/segmax.cu",
                    "picovdb_tpu/ops/pallas_scan.py:443", 3),
    "segmax_scan_cpasync": ("segmax_cpasync",
                            "picovdb_tpu_torch/csrc/segmax.cu",
                            "picovdb_tpu/ops/pallas_scan.py:443", "3b"),
    "segmax_scan_realign": ("segmax_realign",
                            "picovdb_tpu_torch/csrc/segmax.cu",
                            "picovdb_tpu/ops/pallas_scan.py:443", "3b"),
    "topk_packed_keys": ("topk_keys", "picovdb_tpu_torch/csrc/topk_keys.cu",
                         "picovdb_tpu/ops/pallas_scan.py:536", 3),
    "fused_topk_i8": ("scan_topk_i8_sweep",
                      "picovdb_tpu_torch/csrc/sweep_topk.cu",
                      "picovdb_tpu/ops/pallas_scan.py:865", 3),
    "fused_topk_i8_wgmma": ("scan_topk_i8_wgmma",
                            "picovdb_tpu_torch/csrc/scan_topk_wgmma.cu",
                            "picovdb_tpu/ops/pallas_scan.py:865", 4),
    "fused_topk": ("scan_topk_wgmma",
                   "picovdb_tpu_torch/csrc/scan_topk_wgmma.cu",
                   "picovdb_tpu/ops/pallas_scan.py:226", 3),
    "segmax_scan_i8": ("segmax_i8_wgmma", "picovdb_tpu_torch/csrc/segmax.cu",
                       "picovdb_tpu/ops/pallas_scan.py:960", 4),
    "fused_topk_i4": ("scan_topk_i4_sweep",
                      "picovdb_tpu_torch/csrc/sweep_topk.cu",
                      "picovdb_tpu/ops/pallas_scan.py:1315", 5),
    "fused_topk_i4_wgmma": ("scan_topk_i4_wgmma",
                            "picovdb_tpu_torch/csrc/scan_i4_wgmma.cu",
                            "picovdb_tpu/ops/pallas_scan.py:1315", 5),
    "ivf_scan_topk": ("ivf_scan_topk_sweep",
                      "picovdb_tpu_torch/csrc/sweep_topk.cu",
                      "picovdb_tpu/ops/ivf.py:1237", 7),
    "ivf_segmax_scan": ("ivf_segmax_wgmma",
                        "picovdb_tpu_torch/csrc/ivf_segmax_wgmma.cu",
                        "picovdb_tpu/ops/ivf.py:1492", 7),
    "ivf_segmax_scan_i8c": ("ivf_segmax_wgmma",
                            "picovdb_tpu_torch/csrc/ivf_segmax_wgmma.cu",
                            "picovdb_tpu/ops/ivf.py:1492", 8),
    "fused_topk_i8c": ("scan_topk_i8c_sweep",
                       "picovdb_tpu_torch/csrc/sweep_topk.cu",
                       "picovdb_tpu/ops/pallas_scan.py:1705", 9),
    "segmax_scan_i8c": ("segmax_i8c_wgmma", "picovdb_tpu_torch/csrc/segmax.cu",
                        "picovdb_tpu/ops/pallas_scan.py:1528", 9),
    "dot_rowmax": ("dot_rowmax_wgmma", "picovdb_tpu_torch/csrc/probe.cu",
                   "bench/segmax_sweep_probe.py:73", 10),
    "dot_rowmax_i8": ("dot_rowmax_i8_wgmma", "picovdb_tpu_torch/csrc/probe.cu",
                      "bench/segmax_sweep_probe.py:73", 10),
}


def entry(err, ms, plain_ms, nbytes, ops, kind, library_ms=None,
          library_call=None) -> dict:
    """One kernel's record at the shape it was timed: agreement with its
    plain version, times, and what its least time is computed from (bytes
    each input read once and each output written once; operations of
    type `kind`), counting only the rows this run's mask leaves live; the
    PyTorch calls that compute the same function (`library_call`) and
    their time on the same inputs (`library_ms`)."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[kind] * 1e3
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": library_ms, "library_call": library_call}


# What a kernel's library counterpart calls (`library_call` in the kernels
# line): one product and one selection, as PyTorch offers them
LIB_MATMUL = "torch.matmul (the bf16 product alone)"
LIB_INT_MM = "torch._int_mm (the int8 product alone)"
LIB_K4 = "torch.matmul + masked_fill + torch.topk"
LIB_K3 = "torch._int_mm + row scales + masked_fill + torch.topk"
LIB_K3_Q1 = ("torch._int_mm (M padded to 32 rows) + row scales + "
             "masked_fill + torch.topk")
LIB_K9 = "torch._int_mm (M padded to 32 rows) + masked_fill + torch.topk"
LIB_IVF = "index_select of the probed tiles' rows + torch.matmul + torch.topk"
LIB_IVF_SEG = ("index_select of the probed tiles' rows + torch.matmul + "
               "torch.topk per 128-row segment")
LIB_IVF_SEG_I8 = ("index_select of the probed tiles' rows + torch._int_mm + "
                  "torch.topk per 128-row segment")
LIB_NONE_I4 = "none: no PyTorch call multiplies packed int4 nibbles"


def lib_topk(torch, scores_fn, notmask, k: int):
    """The library pair's selection: the scores `scores_fn()` makes, the
    masked-out rows at -inf, then torch.topk."""
    def run():
        s = scores_fn().masked_fill(notmask, float("-inf"))
        return torch.topk(s, k, dim=1)
    return run


def int_mm_rows(torch, q8, nq: int):
    """`q8`'s first nq rows zero-padded to 32 (torch._int_mm takes M > 16):
    the padded rows' scores are computed and dropped."""
    pad = torch.zeros((32, q8.shape[1]), dtype=torch.int8, device=q8.device)
    pad[:nq] = q8[:nq]
    return pad


def tc_ops(torch, nq: int, live: int, dim: int, dtype, bf16_planes: int = 1):
    """The tensor-core scans' operations at nq queries over `live` rows,
    and their type: float32 rows run 3xTF32 (three products of 2 nq live
    dim at the TF32 rate: K8, K4), bf16 rows `bf16_planes` products at the
    bf16 rate (K8 one; K4 three, the float32 query's bf16 planes), int8
    rows one."""
    ops = 2 * nq * live * dim
    if dtype == torch.float32:
        return 3 * ops, "tf32"
    if dtype == torch.bfloat16:
        return bf16_planes * ops, "bf16"
    return ops, "int8"


def launch_counts(scan) -> dict:
    """The launch counters, with each kernel's launches by shape under
    "shapes" ("Q=2048 k=14", from ops/scan.py::LAUNCH_SHAPES): rule 2
    weighs a launch at the shape it was made at."""
    return {**scan.LAUNCHES, "shapes": {
        name: {f"Q={q}" + ("" if k is None else f" k={k}"): n
               for (q, k), n in per.items()}
        for name, per in scan.LAUNCH_SHAPES.items()}}


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0].strip()


# The instantiations whose registers and spills phase 1 reports: the
# mainloop's (K1, K5, K10, P1), the one-query sweep's (K9, K7, K6 and K3
# at small Q), K6's tensor-core scan's, K8's tensor-core segment scan's,
# K4's tensor-core scan's and K2's split-row warp select's
PTXAS_KERNELS = ("tiles_kernel", "sweep_topk_kernel", "scan_i4_kernel",
                 "ivf_segmax_wgmma_kernel", "scan_topk_wgmma_kernel",
                 "warp_select_kernel")


def ptxas_report(log_path) -> str:
    """Registers and spill bytes of each PTXAS_KERNELS instantiation, from
    the kernel build's `-Xptxas -v` report (ops/_build.py keeps it beside
    the library), and the count of C7514 warnings (wgmma serialised)."""
    text = open(log_path).read()
    rows, name, spill = [], None, 0
    for line in text.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif "bytes spill stores" in line and name:
            parts = line.replace(",", "").split()
            spill = int(parts[parts.index("spill") - 2]) + int(
                parts[parts.index("loads") - 3])
        elif "Used" in line and "registers" in line and name:
            regs = int(line.split("Used")[1].split()[0])
            if any(k in name for k in PTXAS_KERNELS):
                rows.append((name, regs, spill))
            name = None
    filt = shutil.which("cu++filt") or "/usr/local/cuda/bin/cu++filt"
    names = [r[0] for r in rows]
    if os.path.exists(filt) and names:
        out = subprocess.run([filt, *names], capture_output=True, text=True,
                             timeout=60).stdout.splitlines()
        if len(out) == len(names):
            names = [n.replace("pv::<unnamed>::", "").replace("(int)", "")
                     .replace("wg::", "").replace("i4::", "").replace("sg::", "")
                     .replace("tk::", "").removeprefix("void ")
                     .split(">(")[0] + ">" for n in out]
    parts = [f"{n} {regs} registers / {sp} spill bytes"
             for n, (_, regs, sp) in zip(names, rows)]
    return (f"{'; '.join(parts)}; C7514 warnings "
            f"{text.count('C7514')}")


def cuda_ms(torch, fn, reps: int = 10) -> float:
    """Median per-call time of `fn` over `reps` runs, by CUDA events."""
    from picovdb_tpu_torch.probes import cuda_ms as timed

    return timed(fn, reps)


def host_us(torch, fn, n: int = 20, groups: int = 5) -> float:
    """The host's time a call of `fn` takes to enqueue its work: wall
    clock over `n` calls made back to back without synchronizing (the
    device works behind them), after a warm-up; the median of `groups`
    such groups, since other work on the host's cores lands in some."""
    fn()
    torch.cuda.synchronize()
    per = []
    for _ in range(groups):
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        per.append((time.perf_counter() - t0) * 1e6 / n)
        torch.cuda.synchronize()
    return float(np.median(per))


def device_split(torch, fn, reps: int = 20) -> str:
    """The device time a call of `fn` spends in each kernel, by kernel
    name, from torch.profiler's CUDA activity over `reps` calls after a
    warm-up; what is left of `cuda_ms`'s time a call is the host's
    enqueue and the gaps it leaves. "not measured" where the profiler
    records no device time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    per = {}
    for ev in prof.key_averages():
        us = getattr(ev, "device_time_total", 0) or 0
        if us > 0:
            head = ev.key.split("<")[0].replace("(anonymous namespace)", "")
            words = head.split("(")[0].split("::")[-1].split()
            name = words[-1] if words else ev.key[:40]
            per[name] = per.get(name, 0.0) + us / reps
    if not per:
        return "device split not measured"
    return ("device us a call (torch.profiler): "
            + ", ".join(f"{n} {us:.1f}" for n, us in sorted(per.items())))


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


def k1_on_mirror(torch, scan, dev, qf, qb, what: str):
    """K1 on a store's own bf16 mirror and mask (`dev`, a DeviceIndex) at
    the bf16 queries `qb` (`qf` their float32 form), held by
    `check_segmax_keys` to its plain version run over 131,072-row slices
    (the keys are per 128-row segment). Returns the keys, the plain keys
    and the max |dkey value|."""
    keys = scan.segmax_scan(qb, dev.vectors_lp, dev.active)
    step = 131_072
    keys_p = torch.cat([
        scan.segmax_scan_plain(qb, dev.vectors_lp[s:s + step],
                               dev.active[s:s + step])
        for s in range(0, dev.vectors_lp.shape[0], step)], 1)
    torch.cuda.synchronize()
    assert keys.shape == keys_p.shape, (keys.shape, keys_p.shape)
    err, _ = check_segmax_keys(torch, scan, keys, keys_p, qf, dev.vectors,
                               10, what)
    return keys, keys_p, err


def k2_timed(torch, scan, keys, k: int, split: bool = False) -> str:
    """K2 on a key slab at one of its launch shapes: its keys equal
    torch.topk's bit for bit and its columns are the tie rule's (equal
    keys: the larger column first), then its time beside torch.topk's (the
    library call, `library_ms`) and its bound (the slab read once, k keys
    and columns written); with `split`, also the device time a call by
    kernel (torch.profiler), beside which the rest of the call's time is
    the host's."""
    nq, c = keys.shape
    tk, tc = scan.topk_packed_keys(keys, k)
    rk = torch.topk(keys, k, dim=1)[0]
    vals, pos = torch.sort(keys.flip(1), dim=1, descending=True, stable=True)
    torch.cuda.synchronize()
    assert torch.equal(tk, rk), f"K2 keys differ from torch.topk at Q={nq}"
    assert torch.equal(tc.long(), c - 1 - pos[:, :k]), \
        f"K2 columns break the tie rule at Q={nq}"
    del vals, pos, rk
    ms = cuda_ms(torch, lambda: scan.topk_packed_keys(keys, k))
    lib = cuda_ms(torch, lambda: torch.topk(keys, k, dim=1))
    bound = entry(0.0, 0, 0, keys.numel() * 4 + nq * k * 8, 0,
                  "int8")["bound_ms"]
    line = (f"K2 Q={nq} k_sel={k} over {c} keys {ms:.4f} ms (torch.topk "
            f"{lib:.4f}, bound {bound:.4f}")
    if split:
        line += "; " + device_split(
            torch, lambda: scan.topk_packed_keys(keys, k))
    return line + ")"


def k9_template_ms(torch, scan, q8, v8, mask, k: int) -> float:
    """K9's template (`pv_scan_topk` kind 4), which its one-query sweep
    replaced on these shapes, run on the same inputs: held to the plain
    version bit for bit (it still serves Q > 16, k > 128 and other
    widths) and timed, the yardstick of the sweep's times. Its launches
    are not counted."""
    def run():
        return scan._template_launch(q8, v8, None, mask, k, scan._KIND_I8C,
                                     "fused_topk_i8c")

    vals, idx = run()
    ref = scan.fused_topk_i8c_plain(q8, v8, mask, k)
    torch.cuda.synchronize()
    assert torch.equal(vals, ref[0]) and torch.equal(idx, ref[1]), "template"
    return cuda_ms(torch, run)


def k6_timed(torch, scan, args, ref, reps: int):
    """K6 on `args` (int8 queries, packed plane, scales, mask, k_sel): the
    dispatch's result and each kernel that can take these operands,
    launched uncounted (the sweep's int4 kind at Q <= 16, the tensor-core
    scan, the template), held bit for bit to `ref`, the plain version's
    result. Returns the kernel the dispatch chose, each kernel's time and
    the dispatch's max |error| (0.0)."""
    q8, k = args[0], args[4]
    before = dict(scan.LAUNCHES)
    got = scan.fused_topk_i4(*args)
    served = next((name for name, key in K6_KERNELS.items()
                   if scan.LAUNCHES[key] > before[key]), "template")
    runs = {}
    if q8.shape[0] <= scan.SWEEP_Q_MAX and k <= scan.SWEEP_K_MAX:
        runs["sweep"] = lambda: scan._sweep_launch(*args, "fused_topk_i4")
    if k <= scan.I4_WGMMA_K_MAX:
        runs["tensor-core scan"] = lambda: scan._i4_wgmma_launch(*args)
    runs["template"] = lambda: scan._template_launch(*args, scan._KIND_I4)
    for name, out in [("dispatch", got)] + [(n, r()) for n, r in runs.items()]:
        torch.cuda.synchronize()
        assert torch.equal(out[0], ref[0]) and torch.equal(out[1], ref[1]), \
            f"K6's {name} differs from the plain version at Q={q8.shape[0]}"
    times = {name: cuda_ms(torch, run, reps) for name, run in runs.items()}
    return served, times, exact_err(torch, got[0], ref[0])


def timed_ms(torch, run, reps: int) -> float:
    """`cuda_ms` of `run`, or one run's time by CUDA events where that one
    run (after a warm-up) takes over SLOW_MS."""
    run()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    run()
    b.record()
    b.synchronize()
    one = a.elapsed_time(b)
    return one if one > SLOW_MS else cuda_ms(torch, run, reps)


def k3_timed(torch, scan, args, reps: int):
    """K3 on `args` (int8 queries, int8 rows, row scales, mask, k_sel):
    the dispatch's result and each kernel that can take these operands,
    launched uncounted (the sweep's row-scaled int8 kind at Q <= 16, k <=
    384; the tensor-core scan's int8 kind at k <= 384, any Q; the
    template), held bit for bit to the plain version's result (exact int32
    sums, one conversion, one multiply, ties to the lower row; over
    131,072-row slices, then the merge). Returns the kernel the dispatch
    chose and each kernel's time (`timed_ms`)."""
    q8, k = args[0], args[4]
    before = dict(scan.LAUNCHES)
    got = scan.fused_topk_i8(*args)
    served = next((name for name, key in K3_KERNELS.items()
                   if scan.LAUNCHES[key] > before[key]), "template")
    ref = scan.scan_topk_plain(*args, chunk=131_072)
    runs = {}
    if q8.shape[0] <= scan.SWEEP_Q_MAX and k <= scan.I8_SWEEP_K_MAX:
        runs["sweep"] = lambda: scan._sweep_launch(*args, "fused_topk_i8")
    if k <= scan.I8_WGMMA_K_MAX:
        runs["tensor-core scan"] = lambda: scan._i8_wgmma_launch(*args)
    runs["template"] = lambda: scan._template_launch(*args, scan._KIND_I8,
                                                     "scan_topk_i8")
    for name, out in [("dispatch", got)] + [(n, r()) for n, r in runs.items()]:
        torch.cuda.synchronize()
        assert torch.equal(out[0], ref[0]) and torch.equal(out[1], ref[1]), \
            f"K3's {name} differs from the plain version at Q={args[0].shape[0]}"
    return served, {name: timed_ms(torch, run, reps)
                    for name, run in runs.items()}


def k3_table(torch, scan, queries, v8, vs, mask, shapes, reps: int = 5) -> str:
    """K3 at each (Q, k_sel) of `shapes` over one int8 plane (`k3_timed`
    on the first Q of the normalized `queries`, quantized as the routes
    quantize them), each kernel's time beside the bound."""
    from picovdb_tpu_torch.ops.exact import normalize_on_device

    live, cap, dim = int(mask.sum()), mask.shape[0], v8.shape[1]
    parts = []
    for nq, k in shapes:
        q8, _ = scan.quantize_rows_i8(normalize_on_device(queries[:nq]))
        served, times = k3_timed(torch, scan, (q8, v8, vs, mask, k), reps)
        # the queries, the live rows and their scales, the mask, the keys
        bound = entry(0.0, 0, 0, nq * dim + live * (dim + 4) + cap
                      + nq * k * 8, 2 * nq * live * dim, "int8")["bound_ms"]
        parts.append(f"Q={nq} k_sel={k} ({served}): " + ", ".join(
            f"{name} {ms:.4f}" for name, ms in times.items())
            + f" ms, bound {bound:.4f}")
    return "; ".join(parts)


def k3_launches_ok(scan, counts) -> bool:
    """Whether a path's K3 launches at Q > I8_SWEEP_Q_MAX and k_sel <=
    I8_WGMMA_K_MAX (its `launch_counts` shapes, "Q=.. k=..") went through
    the tensor-core scan, and only those (the path's rows are of whole 16
    bytes)."""
    want = 0
    for shape, n in counts["shapes"].get("scan_topk_i8", {}).items():
        q, k = (int(part.split("=")[1]) for part in shape.split())
        want += n if (q > scan.I8_SWEEP_Q_MAX
                      and k <= scan.I8_WGMMA_K_MAX) else 0
    return counts["scan_topk_i8_wgmma"] == want


@contextlib.contextmanager
def uncounted(scan):
    """Launches made inside (timing a path's calls) are not the path's:
    the launch counters are restored on the way out."""
    launches = dict(scan.LAUNCHES)
    shapes = {name: dict(per) for name, per in scan.LAUNCH_SHAPES.items()}
    try:
        yield
    finally:
        scan.LAUNCHES.update(launches)
        scan.LAUNCH_SHAPES.clear()
        scan.LAUNCH_SHAPES.update(shapes)


def q64_latency(torch, db, q64, reps: int = 10):
    """The int8 store's Q = 64 host-rescored batches through the public
    API, by CUDA events around the call (median of `reps`): a
    `query_columnar` of 64 host queries and a `query` of them under the
    `{"tag": 3}` filter. Returns (columnar ms, filtered ms)."""
    col = cuda_ms(torch, lambda: db.query_columnar(q64, top_k=10), reps)
    dbg = db.last_query_debug()
    assert dbg["strategy"] == "i8stor_fused_exact" and dbg["rescore"] == "host"
    filt = cuda_ms(torch, lambda: db.query(q64, top_k=10, where={"tag": 3}),
                   reps)
    assert db.last_query_debug()["strategy"] == "i8stor_fused_exact"
    return col, filt


def k4_check(torch, got, ref, mask, k: int, what: str) -> float:
    """K4's (vals, idx) against the plain version's top-(k + 1) `ref`: the
    same -inf slots, scores within TOL_SCORE, the same ids wherever the
    k-th / (k + 1)-th gap exceeds TOL_GAP, only masked-in rows. Returns the
    max |dscore|."""
    vals, idx = got
    fin = torch.isfinite(vals)
    assert torch.equal(fin, torch.isfinite(ref[0][:, :k])), f"{what}: -inf"
    err = (float((vals[fin] - ref[0][:, :k][fin]).abs().max())
           if bool(fin.any()) else 0.0)
    assert err <= TOL_SCORE, f"{what} scores differ by {err}"
    assert ids_agree(torch, idx, ref[1], ref[0], k) == 0.0, what
    assert bool(mask[idx[fin].long()].all()), f"{what} returned masked rows"
    return err


def k4_timed(torch, scan, q, rows, mask, k: int, reps: int):
    """K4 on float32 queries `q` over `rows` (float32 or bf16): the
    dispatch's result, and each kernel that can take these operands
    launched uncounted (the tensor-core scan at k <= 128, the template),
    held to the plain version (run over 131,072-row slices) by `k4_check`
    and timed. Returns the kernel the dispatch chose, each kernel's time
    and the max |dscore|."""
    before = scan.LAUNCHES["scan_topk_wgmma"]
    got = scan.fused_topk(q, rows, mask, k)
    served = ("tensor-core scan" if scan.LAUNCHES["scan_topk_wgmma"] > before
              else "template")
    ref = scan.scan_topk_plain(q, rows, None, mask, k + 1, chunk=131_072)
    kind = scan._KIND_F32 if rows.dtype == torch.float32 else scan._KIND_BF16
    runs = {}
    if k <= scan.TOPK_WGMMA_K_MAX:
        runs["tensor-core scan"] = lambda: scan._topk_wgmma_launch(q, rows,
                                                                   mask, k)
    runs["template"] = lambda: scan._template_launch(q, rows, None, mask, k,
                                                     kind)
    what = f"K4 {rows.dtype} Q={q.shape[0]} k_sel={k}"
    err = k4_check(torch, got, ref, mask, k, f"{what} (dispatch)")
    for name, run in runs.items():
        out = run()
        torch.cuda.synchronize()
        err = max(err, k4_check(torch, out, ref, mask, k, f"{what} ({name})"))
    return served, {n: cuda_ms(torch, r, reps) for n, r in runs.items()}, err


def k4_table(torch, scan, queries, rows, mask, shapes, reps: int = 3):
    """K4 at each (Q, k_sel) of `shapes` over one corpus (`k4_timed` on the
    first Q of the normalized `queries`), each kernel's time beside the
    bound (the live rows' bytes, or the tensor-core scan's three
    products). Returns the line and the max |dscore|."""
    from picovdb_tpu_torch.ops.exact import normalize_on_device

    live, cap, dim = int(mask.sum()), mask.shape[0], rows.shape[1]
    es = rows.element_size()
    parts, errs = [], [0.0]
    for nq, k in shapes:
        q = normalize_on_device(queries[:nq])
        served, times, err = k4_timed(torch, scan, q, rows, mask, k, reps)
        errs.append(err)
        bound = entry(0.0, 0, 0, nq * dim * 4 + live * dim * es + cap
                      + nq * k * 8, *tc_ops(torch, nq, live, dim, rows.dtype,
                                            3))["bound_ms"]
        parts.append(f"Q={nq} k_sel={k} ({served}): " + ", ".join(
            f"{name} {ms:.4f}" for name, ms in times.items())
            + f" ms, bound {bound:.4f}")
    return "; ".join(parts), max(errs)


def k4_launches_ok(scan, counts) -> bool:
    """Whether a path's K4 launches at Q >= TOPK_WGMMA_Q_MIN and k_sel <=
    128 (its `launch_counts` shapes, "Q=.. k=..") went through the
    tensor-core scan, and only those (the paths' rows are of whole 16
    bytes)."""
    want = 0
    for shape, n in counts["shapes"].get("scan_topk", {}).items():
        q, k = (int(part.split("=")[1]) for part in shape.split())
        want += n if q >= scan.TOPK_WGMMA_Q_MIN and k <= 128 else 0
    return counts["scan_topk_wgmma"] == want


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

    def check_k1(keys, keys_p, qf, rows, what):
        return check_segmax_keys(torch, scan, keys, keys_p, qf, rows, k, what)

    err1, err2 = check_k1(keys, keys_p, q, corpus, "K1 (wgmma)")
    nq = q.shape[0]
    slab = nq * 2 * (cap // scan.SEG) * 4
    rec["segmax_scan"] = entry(
        err1, cuda_ms(torch, lambda: scan.segmax_scan(qb, lp, mask)),
        cuda_ms(torch, lambda: scan.segmax_scan_plain(qb, lp, mask)),
        nq * dim * 2 + live * dim * 2 + cap + slab, 2 * nq * live * dim, "bf16",
        cuda_ms(torch, lambda: torch.matmul(qb, lp.T)), LIB_MATMUL)
    rec["topk_packed_keys"] = entry(
        err2, cuda_ms(torch, lambda: scan.topk_packed_keys(keys, k + 6)),
        cuda_ms(torch, lambda: scan.topk_packed_keys_plain(keys, k + 6)),
        slab + nq * (k + 6) * 8, 0, "int8",
        cuda_ms(torch, lambda: torch.topk(keys, k + 6, dim=1)), "torch.topk")
    del keys, keys_p
    log(f"phase 2: K1 segmax_scan (TMA + wgmma) + K2 topk_packed_keys agree "
        f"at Q=2048 k={k} cap={cap} (K1 max |dkey value| {err1:.3g}, K2 "
        f"exact, rescored rows = plain outside the gap; K1 "
        f"{rec['segmax_scan']['ms']:.4f} ms, plain "
        f"{rec['segmax_scan']['plain_ms']:.4f} ms, bound "
        f"{rec['segmax_scan']['bound_ms']:.4f} ms)")

    # K1 at widths TMA cannot read: dim 1020 (rows of 2040 bytes) on the
    # mainloop fed by cp.async (8-byte pieces), and dim 1019 (rows of 2038
    # bytes) on the mainloop fed by its realigning producer: the same
    # checks, a row each in the record, and beside each (uncounted, held to
    # the same plain version) the wmma tile that served both widths before
    # and the other producer that could take the width (the realigning one
    # at dim 1020: the crossover behind cpasync_ready)
    k1w = {}
    for d2, key, name in ((dim - 4, "segmax_cpasync", "segmax_scan_cpasync"),
                          (ODD_DIM, "segmax_realign", "segmax_scan_realign")):
        q2 = normalize_on_device(q[:, :d2])
        c2 = normalize_on_device(corpus[:, :d2])
        q2b, lp2 = q2.to(torch.bfloat16), c2.to(torch.bfloat16)
        before = dict(scan.LAUNCHES)
        keys = scan.segmax_scan(q2b, lp2, mask)
        for k1 in ("segmax", "segmax_wgmma", "segmax_cpasync",
                   "segmax_realign"):
            assert (scan.LAUNCHES[k1] - before[k1]
                    == (k1 in ("segmax", key))), f"dim {d2}: {k1}"
        keys_p = scan.segmax_scan_plain(q2b, lp2, mask)
        torch.cuda.synchronize()
        err_w, _ = check_k1(keys, keys_p, q2, c2, f"K1 ({name}, dim {d2})")
        rec[name] = entry(
            err_w, cuda_ms(torch, lambda: scan.segmax_scan(q2b, lp2, mask)),
            cuda_ms(torch, lambda: scan.segmax_scan_plain(q2b, lp2, mask)),
            nq * d2 * 2 + live * d2 * 2 + cap + slab, 2 * nq * live * d2,
            "bf16", cuda_ms(torch, lambda: torch.matmul(q2b, lp2.T)),
            LIB_MATMUL)
        others = ["pv_segmax_scan"] + (["pv_segmax_scan_realign"]
                                       if key == "segmax_cpasync" else [])
        for other in others:
            keys = scan._segmax_launch(q2b, lp2, mask, other)
            torch.cuda.synchronize()
            check_k1(keys, keys_p, q2, c2, f"K1 ({other}, dim {d2})")
            k1w[d2, other] = cuda_ms(torch, lambda: scan._segmax_launch(
                q2b, lp2, mask, other))
        del keys, keys_p, q2, c2, q2b, lp2
    cp, ra = rec["segmax_scan_cpasync"], rec["segmax_scan_realign"]
    log(f"phase 2: K1 at widths TMA cannot read agrees at Q=2048 cap={cap}: "
        f"dim {dim - 4} on the mainloop fed by cp.async (max |dkey value| "
        f"{cp['max_abs_err']:.3g}; {cp['ms']:.4f} ms, bound "
        f"{cp['bound_ms']:.4f} ms; the realigning producer "
        f"{k1w[dim - 4, 'pv_segmax_scan_realign']:.4f} ms and the wmma tile "
        f"{k1w[dim - 4, 'pv_segmax_scan']:.4f} ms, same checks; plain "
        f"{cp['plain_ms']:.4f} ms), dim {ODD_DIM} on the mainloop fed by the "
        f"realigning producer (max |dkey value| {ra['max_abs_err']:.3g}; "
        f"{ra['ms']:.4f} ms, bound {ra['bound_ms']:.4f} ms; the wmma tile it "
        f"replaced {k1w[ODD_DIM, 'pv_segmax_scan']:.4f} ms, same checks; "
        f"plain {ra['plain_ms']:.4f} ms)")

    # K5 over the int8 rows at Q = 2048, k = 10 (segmax_i8stor: k_sel 16)
    # on the int8 mainloop. The int32 sums are exact and each key is one
    # float32 conversion and one multiply, so the keys must agree bit for
    # bit. The mma.sync tile it replaced at these widths is held to the
    # same keys and timed on the same inputs (uncounted).
    q8, _ = scan.quantize_rows_i8(q)
    before = scan.LAUNCHES["segmax_i8_wgmma"]
    keys = scan.segmax_scan_i8(q8, v8, vs, mask)
    assert scan.LAUNCHES["segmax_i8_wgmma"] == before + 1, "K5 missed wgmma"
    keys_p = scan.segmax_scan_i8_plain(q8, v8, vs, mask)
    keys_t = scan._segmax_i8_launch(q8, v8, vs, mask, False)
    torch.cuda.synchronize()
    assert torch.equal(keys, keys_p), "segmax_scan_i8 keys differ"
    assert torch.equal(keys_t, keys_p), "K5's mma.sync tile keys differ"
    err5 = exact_err(torch, keys, keys_p)

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
        nq * dim + live * (dim + 4) + cap + slab, 2 * nq * live * dim, "int8",
        cuda_ms(torch, lambda: torch._int_mm(q8, v8.T)), LIB_INT_MM)
    tile5_ms = cuda_ms(torch, lambda: scan._segmax_i8_launch(q8, v8, vs, mask,
                                                             False))
    del keys, keys_p, keys_t
    k5 = rec["segmax_scan_i8"]
    log(f"phase 2: K5 segmax_scan_i8 (int8 TMA + wgmma) keys = plain bit for "
        f"bit at Q=2048 k={k} cap={cap} ({k5['ms']:.4f} ms, bound "
        f"{k5['bound_ms']:.4f} ms; the mma.sync tile it replaced "
        f"{tile5_ms:.4f} ms, same keys; plain {k5['plain_ms']:.4f} ms)")

    # K10 over the column-scaled int8 mirror at Q = 2048 (segmax_i8c: the
    # same keys route through K2 at k_sel = k + 8) on the int8 mainloop:
    # integer keys, so bit for bit the plain version's. The mma.sync tile
    # it replaced at these widths is held to the same keys and timed on the
    # same inputs (uncounted).
    v8c, cs = scan.quantize_cols_i8(corpus)
    q8c = scan.fold_queries_i8(q, cs)
    before = scan.LAUNCHES["segmax_i8c_wgmma"]
    keys = scan.segmax_scan_i8c(q8c, v8c, mask)
    assert scan.LAUNCHES["segmax_i8c_wgmma"] == before + 1, "K10 missed wgmma"
    keys_p = scan.segmax_scan_i8c_plain(q8c, v8c, mask)
    keys_t = scan._segmax_i8c_launch(q8c, v8c, mask, False)
    torch.cuda.synchronize()
    assert torch.equal(keys, keys_p), "segmax_scan_i8c keys differ"
    assert torch.equal(keys_t, keys_p), "K10's mma.sync tile keys differ"
    err10 = exact_err(torch, keys, keys_p)
    tk, ti = scan.topk_packed_keys(keys, k + 8)
    assert torch.equal(tk, scan.topk_packed_keys_plain(keys, k + 8)[0])
    rec["segmax_scan_i8c"] = entry(
        err10, cuda_ms(torch, lambda: scan.segmax_scan_i8c(q8c, v8c, mask)),
        cuda_ms(torch, lambda: scan.segmax_scan_i8c_plain(q8c, v8c, mask)),
        nq * dim + live * dim + cap + slab, 2 * nq * live * dim, "int8",
        cuda_ms(torch, lambda: torch._int_mm(q8c, v8c.T)), LIB_INT_MM)
    tile_ms = cuda_ms(torch, lambda: scan._segmax_i8c_launch(q8c, v8c, mask,
                                                             False))
    del keys, keys_p, keys_t
    k10 = rec["segmax_scan_i8c"]
    log(f"phase 2: K10 segmax_scan_i8c (int8 TMA + wgmma) keys = plain bit "
        f"for bit at Q=2048 cap={cap} ({k10['ms']:.4f} ms, bound "
        f"{k10['bound_ms']:.4f} ms; the mma.sync tile it replaced "
        f"{tile_ms:.4f} ms, same keys; plain {k10['plain_ms']:.4f} ms; K5 "
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
        cuda_ms(torch, lambda: torch.matmul(qb, lp.T)), LIB_MATMUL)
    rec["dot_rowmax_i8"] = entry(
        err_p1i, cuda_ms(torch, lambda: probes.dot_rowmax(q8c, v8c)),
        cuda_ms(torch, lambda: probes.dot_rowmax_plain(q8c, v8c)),
        nq * dim + cap * dim + nq * 4, 2 * nq * cap * dim, "int8",
        cuda_ms(torch, lambda: torch._int_mm(q8c, v8c.T)), LIB_INT_MM)
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

    # K3 at Q = 1, 8, 16, k = 10 (small-batch route: k_sel = k + 4): the
    # dispatch bit for bit the plain version, and the sweep and the
    # template it replaced held to it and timed on the same inputs
    errs, k3, pms = [], {}, []
    for nq in (1, 8, 16):
        qf = normalize_on_device(
            torch.from_numpy(rng.standard_normal((nq, dim), dtype=np.float32))
            .to(device))
        q8, _ = scan.quantize_rows_i8(qf)
        errs.append(check_scan("fused_topk_i8", q8, v8, vs, mask, 14, qf))
        k3[nq] = k3_timed(torch, scan, (q8, v8, vs, mask, 14), reps=10)
        pms.append(cuda_ms(torch, lambda: scan.scan_topk_plain(q8, v8, vs, mask, 14)))
        if nq == 1:
            q81 = int_mm_rows(torch, q8, 1)
            lib3 = cuda_ms(torch, lib_topk(
                torch, lambda: torch._int_mm(q81, v8.T)[:1].float() * vs,
                ~mask, 14))
            ms1 = cuda_ms(torch, lambda: scan.fused_topk_i8(q8, v8, vs, mask, 14))
            split3 = device_split(torch, lambda: scan.fused_topk_i8(
                q8, v8, vs, mask, 14))
    assert k3[1][0] == "sweep", k3
    rec["fused_topk_i8"] = entry(max(errs), ms1, pms[0],
                                 dim + live * (dim + 4) + cap + 14 * 8,
                                 2 * live * dim, "int8", lib3, LIB_K3_Q1)
    # K3's tensor-core scan at the host-rescore band's batch (Q = 64,
    # k_sel 142), the small-batch band's k_sel 14, and a 2048-query batch
    # (the first queries of `q`: no new draw): the dispatch, the scan and
    # the template bit for bit the plain version, each timed
    k3b = {}
    q8b, _ = scan.quantize_rows_i8(q)
    for nq3, ksel in ((64, 142), (64, 14), (2048, 14)):
        args3 = (q8b[:nq3].contiguous(), v8, vs, mask, ksel)
        k3b[nq3, ksel] = k3_timed(torch, scan, args3, reps=5)
        assert k3b[nq3, ksel][0] == "tensor-core scan", k3b
        if (nq3, ksel) == (64, 142):
            pms3 = cuda_ms(torch, lambda: scan.scan_topk_plain(*args3), reps=5)
            lib3b = cuda_ms(torch, lib_topk(
                torch, lambda: torch._int_mm(args3[0], v8.T).float() * vs,
                ~mask, 142))
    rec["fused_topk_i8_wgmma"] = entry(
        0.0, k3b[64, 142][1]["tensor-core scan"], pms3,
        64 * dim + live * (dim + 4) + cap + 64 * 142 * 8,
        2 * 64 * live * dim, "int8", lib3b, LIB_K3)
    del q8b
    log(f"phase 2: K3 fused_topk_i8 = plain bit for bit at Q=1,8,16 "
        f"k_sel=14 (bound {rec['fused_topk_i8']['bound_ms']:.4f} ms at Q=1; "
        f"the kernel the dispatch chose, then each kernel's ms): "
        + "; ".join(f"Q={n} {served}: " + ", ".join(
            f"{name} {t:.4f}" for name, t in times.items())
            for n, (served, times) in k3.items())
        + f"; plain {', '.join(f'{m:.4f}' for m in pms)}; at Q=1 {split3}")
    log(f"phase 2: K3 fused_topk_i8 (tensor-core scan) = plain bit for bit "
        f"(bound {rec['fused_topk_i8_wgmma']['bound_ms']:.4f} ms at Q=64 "
        f"k_sel=142; the kernel the dispatch chose, then each kernel's ms): "
        + "; ".join(f"Q={n} k_sel={kk} {served}: " + ", ".join(
            f"{name} {t:.4f}" for name, t in times.items())
            for (n, kk), (served, times) in k3b.items())
        + f"; plain at Q=64 k_sel=142 {pms3:.4f}")

    # K4 at Q = 64 and 256, k_sel 14 and 36 (the batch routes' guard bands
    # at k = 10 and 32), over the float32 rows and the bf16 mirror, and at
    # Q = 64, k_sel 36 over the mirror under a 30 % filter: the dispatch,
    # the tensor-core scan and the template it replaced held to the plain
    # version and timed on the same inputs (`k4_timed`). The 64 queries and
    # the filter are drawn from `rng` as before the tensor-core scan, so
    # the later phases' data stay what they were; the other 192 queries of
    # Q = 256 come from a generator of their own.
    q64 = normalize_on_device(
        torch.from_numpy(rng.standard_normal((64, dim), dtype=np.float32))
        .to(device))
    fmask = mask & torch.from_numpy(rng.random(cap) < 0.3).to(device)
    q256 = torch.cat([q64, normalize_on_device(torch.from_numpy(
        np.random.default_rng(SEED + 2).standard_normal((192, dim),
                                                        dtype=np.float32))
        .to(device))])
    k4, errs = {}, []
    for rows in (corpus, lp):
        for nq4 in (64, 256):
            for ksel in (14, 36):
                served, times, err = k4_timed(torch, scan, q256[:nq4], rows,
                                              mask, ksel, reps=5)
                assert served == ("tensor-core scan" if nq4 >=
                                  scan.TOPK_WGMMA_Q_MIN else "template")
                k4[str(rows.dtype).split(".")[1], nq4, ksel] = times
                errs.append(err)
    served, times, err = k4_timed(torch, scan, q64, lp, fmask, 36, reps=5)
    k4["bfloat16 filtered", 64, 36] = times
    errs.append(err)
    pms_bf = cuda_ms(torch, lambda: scan.scan_topk_plain(q64, lp, None, mask, 36))
    # K4's template at k_sel = 1024 (the exact retry's widest)
    e_f32 = check_scan("fused_topk f32", q64[:16], corpus, None, mask, 1024,
                       q64[:16])
    ms_f32 = cuda_ms(torch, lambda: scan.fused_topk(q64[:16], corpus, mask, 1024))
    pms_f32 = cuda_ms(
        torch, lambda: scan.scan_topk_plain(q64[:16], corpus, None, mask, 1024))
    # the library pair at the row's shape (bf16 rows: the bf16 product of
    # the bf16-rounded queries) and over the float32 rows at Q = 64, k_sel
    # 36 and Q = 1, k_sel 14 (a GEMV), each beside the kernel's time
    notm = ~mask
    q64b = q64.to(torch.bfloat16)
    lib4 = cuda_ms(torch, lib_topk(torch, lambda: torch.matmul(q64b, lp.T),
                                   notm, 36))
    q1 = q64[:1].contiguous()
    lib4_f32 = {
        "Q=64 k_sel=36": {
            "ms": k4["float32", 64, 36]["tensor-core scan"],
            "library_ms": cuda_ms(torch, lib_topk(
                torch, lambda: torch.matmul(q64, corpus.T), notm, 36))},
        "Q=1 k_sel=14": {
            "ms": cuda_ms(torch, lambda: scan.fused_topk(q1, corpus, mask, 14)),
            "library_ms": cuda_ms(torch, lib_topk(
                torch, lambda: torch.matmul(q1, corpus.T), notm, 14))},
        "Q=16 k_sel=1024 (the template)": {
            "ms": ms_f32, "library_ms": cuda_ms(torch, lib_topk(
                torch, lambda: torch.matmul(q64[:16], corpus.T), notm,
                1024))}}
    rec["fused_topk"] = entry(
        max(errs + [e_f32]), k4["bfloat16", 64, 36]["tensor-core scan"], pms_bf,
        64 * dim * 4 + live * dim * 2 + cap + 64 * 36 * 8,
        *tc_ops(torch, 64, live, dim, torch.bfloat16, 3), lib4, LIB_K4)
    rec["fused_topk"]["library_f32"] = lib4_f32
    bounds4 = {
        (dt, nq4): entry(0.0, 0, 0, nq4 * dim * 4 + live * dim * es + cap
                         + nq4 * 36 * 8, *tc_ops(torch, nq4, live, dim, dtype,
                                                 3))["bound_ms"]
        for dt, dtype, es in (("float32", torch.float32, 4),
                              ("bfloat16", torch.bfloat16, 2))
        for nq4 in (64, 256)}
    log(f"phase 2: K4 fused_topk (tensor-core scan) agrees within "
        f"{max(errs):.3g} (limit {TOL_SCORE:g}), ids = plain outside the gap "
        f"(each kernel's ms): " + "; ".join(
            f"{dt} Q={nq4} k_sel={ksel}: " + ", ".join(
                f"{name} {t:.4f}" for name, t in times.items())
            + (f" (bound {bounds4[dt, nq4]:.4f} at k_sel 36)"
               if (dt, nq4) in bounds4 else "")
            for (dt, nq4, ksel), times in k4.items())
        + f"; plain bf16 Q=64 k_sel=36 {pms_bf:.4f}; the template at f32 Q=16 "
        f"k_sel=1024 {ms_f32:.4f} ms (plain {pms_f32:.4f}); {LIB_K4}: bf16 "
        f"Q=64 k_sel=36 {lib4:.4f}, " + ", ".join(
            f"float32 {shape} {t['library_ms']:.4f} (K4 {t['ms']:.4f})"
            for shape, t in lib4_f32.items()))

    # K6 over the packed int4 rows at k_sel = 14 (i4stor_fused at k = 10):
    # Q = 1, 8, 16 and Q = 2048 (a query_columnar batch), the dispatch and
    # each kernel that can take the shape (the one-query sweep's int4 kind,
    # the tensor-core scan, the template) bit for bit the plain version
    # (exact int32 sums, one conversion and one multiply, ties to the
    # lower row) and timed on the same inputs; and Q = 16, k_sel = 1024
    # (the widest the template serves)
    v4, vs4 = scan.quantize_rows_i4(corpus)
    errs, k6, pms = [], {}, []
    for nq in (1, 8, 16, 2048):
        qf = q if nq == 2048 else normalize_on_device(
            torch.from_numpy(rng.standard_normal((nq, dim), dtype=np.float32))
            .to(device))
        q8, _ = scan.quantize_rows_i8(qf)
        args = (q8, v4, vs4, mask, 14)
        ref = scan.scan_topk_plain(*args, int4=True)
        k6[nq] = k6_timed(torch, scan, args, ref, reps=10 if nq <= 16 else 5)
        assert bool(mask[ref[1].long()].all()), "K6 returned masked rows"
        errs.append(k6[nq][2])
        pms.append(cuda_ms(torch, lambda: scan.scan_topk_plain(
            *args, int4=True), reps=10 if nq <= 16 else 5))
        if nq == 1:
            split6 = device_split(torch, lambda: scan.fused_topk_i4(*args))
    assert k6[1][0] == "sweep" and k6[2048][0] == "tensor-core scan", k6
    q8, _ = scan.quantize_rows_i8(q64[:16])
    errs.append(check_scan("fused_topk_i4 wide", q8, v4, vs4, mask, 1024,
                           q64[:16], int4=True))
    ms_w = cuda_ms(torch, lambda: scan.fused_topk_i4(q8, v4, vs4, mask, 1024))
    pms_w = cuda_ms(torch, lambda: scan.scan_topk_plain(
        q8, v4, vs4, mask, 1024, int4=True))
    bound_w = entry(0.0, 0, 0, 16 * dim + live * (dim // 2 + 4) + cap
                    + 16 * 1024 * 8, 2 * 16 * live * dim, "int8")["bound_ms"]
    rec["fused_topk_i4"] = entry(max(errs), k6[1][1]["sweep"], pms[0],
                                 dim + live * (dim // 2 + 4) + cap + 14 * 8,
                                 2 * live * dim, "int8", None, LIB_NONE_I4)
    nq = 2048
    rec["fused_topk_i4_wgmma"] = entry(
        max(errs), k6[nq][1]["tensor-core scan"], pms[3],
        nq * dim + live * (dim // 2 + 4) + cap + nq * 14 * 8,
        2 * nq * live * dim, "int8", None, LIB_NONE_I4)
    log(f"phase 2: K6 fused_topk_i4 = plain bit for bit at k_sel=14 "
        f"(bound {rec['fused_topk_i4']['bound_ms']:.4f} ms at Q=1, "
        f"{rec['fused_topk_i4_wgmma']['bound_ms']:.4f} at Q=2048; the kernel "
        f"the dispatch chose, then each kernel's ms): "
        + "; ".join(f"Q={n} {served}: " + ", ".join(
            f"{name} {t:.4f}" for name, t in times.items())
            for n, (served, times, _) in k6.items())
        + f"; plain {', '.join(f'{m:.4f}' for m in pms)}; template at Q=16 "
        f"k_sel=1024 {ms_w:.4f} ms (bound {bound_w:.4f}, plain {pms_w:.4f}); "
        f"at Q=1 {split6}")

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
        if nq1 == 1:
            split9 = device_split(torch, lambda: scan.fused_topk_i8c(
                q8, v8c, mask, 16))
            q9 = int_mm_rows(torch, q8, 1)
            lib9 = cuda_ms(torch, lib_topk(
                torch, lambda: torch._int_mm(q9, v8c.T)[:1].float(), ~mask,
                16))
    rec["fused_topk_i8c"] = entry(max(errs), ms[0], pms[0],
                                  dim + live * dim + cap + 16 * 8,
                                  2 * live * dim, "int8", lib9, LIB_K9)
    log(f"phase 2: K9 fused_topk_i8c (one-query sweep) = plain bit for bit "
        f"at Q=1,8,16 k_sel=16 (ms {', '.join(f'{m:.4f}' for m in ms)}; "
        f"bound {rec['fused_topk_i8c']['bound_ms']:.4f} ms at Q=1; the "
        f"template it replaced {', '.join(f'{m:.4f}' for m in tms)}; plain "
        f"{', '.join(f'{m:.4f}' for m in pms)}; K3 at Q=1 "
        f"{rec['fused_topk_i8']['ms']:.4f}; at Q=1 {split9})")
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
    # bands at k = 10) on its one-query sweep, and Q = 16, k_sel 544 (the
    # int4 host-rescore band) on its template. Where the sweep serves, the
    # template it replaced is held to the same plain result and timed on
    # the same inputs (uncounted).
    def check_k7(kind, vals, idx, rv, ri, k, what):
        assert torch.equal(torch.isneginf(vals), torch.isneginf(rv[:, :k])), what
        if kind == "i8c":  # integer scores, ties to the lower row
            assert torch.equal(vals, rv[:, :k]) and torch.equal(idx, ri[:, :k]), what
            err = 0.0
        else:
            fin = torch.isfinite(vals)
            err = float((vals[fin] - rv[:, :k][fin]).abs().max())
            assert err <= TOL_SCORE, f"{what} scores differ by {err}"
            assert ids_agree(torch, idx, ri, rv, k) == 0.0, what
        got = idx[torch.isfinite(vals)].long()
        assert bool((mask & live_rows)[got].all()), f"{what}: dead row"
        return err

    errs, lines, first = [], [], {}
    for kind in kinds:
        for nq, k in ((1, 14), (16, 14), (1, 32), (16, 32), (16, 544)):
            qf = normalize_on_device(torch.from_numpy(
                rng.standard_normal((nq, dim), dtype=np.float32)).to(device))
            qs, vv = scan_inputs(kind, qf), kinds[kind]
            sweep = k <= scan.SWEEP_K_MAX
            before = scan.LAUNCHES["ivf_scan_topk_sweep"]
            vals, idx = ivf.ivf_scan_topk(qs, vv, mask, hot, n_hot, k)
            assert scan.LAUNCHES["ivf_scan_topk_sweep"] == before + sweep, \
                f"K7 {kind} Q={nq} k_sel={k}: sweep {sweep} expected"
            rv, ri = ivf.ivf_scan_topk_plain(qs, vv, mask, hot, n_hot, k + 1)
            torch.cuda.synchronize()
            errs.append(check_k7(kind, vals, idx, rv, ri, k, f"K7 {kind}"))
            ms = cuda_ms(torch, lambda: ivf.ivf_scan_topk(qs, vv, mask, hot,
                                                          n_hot, k))
            pms = cuda_ms(torch, lambda: ivf.ivf_scan_topk_plain(
                qs, vv, mask, hot, n_hot, k))
            line = f"{kind} Q={nq} k_sel={k} {ms:.4f} ms"
            if (nq, k) == (1, 14):
                line += " [" + device_split(torch, lambda: ivf.ivf_scan_topk(
                    qs, vv, mask, hot, n_hot, k)) + "]"
            if sweep:
                def tmpl():
                    return ivf._ivf_template_launch(qs, vv, mask, hot, n_hot,
                                                    k, bn)
                tv, ti = tmpl()
                torch.cuda.synchronize()
                check_k7(kind, tv, ti, rv, ri, k, f"K7's template {kind}")
                line += f" (template {cuda_ms(torch, tmpl):.4f})"
            else:
                line += " (template)"
            lines.append(f"{line}, plain {pms:.4f}")
            first.setdefault(kind, (ms, pms))
            if kind == "f32" and (nq, k) == (1, 14):
                q7 = qs  # the row's query, for its library pair
    hot_live = int((mask & live_rows).sum())  # the live hot tiles' live rows
    # the probed tiles' rows, as the library pair gathers them
    hot_idx = (hot[:40].long()[:, None] * bn
               + torch.arange(bn, device=device)).reshape(-1)
    hot_out = ~mask[hot_idx]

    def k7_entry(kind, err, lib=None):  # the Q = 1, k_sel 14 call of one kind
        es = kinds[kind].element_size()
        return entry(err, *first[kind],
                     dim * es + hot_live * dim * es + cap + 14 * 8,
                     2 * hot_live * dim, {"f32": "f32", "bf16": "bf16",
                                          "i8c": "int8"}[kind], lib, LIB_IVF)

    rec["ivf_scan_topk"] = k7_entry("f32", max(errs), cuda_ms(torch, lib_topk(
        torch, lambda: torch.matmul(q7, post.index_select(0, hot_idx).T),
        hot_out, 14)))
    bounds = ", ".join(f"{kind} {k7_entry(kind, 0.0)['bound_ms']:.4f}"
                       for kind in kinds)
    log(f"phase 2: K7 ivf_scan_topk agrees over {cap} x {dim} postings, 40 "
        f"of 64 hot tiles live (bound ms at Q=1 k_sel=14: {bounds}): "
        + "; ".join(lines))

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
    errs, lines, first = {}, [], {}
    for kind in kinds:
        for per_seg in (4, 8):
            qs, vv = scan_inputs(kind, q64), kinds[kind]
            before = scan.LAUNCHES["ivf_segmax_wgmma"]
            keys = ivf.ivf_segmax_scan(qs, vv, mask, hot, n_hot, per_seg)
            assert scan.LAUNCHES["ivf_segmax_wgmma"] == before + 1, \
                f"K8 {kind} missed the tensor-core segment scan"
            ref = ivf.ivf_segmax_scan_plain(qs, vv, mask, hot, n_hot, per_seg)
            torch.cuda.synchronize()
            live = keys != scan.KEY_MIN
            assert not bool(live[:, 40 * per_seg * ns:].any()), "K8 dead step"
            err = check_k8_keys(torch, scan, keys, ref, kind == "i8c",
                                f"K8 {kind} per_seg={per_seg}")
            errs[kind] = max(errs.get(kind, 0.0), err)

            def first_kernel():  # the kernel the segment scan replaced
                return ivf._ivf_segmax_launch(qs, vv, mask, hot, n_hot,
                                              per_seg, bn, False)

            check_k8_keys(torch, scan, first_kernel(), ref, kind == "i8c",
                          f"K8's first kernel {kind} per_seg={per_seg}")
            ms = cuda_ms(torch, lambda: ivf.ivf_segmax_scan(qs, vv, mask, hot,
                                                            n_hot, per_seg))
            pms = cuda_ms(torch, lambda: ivf.ivf_segmax_scan_plain(
                qs, vv, mask, hot, n_hot, per_seg))
            first.setdefault(kind, (ms, pms))
            lines.append(f"{kind} per_seg={per_seg} {ms:.4f} ms (the first "
                         f"kernel {cuda_ms(torch, first_kernel):.4f}, plain "
                         f"{pms:.4f})")
    def k8_lib(kind):  # per_seg 4 over the probed tiles' rows, segment-wise
        qs, vv = scan_inputs(kind, q64), kinds[kind]
        if kind == "i8c":
            def scores():
                return torch._int_mm(qs, vv.index_select(0, hot_idx).T).float()
        else:
            def scores():
                return torch.matmul(qs, vv.index_select(0, hot_idx).T)

        def run():
            s = scores().masked_fill(hot_out, float("-inf"))
            return torch.topk(s.view(64, -1, scan.SEG), 4, dim=2)
        return cuda_ms(torch, run)

    for name, kind, call in (("ivf_segmax_scan", "f32", LIB_IVF_SEG),
                             ("ivf_segmax_scan_i8c", "i8c", LIB_IVF_SEG_I8)):
        es = kinds[kind].element_size()
        rec[name] = entry(
            errs[kind], *first[kind],
            64 * dim * es + hot_live * dim * es + cap + 64 * 64 * 4 * ns * 4,
            *tc_ops(torch, 64, hot_live, dim, kinds[kind].dtype),
            k8_lib(kind), call)
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
        f"{max(errs.values()):.3g}, limit {TOL_SCORE:g}; plain f32 in TF32 "
        f"{err_tf32:.3g}, over bf16 inputs {err_bf16:.3g}): "
        + "; ".join(lines))
    del post, v8, kinds
    torch.cuda.empty_cache()


def check_k8_keys(torch, scan, keys, ref, exact: bool, what: str) -> float:
    """K8's key slab against its plain version's: the same KEY_MIN pattern,
    and the keys bit for bit (`exact`: int8 postings, integer sums) or
    decoded within TOL_SCORE. Returns the max |dkey value|."""
    live = keys != scan.KEY_MIN
    assert torch.equal(live, ref != scan.KEY_MIN), f"{what}: KEY_MIN pattern"
    if exact:
        assert torch.equal(keys, ref), f"{what}: keys differ"
        return 0.0
    if not bool(live.any()):
        return 0.0
    err = float((key_values(torch, scan, keys)[live]
                 - key_values(torch, scan, ref)[live]).abs().max())
    assert err <= TOL_SCORE, f"{what}: keys differ by {err}"
    return err


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
    counts = launch_counts(scan)
    for name, (key, _, _, phase) in KERNELS.items():
        if phase == 3:
            assert counts[key] > 0, f"{name} never launched on the main path"
    assert k4_launches_ok(scan, counts), "a K4 launch missed the tensor-core scan"
    # K1 alone at one 2048-query chunk on the store's own mirror and mask
    # (after the count: not the path's): held against its plain version,
    # run over 131,072-row slices (its keys are per 128-row segment), and
    # timed beside the chunk's wall time
    dev = db._dev
    qf = normalize_on_device(qdev[:2048])
    qb = qf.to(torch.bfloat16)
    keys, keys_p, err1 = k1_on_mirror(torch, scan, dev, qf, qb,
                                      "K1 (wgmma) on the store's mirror")
    del keys_p
    rec["segmax_scan"]["max_abs_err"] = max(rec["segmax_scan"]["max_abs_err"],
                                            err1)
    # K2 on this chunk's slab (k_sel 16), at this phase's shape
    cap3, live3 = dev.active.shape[0], int(dev.active.sum())
    k2_line = k2_timed(torch, scan, keys, 16, split=True)
    q64f = qf[:64].contiguous()
    del keys
    k1_ms = cuda_ms(torch, lambda: scan.segmax_scan(qb, dev.vectors_lp,
                                                    dev.active))
    chunk_ms = batch_s / 4 * 1e3
    # the path's other launch shapes: K1 + K2 (k_sel 16) at Q = 64 and
    # 256 over the mirror, K3 at K3_SHAPES over the int8 mirror (the
    # sweep against the tensor-core scan, behind scan.I8_SWEEP_Q_MAX)
    other = []
    for nq in (64, 256):
        qbn = qb[:nq].contiguous()
        kk = scan.segmax_scan(qbn, dev.vectors_lp, dev.active)
        b1 = entry(0.0, 0, 0, nq * dim * 2 + live3 * dim * 2 + cap3
                   + kk.numel() * 4, 2 * nq * live3 * dim, "bf16")["bound_ms"]
        other.append(
            f"K1 Q={nq} {cuda_ms(torch, lambda: scan.segmax_scan(qbn, dev.vectors_lp, dev.active)):.4f} "
            f"ms (bound {b1:.4f}), " + k2_timed(torch, scan, kk, 16,
                                                split=nq == 64))
        del kk
    k3_line = k3_table(torch, scan, qdev, dev.vectors_i8, dev.vscale,
                       dev.active, K3_SHAPES)
    # K4 at the path's two launch shapes over the store's own bf16 mirror
    # (`k4_timed`: the plain version over 131,072-row slices): Q = 64,
    # k_sel 36 (mixed_fused_batch) and k_sel 14 under the 3,000-id filter
    # (mixed_fused_batch_filtered), whose bound counts its live rows and
    # beside it the bytes of the segments that hold one; then K4_SHAPES,
    # the crossover behind TOPK_WGMMA_Q_MIN
    fmask = torch.zeros_like(dev.active)
    fmask[torch.from_numpy(np.asarray([int(a[1:]) for a in allow])).to(
        device)] = True
    fmask &= dev.active
    flive = int(fmask.sum())
    fsegs = int(fmask.view(-1, scan.SEG).any(dim=1).sum())
    k4 = {}
    for what, msk, ksel in (("Q=64 k_sel=36", dev.active, 36),
                            (f"Q=64 k_sel=14 over {flive} filtered rows "
                             f"({fsegs} of {cap3 // scan.SEG} segments live, "
                             f"{fsegs * scan.SEG * dim * 2 / 1e6:.1f} MB: "
                             f"{fsegs * scan.SEG * dim * 2 / HBM_BYTES_PER_S * 1e3:.4f}"
                             f" ms at HBM rate)", fmask, 14)):
        served, times, err = k4_timed(torch, scan, q64f, dev.vectors_lp, msk,
                                      ksel, reps=10)
        nlive = int(msk.sum())
        bound = entry(0.0, 0, 0, 64 * dim * 4 + nlive * dim * 2 + cap3
                      + 64 * ksel * 8, *tc_ops(torch, 64, nlive, dim,
                                               torch.bfloat16, 3))["bound_ms"]
        rec["fused_topk"]["max_abs_err"] = max(rec["fused_topk"]["max_abs_err"],
                                               err)
        k4[what] = (f"{what} ({served}): " + ", ".join(
            f"{name} {ms:.4f}" for name, ms in times.items())
            + f" ms, bound {bound:.4f}")
    k4_line, err = k4_table(torch, scan, qdev, dev.vectors_lp, dev.active,
                            K4_SHAPES)
    rec["fused_topk"]["max_abs_err"] = max(rec["fused_topk"]["max_abs_err"], err)
    del qb, qf, q64f, fmask
    log(f"phase 3: main path at {n} x {dim}: routes segmax_mixed_stream, "
        f"i8_fused_smallq, fview_segmax, mixed_fused_batch_filtered, "
        f"mixed_fused_batch; recall@10 {recall:.4f} vs float64 (filter view "
        f"{recall_f:.4f} vs the filtered oracle); delete ok; launches "
        f"{counts}")
    log(f"phase 3: K1 (wgmma) keys at Q=2048 over the store's "
        f"{dev.vectors_lp.shape[0]}-row mirror agree with the plain version "
        f"(max |dkey value| {err1:.3g}, KEY_MIN pattern equal, K2 + rescored "
        f"rows = plain outside the gap); at this phase's shapes, on the "
        f"chunk's slab {k2_line}; " + "; ".join(other))
    log(f"phase 3: K4 fused_topk over the store's {cap3}-row bf16 mirror "
        f"within {rec['fused_topk']['max_abs_err']:.3g} of the plain version, "
        f"ids = plain outside the gap (the kernel the dispatch chose, then "
        f"each kernel's ms): " + "; ".join(k4.values()))
    log(f"phase 3: K4's crossover over the store's bf16 mirror, {live3} live "
        f"rows: {k4_line}")
    log(f"phase 3: K3 fused_topk_i8 = plain bit for bit over the store's "
        f"{dev.vectors_i8.shape[0]}-row int8 mirror, {live3} live rows "
        f"(the kernel the dispatch chose, then each kernel's ms): {k3_line}")

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


def phase_narrow_stores(torch, scan, device, n: int, dim: int, rng, rec,
                        **db_kwargs):
    """Two float32 stores whose widths TMA cannot read, their 2048-query
    chunks on segmax_mixed_stream: at `dim` (even: 1020) through K1's
    mainloop fed by cp.async, at ODD_DIM (1019, data from a generator of
    its own) through the mainloop fed by K1's realigning producer;
    recall@10 against a float64 oracle for each, and (after each store's
    count) K1 on the store's own mirror held to the plain version and
    timed beside the wmma tile that served both widths before (and, on
    the even store, beside the realigning producer), with its bound. The
    cp.async store's chunks are timed (median of 7 passes). Raises the
    rows' max_abs_err in `rec`; returns the launches of the two paths
    (each counted alone): the first store's, with "segmax_realign" from
    the second."""
    from picovdb_tpu_torch import PicoVectorDB
    from picovdb_tpu_torch.ops.exact import normalize_on_device

    def serve(corpus, qdev, prefix, path):
        nn, d = corpus.shape
        scan.reset_launch_counts()  # count this path's launches only
        db = PicoVectorDB(embedding_dim=d, index="exact", device=device,
                          storage_file=os.path.join(os.getcwd(), path),
                          **db_kwargs)
        db.upsert_columnar(corpus, ids=[f"{prefix}{i}" for i in range(nn)],
                           copy=False)
        got, _ = db.query_columnar(qdev, top_k=10, batch_size=2048)
        assert db.last_query_debug()["strategy"] == "segmax_mixed_stream"
        counts = launch_counts(scan)
        # K1 launches that took none of the mainloop's three producers
        # (the wmma tile): none may
        counts["segmax_wmma"] = (counts["segmax"] - counts["segmax_wgmma"]
                                 - counts["segmax_cpasync"]
                                 - counts["segmax_realign"])
        assert counts["segmax_wmma"] == 0, counts
        truth = oracle_top10(torch, torch.from_numpy(corpus).to(device),
                             qdev[:64], torch.ones(nn, dtype=torch.bool,
                                                   device=device))
        recall = recall_at_10(got[:64], truth, prefix)
        assert recall >= 0.99, recall
        # after the count: K1 at one 2048-query chunk on the store's own
        # mirror, held to the plain version, and timed beside the kernels
        # that could serve it there, with its bound
        qf = normalize_on_device(qdev[:2048])
        qb = qf.to(torch.bfloat16)
        dev = db._dev
        _, keys_p, err = k1_on_mirror(torch, scan, dev, qf, qb,
                                      f"K1 on the dim-{d} store's mirror")
        args = (qb, dev.vectors_lp, dev.active)
        cap, live = dev.active.shape[0], int(dev.active.sum())
        times = {"K1": cuda_ms(torch, lambda: scan.segmax_scan(*args))}
        for other, what in (("pv_segmax_scan_realign", "realigning producer"),
                            ("pv_segmax_scan", "wmma tile")):
            if other == "pv_segmax_scan_realign" and d % 2:
                continue  # it is K1 here
            keys = scan._segmax_launch(*args, other)
            torch.cuda.synchronize()
            check_segmax_keys(torch, scan, keys, keys_p, qf, dev.vectors, 10,
                              f"{what} on the dim-{d} mirror")
            del keys
            times[what] = cuda_ms(torch, lambda: scan._segmax_launch(*args,
                                                                     other))
        bound = entry(0.0, 0, 0, 2048 * d * 2 + live * d * 2 + cap
                      + 2048 * 2 * (cap // scan.SEG) * 4, 2 * 2048 * live * d,
                      "bf16")["bound_ms"]
        k1_line = (", ".join(f"{what} {ms:.4f}" for what, ms in times.items())
                   + f" ms, bound {bound:.4f}")
        del keys_p
        return db, counts, recall, err, k1_line

    corpus = rng.standard_normal((n, dim), dtype=np.float32)
    near = corpus[rng.integers(0, n, 2048)]
    qdev = torch.from_numpy(
        near + 0.01 * rng.standard_normal(near.shape, dtype=np.float32)
    ).to(device)
    db, counts, recall, err, k1_line = serve(corpus, qdev, "w",
                                             "picovdb_smoke_w")
    assert counts["segmax_cpasync"] == counts["segmax"] > 0, counts
    assert counts["segmax_wgmma"] == counts["segmax_realign"] == 0, counts
    cp = rec["segmax_scan_cpasync"]
    cp["max_abs_err"] = max(cp["max_abs_err"], err)
    passes = []
    for _ in range(7):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        db.query_columnar(qdev, top_k=10, batch_size=2048)
        torch.cuda.synchronize()
        passes.append(time.perf_counter() - t0)
    chunk_s = float(np.median(passes))
    del db
    log(f"phase 3b: a {n} x {dim} float32 store (bf16 mirror rows of "
        f"{dim * 2} bytes, not a multiple of 16): route segmax_mixed_stream "
        f"through K1's mainloop fed by cp.async, recall@10 {recall:.4f} vs "
        f"float64; K1 keys on the store's mirror agree with the plain "
        f"version (max |dkey value| {err:.3g}, KEY_MIN pattern equal, K2 + "
        f"rescored rows = plain outside the gap); at Q=2048 {k1_line}; a "
        f"2048-query chunk {chunk_s * 1e3:.3f} ms of wall, "
        f"{2048 / chunk_s:.1f} QPS (query_columnar, median of 7 passes; "
        f"{', '.join(f'{2048 / t:.1f}' for t in passes)}); launches {counts}")

    g = np.random.default_rng(SEED + 12)
    corpus = g.standard_normal((n, ODD_DIM), dtype=np.float32)
    near = corpus[g.integers(0, n, 2048)]
    qdev = torch.from_numpy(
        near + 0.01 * g.standard_normal(near.shape, dtype=np.float32)
    ).to(device)
    db, odd, recall, err, k1_line = serve(corpus, qdev, "o", "picovdb_smoke_o")
    # every K1 launch of the odd store's path took the realigning producer
    assert odd["segmax_realign"] == odd["segmax"] > 0, odd
    assert odd["segmax_wgmma"] == odd["segmax_cpasync"] == 0, odd
    ra = rec["segmax_scan_realign"]
    ra["max_abs_err"] = max(ra["max_abs_err"], err)
    del db
    log(f"phase 3b: a {n} x {ODD_DIM} float32 store (rows of "
        f"{ODD_DIM * 2} bytes, odd): route segmax_mixed_stream through K1's "
        f"mainloop fed by its realigning producer, recall@10 {recall:.4f} vs "
        f"float64; K1 keys on the store's mirror agree with the plain "
        f"version (max |dkey value| {err:.3g}, KEY_MIN pattern equal, K2 + "
        f"rescored rows = plain outside the gap); at Q=2048 {k1_line}; "
        f"launches {odd}")
    counts["segmax_realign"] = odd["segmax_realign"]
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
    with uncounted(scan):  # the Q = 64 batches' latency, not the path's
        lat = q64_latency(torch, db, q64)

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
    counts = launch_counts(scan)
    assert counts["segmax_i8_wgmma"] == counts["segmax_i8"] > 0, \
        "a K5 launch missed the int8 mainloop"
    shapes4 = counts["shapes"]["scan_topk_i8"]
    assert counts["scan_topk_i8_sweep"] >= shapes4.get("Q=1 k=142", 0) > 0, \
        "the host-rescore band's Q = 1 calls missed K3's sweep"
    assert shapes4.get("Q=64 k=142", 0) > 0 and k3_launches_ok(scan, counts), \
        "a K3 launch at Q > I8_SWEEP_Q_MAX missed the tensor-core scan"
    # after the count: K3 at K3_PHASE4 (the host-rescore band's launch
    # shapes, Q = 1 and the Q = 64 batches at k_sel 142, and those around
    # them) and at K3_CROSSOVER (the sweep against the tensor-core scan,
    # behind I8_SWEEP_Q_MAX), and K5 at the path's Q = 2048 and 256, on the
    # store's own plane, scales and mask: bit for bit the plain version
    # (over 131,072-row slices) and the kernels they replaced, all timed
    d2 = db2._dev
    cap4, live4 = d2.active.shape[0], int(d2.active.sum())
    k3_line = k3_table(torch, scan, qdev, d2.vectors, d2.vstore_scale,
                       d2.active, K3_PHASE4)
    k3_cross = k3_table(torch, scan, qdev, d2.vectors, d2.vstore_scale,
                        d2.active, K3_CROSSOVER, reps=3)
    # the tensor-core scan's device time by kernel (the scan, the merge) at
    # the host-rescore band's batch and at k_sel 14
    k3_split = {}
    for ksel in (142, 14):
        q8s, _ = scan.quantize_rows_i8(normalize_on_device(qdev[:64]))
        k3_split[ksel] = device_split(torch, lambda: scan._i8_wgmma_launch(
            q8s, d2.vectors, d2.vstore_scale, d2.active, ksel))
    args = (d2.vectors, d2.vstore_scale, d2.active)
    q8_2048, _ = scan.quantize_rows_i8(normalize_on_device(qdev[:2048]))
    keys = scan.segmax_scan_i8(q8_2048, *args)
    step = 131_072
    for s in range(0, cap4, step):
        ref = scan.segmax_scan_i8_plain(q8_2048, *(a[s:s + step] for a in args))
        got = keys[:, 2 * s // scan.SEG:][:, :ref.shape[1]]
        assert torch.equal(got, ref), f"K5 keys differ in rows {s}.."
    assert torch.equal(scan._segmax_i8_launch(q8_2048, *args, False), keys), \
        "K5's mma.sync tile differs on the store's plane"
    # K2 after a K5 chunk (segmax_i8stor: k_sel 16) on that chunk's slab
    k2_line = k2_timed(torch, scan, keys, 16)
    del keys, ref, got
    k5 = []
    for nq in (2048, 256):
        q8n = q8_2048[:nq].contiguous()
        bound = entry(0.0, 0, 0, nq * dim + live4 * (dim + 4) + cap4
                      + nq * 2 * (cap4 // 128) * 4, 2 * nq * live4 * dim,
                      "int8")["bound_ms"]
        k5.append(
            f"Q={nq} {cuda_ms(torch, lambda: scan.segmax_scan_i8(q8n, *args)):.4f}"
            f" ms (the mma.sync tile "
            f"{cuda_ms(torch, lambda: scan._segmax_i8_launch(q8n, *args, False)):.4f}"
            f", bound {bound:.4f})")
    log(f"phase 4: K3 fused_topk_i8 = plain bit for bit on the store's "
        f"{cap4}-row plane (the kernel the dispatch chose, then each "
        f"kernel's ms): {k3_line}; K5 segmax_scan_i8 (int8 TMA + wgmma) keys "
        f"= plain bit for bit at Q=2048 on the plane: " + ", ".join(k5)
        + f"; on K5's 2048-query slab {k2_line}")
    log(f"phase 4: K3's crossover on the store's plane, {live4} live rows "
        f"(sweep limit I8_SWEEP_Q_MAX = {scan.I8_SWEEP_Q_MAX}): {k3_cross}; "
        f"the tensor-core scan at Q=64: " + "; ".join(
            f"k_sel={ksel} {split}" for ksel, split in k3_split.items()))
    log(f"phase 4: int8 storage at {n} x {dim}: routes i8stor_fused_exact "
        f"(host rescore), segmax_i8stor_stream, i8stor_fused_smallq; "
        f"recall@10 vs float64 {recall:.4f} (filtered {recall_f:.4f}) with "
        f"the host rescore, {recall_dev:.4f} at storage precision; "
        f"segmax_i8stor_stream ids = plain exact_topk_i8r outside the gap; "
        f"save(quantized=True) + reload ok; launches {counts}")
    log(f"phase 4: insert {n / insert_s:.1f} vec/s; batch "
        f"{4096 / batch_s:.1f} QPS (query_columnar, 4096 queries); Q=1 "
        f"latency {q1_ms:.4f} ms with the host rescore; Q=64 with the host "
        f"rescore (CUDA events, median of 10): query_columnar {lat[0]:.4f} "
        f"ms, query under the tag filter {lat[1]:.4f} ms; card {card}")
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
    q256 = dequant(gone[:256])
    back, _ = db.query_columnar(q256, top_k=10)
    assert not (set(back[back != None].tolist())  # noqa: E711
                & {f"w{i}" for i in gone})
    counts = launch_counts(scan)
    # K6's launches by shape, from the calls above: Q = 1 by db.query once
    # and cuda_ms's warm-up + 10 reps (the sweep), Q = 2048 by the two
    # query_columnar calls and Q = 256 by the delete check (one launch a
    # call each, on the tensor-core scan)
    shapes = counts["shapes"]["scan_topk_i4"]
    assert shapes == {"Q=1 k=14": 12, "Q=2048 k=14": 2, "Q=256 k=14": 1}, \
        shapes
    assert counts["scan_topk_i4_sweep"] == 12, "Q=1 missed the sweep"
    assert counts["scan_topk_i4_wgmma"] == 3, \
        "the batches missed the tensor-core scan"
    # K6 after the count, at k_sel = k + 4 over the store's own plane,
    # scales and mask, at the shapes above and at those between them that
    # place the ready rules' limits: what the dispatch returns, bit for bit
    # the plain version, and every kernel that can take the shape
    # (uncounted) held to it and timed on the same inputs
    live5 = int(dev.active.sum())
    cap5 = dev.active.shape[0]
    k6 = {}
    for nq in K6_SHAPES:
        qq = q256 if nq == 256 else qdev[:nq]
        q8s, _ = scan.quantize_rows_i8(normalize_on_device(qq))
        args = (q8s, dev.vectors, dev.vstore_scale, dev.active, 14)
        ref = scan.scan_topk_plain(*args, int4=True)
        served, times, _ = k6_timed(torch, scan, args, ref,
                                    reps=3 if nq >= 256 else 5)
        k6[nq] = (served, times, entry(
            0.0, 0, 0, nq * dim + live5 * (dim // 2 + 4) + cap5
            + nq * 14 * 8, 2 * nq * live5 * dim, "int8")["bound_ms"])
    k6_line = "; ".join(
        f"Q={nq} ({shapes.get(f'Q={nq} k=14', 0)} launches, {served}): "
        + ", ".join(f"{name} {ms:.4f}" for name, ms in times.items())
        + f" ms, bound {bd:.4f} ms"
        for nq, (served, times, bd) in k6.items())
    gb = dev.vectors.numel() / 2**30
    log(f"phase 5: int4 storage, device-born, {n} x {dim} ({gb:.2f} GiB "
        f"packed plane): route i4stor_fused at Q=1 and 2048; ids = float64 "
        f"oracle over the dequantized rows outside the gap; recall@10 "
        f"{recall:.4f} vs the original float rows; delete ok; launches "
        f"{counts}")
    log(f"phase 5: K6 fused_topk_i4 = plain bit for bit at k_sel=14, "
        f"{live5} live rows (launches, the kernel the dispatch chose): "
        f"{k6_line}")
    served1, times1, bound1 = k6[1]
    log(f"phase 5: rows made + packed on the card in {make_s:.2f} s, "
        f"ingest_device {ingest_s:.2f} s; Q=1 latency {q1_ms:.4f} ms (K6 "
        f"alone {times1[served1]:.4f} ms, bound {bound1:.4f}); batch "
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


def store_probe(db, qn):
    """The probe preamble of the IVF store `db` for the batch `qn`
    (normalized, on the card), as its route runs it: (row_mask, hot,
    n_hot, grid_b)."""
    from picovdb_tpu_torch.ops import ivf as tivf

    x = db._ivf
    npb = tivf.ef_to_nprobe(db._ef_search, x.nlist)
    return tivf._probe_preamble(
        qn, x.centroids, x.active, x.seg_starts, x.cluster2tile, nprobe=npb,
        nlist=x.nlist, g_tiles=x.g_tiles(qn.shape[0], npb),
        cap_ivf=x.active.shape[0], n_tiles=x.n_tiles, bn=tivf.IVF_BN)


def scanned_rows(torch, db, row_mask, hot, n_hot):
    """(cap_ivf,) bool: the postings rows the IVF kernels scan, the probe's
    row mask cut to the live hot tiles."""
    from picovdb_tpu_torch.ops import ivf as tivf

    tiles = torch.zeros(db._ivf.n_tiles, dtype=torch.bool,
                        device=row_mask.device)
    tiles[hot[: int(n_hot)].long()] = True
    return row_mask & tiles.repeat_interleave(tivf.IVF_BN)


def probed_slots(torch, db, qn, n_slots: int):
    """(n_slots,) bool: the corpus slots the IVF kernels scan for the
    batch `qn` (normalized, on the card)."""
    row_mask, hot, n_hot, _ = store_probe(db, qn)
    scanned = scanned_rows(torch, db, row_mask, hot, n_hot)
    m = torch.zeros(n_slots, dtype=torch.bool, device=qn.device)
    m[db._ivf.slots[scanned]] = True
    return m


def ivf_kernels_on_store(torch, scan, db, qn, rec) -> str:
    """K7 on one Q = 1 call's own inputs on the IVF store `db`: the probe
    preamble's hot table for the first of the normalized queries `qn`, the
    postings and query the route scans, k_sel of k = 10 with the route's
    guard. The sweep (the route's kernel) and the template it replaced are
    held to the plain version (int8 postings: bit for bit) and timed; then
    K8 is timed on the first 32-query chunk's own inputs. Returns the
    phase line's text. Run after the path's count."""
    from picovdb_tpu_torch.ops import ivf as tivf

    x = db._ivf
    q1 = qn[:1]
    row_mask, hot, n_hot, grid_b = store_probe(db, q1)
    qs, vs = tivf._scan_inputs(q1, x.vectors, x.vectors_i8c, x.cscale)
    k = 10 + tivf._ivf_guard(x.vectors_i8c is not None, x.dim)

    def sweep():
        return tivf.ivf_scan_topk(qs, vs, row_mask, hot, n_hot, k)

    def template():
        return tivf._ivf_template_launch(qs, vs, row_mask, hot, n_hot, k,
                                         tivf.IVF_BN)

    before = scan.LAUNCHES["ivf_scan_topk_sweep"]
    got = {"sweep": sweep(), "template": template()}
    assert scan.LAUNCHES["ivf_scan_topk_sweep"] == before + 1, "K7 sweep"
    rv, ri = tivf.ivf_scan_topk_plain(qs, vs, row_mask, hot, n_hot, k + 1)
    torch.cuda.synchronize()
    for what, (vals, idx) in got.items():
        assert torch.equal(torch.isneginf(vals), torch.isneginf(rv[:, :k]))
        if vs.dtype == torch.int8:
            assert torch.equal(vals, rv[:, :k]) and torch.equal(idx, ri[:, :k]), what
        else:
            fin = torch.isfinite(vals)
            err = float((vals[fin] - rv[:, :k][fin]).abs().max())
            assert err <= TOL_SCORE, f"K7 {what} on the store: {err}"
            assert ids_agree(torch, idx, ri, rv, k) == 0.0, what
    ms, tms = cuda_ms(torch, sweep), cuda_ms(torch, template)
    split = device_split(torch, sweep)
    pms = cuda_ms(torch, lambda: tivf.ivf_scan_topk_plain(
        qs, vs, row_mask, hot, n_hot, k))
    live = int(scanned_rows(torch, db, row_mask, hot, n_hot).sum())
    es, dim = vs.element_size(), vs.shape[1]
    kind = {torch.float32: "f32", torch.bfloat16: "bf16", torch.int8: "int8"}
    bound = entry(0.0, ms, pms, dim * es + live * dim * es + vs.shape[0]
                  + k * 8, 2 * live * dim, kind[vs.dtype])["bound_ms"]
    # K8 on the first 32-query chunk's own inputs (the segmax route's
    # depth, keys out), held to its plain version
    m8, h8, n8, g8 = store_probe(db, qn[:32])
    q32, _ = tivf._scan_inputs(qn[:32], x.vectors, x.vectors_i8c, x.cscale)
    depth, bn = tivf.SEGMAX_DEPTH, tivf.IVF_BN
    before = scan.LAUNCHES["ivf_segmax_wgmma"]
    keys = tivf.ivf_segmax_scan(q32, vs, m8, h8, n8, depth)
    assert scan.LAUNCHES["ivf_segmax_wgmma"] == before + 1, "K8 segment scan"
    ref = tivf.ivf_segmax_scan_plain(q32, vs, m8, h8, n8, depth)

    def first_kernel():  # the kernel the segment scan replaced, uncounted
        return tivf._ivf_segmax_launch(q32, vs, m8, h8, n8, depth, bn, False)

    old = first_kernel()
    torch.cuda.synchronize()
    err8 = check_k8_keys(torch, scan, keys, ref, vs.dtype == torch.int8,
                         "K8 on the store's chunk")
    check_k8_keys(torch, scan, old, ref, vs.dtype == torch.int8,
                  "K8's first kernel on the store's chunk")
    del old
    name8 = "ivf_segmax_scan_i8c" if vs.dtype == torch.int8 else "ivf_segmax_scan"
    rec[name8]["max_abs_err"] = max(rec[name8]["max_abs_err"], err8)
    del keys, ref
    k8_ms = cuda_ms(torch, lambda: tivf.ivf_segmax_scan(
        q32, vs, m8, h8, n8, depth))
    k8_first_ms = cuda_ms(torch, first_kernel)
    k8_host = host_us(torch, lambda: tivf.ivf_segmax_scan(q32, vs, m8, h8, n8,
                                                          depth))
    k8_first_host = host_us(torch, first_kernel)
    split_host = ""
    if q32.dtype == torch.float32:
        us = host_us(torch, lambda: tivf.split_tf32(q32))
        split_host = f", of which the query split {us:.1f}"
    live8 = int(scanned_rows(torch, db, m8, h8, n8).sum())
    ncol = g8 * depth * (bn // scan.SEG)
    k8_bound = entry(0.0, 0, 0, 32 * dim * es + live8 * dim * es
                     + vs.shape[0] + 32 * ncol * 4,
                     *tc_ops(torch, 32, live8, dim, vs.dtype))["bound_ms"]
    # what a kernel that skips dead segments must read: the live steps'
    # 128-row segments that hold at least one live row
    nl = int(n8)
    rows = (h8[:nl].long()[:, None] * bn
            + torch.arange(bn, device=m8.device)).reshape(-1)
    seg_live = m8[rows].view(-1, scan.SEG).any(1)
    seg_bytes = int(seg_live.sum()) * scan.SEG * dim * es
    return (f"; K7 on a Q=1 call's own hot table (grid_b {grid_b}, n_hot "
            f"{int(n_hot)}, {live} live rows, {kind[vs.dtype]} postings, "
            f"k_sel {k}): sweep {ms:.4f} ms [{split}], the template it "
            f"replaced {tms:.4f} ms, plain {pms:.4f} ms, bound {bound:.4f} "
            f"ms; K8 on a 32-query chunk's own hot table (grid_b {g8}, n_hot "
            f"{nl}, {live8} live rows) = plain (max |dkey value| {err8:.3g}), "
            f"the first kernel too: segment scan {k8_ms:.4f} ms, the first "
            f"kernel {k8_first_ms:.4f} ms (host us a call to enqueue: "
            f"{k8_host:.1f}{split_host}, {k8_first_host:.1f}), bound "
            f"{k8_bound:.4f} ms; "
            f"{int((~seg_live).sum())} of the {seg_live.numel()} live steps' "
            f"segments hold no live row, the others {seg_bytes} bytes "
            f"({seg_bytes / HBM_BYTES_PER_S * 1e3:.4f} ms at 3.35 TB/s)")


def trace_call(torch, fn, reps: int = 5):
    """One call of `fn`: its wall ms (host clock over `reps` calls, each
    synchronizing as a query does), its device ms (torch.profiler's CUDA
    activity over `reps` more calls: the durations of its kernels and
    copies, which run on one stream, so their sum is the busy time) and
    {kernel name: device us} a call; device ms None where the profiler
    records no device activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / reps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    per = {}
    for ev in prof.events():
        if ev.device_type != DeviceType.CUDA:
            continue
        head = ev.name.replace("(anonymous namespace)", "").split("<")[0]
        name = head.split("(")[0].split("::")[-1].split()
        name = name[-1] if name else ev.name[:40]
        us, n = per.get(name, (0.0, 0))
        per[name] = (us + ev.time_range.elapsed_us() / reps, n + 1)
    busy = sum(us for us, _ in per.values()) / 1e3 if per else None
    return wall, busy, per


def chunk_ab(torch, db, q32) -> str:
    """One 32-query chunk of the IVF store `db` (`query_columnar`, the
    segmax route) traced by `trace_call`, K8 on the tensor-core segment
    scan against K8 on its first kernel (`ivf_segmax_ready` made false:
    the route as it ran before the segment scan), alternated twice in one
    process. Run after the path's count."""
    from picovdb_tpu_torch.ops import ivf as tivf

    ready = tivf.ivf_segmax_ready

    def chunk():
        return db.query_columnar(q32, top_k=10, batch_size=32)

    out, reps = {"segment scan": [], "first kernel": []}, 5
    try:
        for _ in range(2):
            for what in out:
                tivf.ivf_segmax_ready = (ready if what == "segment scan"
                                         else lambda q, p: False)
                out[what].append(trace_call(torch, chunk, reps))
    finally:
        tivf.ivf_segmax_ready = ready
    parts = []
    for what, runs in out.items():
        text = []
        for wall, busy, per in runs:
            if busy is None:
                text.append(f"wall {wall:.4f} ms, device not measured")
                continue
            k8 = [v for n, v in per.items() if n.startswith("ivf_segmax")]
            top = sorted(per.items(), key=lambda kv: -kv[1][0])[:3]
            text.append(
                f"wall {wall:.4f} ms, device {busy:.4f} ms (idle "
                f"{1 - busy / wall:.3f}; K8 {sum(us for us, _ in k8):.1f} us"
                f", {sum(n for _, n in k8)} of its {reps} launches in the trace; "
                f"{sum(n for _, n in per.values())} device events; top "
                + ", ".join(f"{n} {us:.1f}" for n, (us, _) in top) + ")")
        parts.append(f"{what}: " + " | ".join(text))
    return ("; a 32-query chunk traced (torch.profiler, device time a "
            "chunk against its wall time), " + "; ".join(parts))


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


def phase_ivf_f32(torch, scan, device, n: int, dim: int, rng, card: str,
                  rec):
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
    counts = launch_counts(scan)
    for name, (key, _, _, phase) in KERNELS.items():
        if phase == 7:
            assert counts[key] > 0, f"{name} never launched on the IVF path"
    assert k4_launches_ok(scan, counts), "a K4 launch missed the tensor-core scan"

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
    k7 = ivf_kernels_on_store(torch, scan, db, qn, rec)
    k7 += chunk_ab(torch, db, qs[:32])
    # K4 at the exact route's Q = 256, k_sel 14 (after the count), over
    # the rows it selects on: the bf16 mirror, or the float32 rows where
    # the store keeps no mirror. Held to the plain version (over 131,072-row
    # slices) with the template it replaced (`k4_timed`), then K4_SHAPES
    # over the same rows
    dev = db._dev
    sel = dev.vectors if dev.vectors_lp is None else dev.vectors_lp
    q256 = normalize_on_device(torch.from_numpy(qs[:256]).to(device))
    live7 = int(dev.active.sum())
    served, times, err = k4_timed(torch, scan, q256, sel, dev.active, 14, 5)
    k4_bound = entry(0.0, 0, 0, 256 * dim * 4 + live7 * dim * sel.element_size()
                     + dev.active.shape[0] + 256 * 14 * 8,
                     *tc_ops(torch, 256, live7, dim, sel.dtype, 3))["bound_ms"]
    k4_line, err_t = k4_table(torch, scan, torch.from_numpy(qs).to(device),
                              sel, dev.active, K4_SHAPES)
    rec["fused_topk"]["max_abs_err"] = max(rec["fused_topk"]["max_abs_err"],
                                           err, err_t)
    k7 += (f"; K4 at the {exact_route} route's Q=256 k_sel=14 over "
           f"{sel.dtype} rows within {max(err, err_t):.3g} of the plain "
           f"version, ids = plain outside the gap ({served}): " + ", ".join(
               f"{name} {ms:.4f}" for name, ms in times.items())
           + f" ms (bound {k4_bound:.4f}); K4's crossover over these rows: "
           + k4_line)
    del q256, dev, sel

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
        f"(query_columnar, 1024 queries in 32-query chunks){k7}; card {card}")
    del db, corpus
    shutil.rmtree(tmp)
    return counts


def phase_ivf_int4(torch, scan, device, n: int, dim: int, rng, card: str,
                   rec):
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
    counts = launch_counts(scan)
    for key in ("ivf_scan_topk", "ivf_scan_topk_sweep", "ivf_segmax",
                "ivf_segmax_wgmma"):
        assert counts[key] > 0, f"{key} never launched on the IVF path"
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
    k7 = ivf_kernels_on_store(torch, scan, db, qn, rec)
    k7 += chunk_ab(torch, db, qs[:32])
    log(f"phase 8: IVF int8-only layout over a device-born {n} x {dim} int4 "
        f"store, index=ivf: built at the first sync ({first_s:.2f} s), nlist "
        f"{op['nlist']}, nprobe {op['nprobe_default']}, postings "
        f"{op['postings']}; routes ivf_i8 at Q=1 (K7) and in 32-query chunks "
        f"(K8); ids = restricted float64 oracle over the dequantized rows "
        f"outside the gap on {64 - bad1}/64 (K7) and {128 - badb}/128 (K8); "
        f"recall@10 {recall:.4f} vs the original float rows; launches {counts}")
    log(f"phase 8: Q=1 latency {q1_ms:.4f} ms; batch {1024 / batch_s:.1f} QPS "
        f"(query_columnar, 1024 queries in 32-query chunks); peak device "
        f"memory {peak:.2f} GiB{k7}; card {card}")
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
     ("segmax_i8", "segmax_i8_wgmma", "topk_keys", "scan_topk_i8")),
    ("c PICOVDB_SEGMAX_I8C=1 PICOVDB_SMALLQ_I8C=1",
     {"PICOVDB_SEGMAX_I8C": "1", "PICOVDB_SMALLQ_I8C": "1"}, {},
     "segmax_i8c_stream", "i8c_fused_smallq",
     ("segmax_i8c", "segmax_i8c_wgmma", "topk_keys", "scan_topk_i8c",
      "scan_topk_i8c_sweep")),
    ("d scan_mode=approx", {}, {"scan_mode": "approx"}, "xla_approx",
     "xla_approx", ()),
]


def route_bounds(dev, name: str) -> str:
    """The least times (bound_ms, by `entry`) of the store's route kernels
    at its own shapes: the batch kernel at one 2048-query chunk, the Q = 1
    kernel at k_sel of k = 10 with the route's guard, over the live rows;
    the yardstick beside `route_kernel_ms`."""
    cap, dim = dev.active.shape[0], dev.vectors.shape[1]
    live = int(dev.active.sum())
    slab, nq, ops = 2048 * 2 * (cap // 128) * 4, 2048, 2 * 2048 * live * dim
    rows = {"a": [("K1", nq * dim * 2 + live * dim * 2 + cap + slab, ops,
                   "bf16"),
                  ("K3", dim + live * (dim + 4) + cap + 14 * 8,
                   2 * live * dim, "int8")],
            "b": [("K5", nq * dim + live * (dim + 4) + cap + slab, ops,
                   "int8")],
            "c": [("K10", nq * dim + live * dim + cap + slab, ops, "int8"),
                  ("K9", dim + live * dim + cap + 16 * 8, 2 * live * dim,
                   "int8")]}.get(name[0], [])
    return ", ".join(f"{k} {entry(0.0, 0.0, 0.0, b, o, t)['bound_ms']:.4f}"
                     for k, b, o, t in rows) or "n/a"


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


def check_i8c_on_store(torch, scan, dev, qdev, new, rec) -> str:
    """K10 on one 2048-query chunk and K9 at Q = 1 and 16 (k_sel 16) over
    store (c)'s own column-scaled mirror, the planes its routes read,
    against their plain versions: integer keys and sums, so bit for bit.
    The plain K10 runs over 131,072-row slices (its keys are per 128-row
    segment). Raises each kernel's max_abs_err in `rec` to what it saw."""
    from picovdb_tpu_torch.ops.exact import normalize_on_device

    qq = scan.fold_queries_i8(normalize_on_device(qdev[:2048]), dev.cscale)
    v8c, act = dev.vectors_i8c, dev.active
    before = scan.LAUNCHES["segmax_i8c_wgmma"]
    keys = scan.segmax_scan_i8c(qq, v8c, act)
    assert scan.LAUNCHES["segmax_i8c_wgmma"] == before + 1, "K10 missed wgmma"
    err10, step = 0.0, 131_072
    for s in range(0, v8c.shape[0], step):
        ref = scan.segmax_scan_i8c_plain(qq, v8c[s:s + step], act[s:s + step])
        got = keys[:, 2 * s // scan.SEG:][:, :ref.shape[1]]
        assert torch.equal(got, ref), f"K10 keys differ in rows {s}.."
        err10 = max(err10, exact_err(torch, got, ref))
    # the mma.sync tile K10 ran before, on the same chunk (uncounted)
    assert torch.equal(scan._segmax_i8c_launch(qq, v8c, act, False), keys)
    del keys
    tile_ms = cuda_ms(torch, lambda: scan._segmax_i8c_launch(qq, v8c, act,
                                                             False))
    # K10 at the 1,000-upsert check's Q = 1000 (one chunk)
    q1000 = scan.fold_queries_i8(normalize_on_device(
        torch.from_numpy(new).to(qq.device)), dev.cscale)
    live9, cap9 = int(act.sum()), act.shape[0]
    k10_1000 = cuda_ms(torch, lambda: scan.segmax_scan_i8c(q1000, v8c, act))
    k10_bound = entry(0.0, 0, 0, 1000 * v8c.shape[1] + live9 * v8c.shape[1]
                      + cap9 + 1000 * 2 * (cap9 // scan.SEG) * 4,
                      2 * 1000 * live9 * v8c.shape[1], "int8")["bound_ms"]
    del q1000
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
    return (f"; K10 keys (2048 queries, int8 TMA + wgmma) and K9 (one-query "
            f"sweep, Q=1, 16, k_sel 16) = plain bit for bit over the store's "
            f"{v8c.shape[0]}-row mirror, the mma.sync tile K10 replaced "
            f"{tile_ms:.4f} ms a chunk (same keys), K9 at Q=1, 16 "
            f"{sweep_ms[0]:.4f}, "
            f"{sweep_ms[1]:.4f} ms, the template it replaced "
            f"{tmpl_ms[0]:.4f}, {tmpl_ms[1]:.4f} ms; K10 at Q=1000 "
            f"{k10_1000:.4f} ms (bound {k10_bound:.4f})")


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
            counts = launch_counts(scan)
            for key in keys:
                assert counts[key] > 0, f"{key} never launched on store {name}"
            k_ms, q1_k_ms = route_kernel_ms(torch, scan, db._dev, qdev, name)
            if name.startswith("c"):  # after the count: not the path's
                chunk_ms = batch_s / 4 * 1e3
                extra += (f"; K10 {k_ms:.4f} ms of a {chunk_ms:.3f} ms "
                          f"2048-query chunk of wall "
                          f"({100 * k_ms / chunk_ms:.1f} %)")
                extra += check_i8c_on_store(torch, scan, db._dev, qdev, new,
                                            rec)
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
            f"kernel {fmt(q1_k_ms)} ms (bound ms at these shapes: "
            f"{route_bounds(db._dev, name)}); insert {n / insert_s:.1f} vec/s"
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
    counts = launch_counts(scan)
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


# the KERNELS rows phase 11 drives on every shard: K4, K3, K6, K7
MESH_ROWS = ("fused_topk", "fused_topk_i8", "fused_topk_i8_wgmma",
             "fused_topk_i4", "fused_topk_i4_wgmma", "ivf_scan_topk")
MESH_N = 2_000_000  # rows of phase 11's stores (512K a shard at 4 shards)
MESH_SHARDS = 4
MESH_Q = 8192  # batch-served queries a store, in 2048-query chunks
MESH_ORACLE_Q = 512  # queries held to the float64 oracle
MESH_ATOL = 1e-5  # kernel route vs plain route, both rescored in float32
# each storage's kernel family (every launch of K4 / K3 / K6 / K7)
MESH_FAMILY = {"float32": "scan_topk", "int8": "scan_topk_i8",
               "int4": "scan_topk_i4", "ivf": "ivf_scan_topk"}


def mesh_grid(torch, dp: int = 1):
    """Phase 11's mesh: four devices, cuda:i % count (one shard a card on a
    four-card machine, four shards on cuda:0 on one card), as dp rows."""
    from picovdb_tpu_torch.parallel import make_mesh

    count = torch.cuda.device_count()
    devs = [torch.device("cuda", i % count) for i in range(MESH_SHARDS)]
    return make_mesh(MESH_SHARDS // dp, devices=devs, dp=dp)


@contextlib.contextmanager
def dispatch_log(db):
    """Record the query count of every sharded dispatch `db` makes (the
    exact mesh routes, and the sharded IVF searches) while inside."""
    seen = []
    dev = db._dev
    real = dev._mesh_dispatch
    dev._mesh_dispatch = lambda q, k, *a: (
        seen.append(("scan", q.shape[0], k)), real(q, k, *a))[1]
    ivf = db._ivf
    if ivf is not None:
        real_ivf = ivf.search_async
        ivf.search_async = lambda q, k, *a, **kw: (
            seen.append(("ivf", q.shape[0], k)), real_ivf(q, k, *a, **kw))[1]
    try:
        yield seen
    finally:
        del dev._mesh_dispatch
        if ivf is not None:
            del ivf.search_async


def mesh_launches_ok(scan, mesh, family: str, seen) -> str:
    """Every dispatch launched its kernel once a shard per mesh row it used
    (a dp mesh splits Q over its rows): the counted launches must equal
    shards x sum(min(dp, Q)) over the dispatches, leaving out those whose
    k_sel passed SCAN_KSEL_MAX (the host rescore's saturation escalation
    at k = 4 x the band: the plain exact scan, counted in
    WIDE_K_FALLBACKS)."""
    # a mesh across processes: this rank's shards
    shards, dp = len(mesh.local_shards), mesh.shape["dp"]
    wide = sum(kind == "scan" and k + 4 > scan.SCAN_KSEL_MAX
               for kind, _, k in seen)
    want = sum(shards * (1 if kind == "ivf" else min(dp, nq))
               for kind, nq, k in seen
               if kind == "ivf" or k + 4 <= scan.SCAN_KSEL_MAX)
    got = scan.LAUNCHES[family]
    assert got == want and want > 0, (
        f"{family}: {got} launches for {len(seen)} dispatches (want {want})")
    return (f"{family} {got} = {shards} shards x {want // shards} row-calls"
            + (f" (+{wide} wide-k escalations on the plain scan)"
               if wide else ""))


def mesh_serve(torch, scan, db, qdev, qhost, rescored: bool):
    """The counted serving of one store: Q = 1 (host and CUDA-resident:
    a lossy store rescores only the host query) and Q = 64 (a lossy store
    also CUDA-resident), then MESH_Q CUDA-resident queries in 2048-query
    chunks; a lossy store also serves the oracle's queries from the host
    in 128-query batches (its host rescore). Returns (ids of the oracle's
    queries, the CUDA-resident answers as [(queries, (ids, scores))], the
    dispatch log)."""
    with dispatch_log(db) as seen:
        db.query_columnar(qhost[:1], top_k=10)
        # Q = 1 at k 10: the sweeps
        served = [(qdev[:1], db.query_columnar(qdev[:1], top_k=10))]
        db.query_columnar(qhost[:64], top_k=10)
        if rescored:
            served.append((qdev[:64], db.query_columnar(qdev[:64], top_k=10)))
        out = db.query_columnar(qdev, top_k=10, batch_size=2048)
        served.append((qdev, out))
        got = out[0][:MESH_ORACLE_Q]
        if rescored:  # host batches up to RESCORE_MAX_Q rescore on the host
            got = np.concatenate([
                db.query_columnar(qhost[s:s + 128], top_k=10)[0]
                for s in range(0, MESH_ORACLE_Q, 128)])
            assert db.last_query_debug()["rescore"] == "host"
        torch.cuda.synchronize()
    assert (out[0] != None).all()  # noqa: E711
    return got, served, list(seen)


def mesh_plain_check(torch, scan, db, served, storage: str) -> str:
    """Hold a mesh store's kernel route (K4 / K3 / K6 on every shard, at
    the shard's shapes) to its plain version on the same store: the
    answers served at storage precision (CUDA-resident Q = 1, Q = 64 and
    2048-query chunks) against `make_sharded_topk(use_pallas=False)`,
    exact_topk / exact_topk_i8r / _i4r on every shard, merged. The
    quantized routes both select on the int8 query's scores and rescore
    with rescore_exact_i8r / _i4r, so scores agree within MESH_ATOL and
    ids wherever the plain route's k-th / (k+1)-th gap exceeds TOL_GAP."""
    from picovdb_tpu_torch.parallel import sharded_query as tsq

    dev = db._dev
    fn = tsq.make_sharded_topk(dev.mesh, dev.shard_axis, 11,
                               storage_i8=storage == "int8",
                               storage_i4=storage == "int4")
    planes = [dev.mesh_planes(p)
              for p in (dev.vectors, dev.vstore_scale, dev.active)
              if p is not None]
    slot_ids = np.asarray(db._ids, dtype=object)
    held, total, worst = 0, 0, 0.0
    with uncounted(scan):
        for q, (ids, scores) in served:
            for s in range(0, q.shape[0], 1024):
                pv, pi = (t.cpu().numpy() for t in fn(q[s:s + 1024], *planes))
                for r in range(pv.shape[0]):
                    total += 1
                    want = set(slot_ids[pi[r, :10]])
                    if set(ids[s + r]) != want:
                        assert pv[r, 9] - pv[r, 10] <= TOL_GAP, (
                            f"{storage}: query {s + r} of {q.shape[0]}: ids "
                            f"differ from the plain route outside the gap")
                        continue
                    held += 1
                    worst = max(worst, float(np.abs(
                        np.sort(scores[s + r]) - np.sort(pv[r, :10])).max()))
    assert worst <= MESH_ATOL, f"{storage}: scores off by {worst}"
    plain = ("exact_topk" if storage == "float32"
             else f"exact_topk_i{storage[-1]}r")
    return (f"= the plain sharded route ({plain} a shard) on {held}/{total} "
            f"(the rest inside the gap), scores within {worst:.3g}")


def mesh_times(torch, db, qdev, qhost) -> dict:
    """Q = 1 and Q = 64 latency (CUDA events around query_columnar of
    host queries, median of 10) and batch QPS (MESH_Q CUDA-resident
    queries in 2048-query chunks, wall clock after a warm run)."""
    one = cuda_ms(torch, lambda: db.query_columnar(qhost[:1], top_k=10), 10)
    q64 = cuda_ms(torch, lambda: db.query_columnar(qhost[:64], top_k=10), 10)
    db.query_columnar(qdev, top_k=10, batch_size=2048)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    db.query_columnar(qdev, top_k=10, batch_size=2048)
    qps = qdev.shape[0] / (time.perf_counter() - t0)
    return {"q1_ms": one, "q64_ms": q64, "qps": qps}


def fmt_times(t: dict) -> str:
    return (f"{t['qps']:.1f} QPS, Q=1 {t['q1_ms']:.4f} ms, "
            f"Q=64 {t['q64_ms']:.4f} ms")


def merge_share(torch, scan, db, qdev) -> str:
    """The merge's share of one 2048-query chunk on the K4 mesh route: the
    route timed whole, and `merge_topk` alone on the chunk's own per-shard
    slabs (CUDA events, median of 10; launches uncounted)."""
    from picovdb_tpu_torch.ops.exact import normalize_on_device
    from picovdb_tpu_torch.parallel import sharded_query as tsq

    dev = db._dev
    q = normalize_on_device(qdev[:2048])
    fn = tsq.make_sharded_topk(dev.mesh, dev.shard_axis, 10, use_pallas=True,
                               normalize=False)
    with uncounted(scan):
        route = cuda_ms(torch, lambda: fn(q, [dev.vectors], [dev.active]))
        vals, slots = [], []
        for s, d in enumerate(dev.shard_devices):
            v, i = tsq._local_float(q.to(d), dev.vectors[s], dev.active[s],
                                    10, True, None)
            vals.append(v)
            slots.append(i + s * dev.shard_rows)
        merge = cuda_ms(torch, lambda: tsq.merge_topk(vals, slots, 10,
                                                      dev.shard_devices[0]))
    return (f"2048-query chunk {route:.4f} ms on the K4 mesh route, merge "
            f"{merge:.4f} ms of it ({100 * merge / route:.2f} %)")


def ivf_scanned(torch, tivf, x, qn, nprobe: int, n: int, device):
    """(n,) bool on `device`: the rows a ShardedIVF search of the batch
    `qn` scans, shard by shard (the route's own preamble: the batch's hot
    tiles, bounded by g_tiles of its size, and their active rows)."""
    rows = torch.zeros(n, dtype=torch.bool, device=device)
    for s, d in enumerate(x.devices):
        row_mask, hot, n_hot, _ = tivf._probe_preamble(
            qn.to(d), x.centroids[s], x.active[s], x.seg_starts[s],
            x.cluster2tile[s], nprobe=nprobe, nlist=x.nlist,
            g_tiles=x.g_tiles(qn.shape[0], nprobe), cap_ivf=x.cap_shard,
            n_tiles=x.n_tiles, bn=tivf.IVF_BN)
        tiles = torch.zeros(x.n_tiles, dtype=torch.bool, device=d)
        tiles[hot[: int(n_hot)].long()] = True
        scanned = row_mask & tiles.repeat_interleave(tivf.IVF_BN)
        rows[x.slots[s][scanned].to(device)] = True
    return rows


def mesh_oracle_check(got, ov, oi, what: str, floor: float) -> str:
    recall = recall_at_10(got, oi[:, :10], "m")
    assert recall >= floor, f"{what}: recall@10 {recall} < {floor}"
    return f"recall@10 {recall:.4f}"


def phase_mesh(torch, scan, device, rng, card: str) -> dict:
    """Phase 11: mesh stores (`mesh=`) of four shards, one at a time, each
    beside the same store on one device. 11a: 2M x 1024 float32, K4 on
    every shard (scan_mode="fused"), the plain sharded scan, and a dp = 2
    x 2-shard mesh; 11b / 11c: int8 / int4 storage, K3 / K6 on every
    shard, with the host rescore, and their answers at storage precision
    held to the plain sharded route on the same store; 11d: a clustered
    2M x 1024 store, index="ivf", ShardedIVF with K7 on every shard, every
    default-probe answer held to the float64 oracle restricted to the rows
    its batch scanned. Returns the launches of the counted sections,
    summed."""
    from picovdb_tpu_torch import PicoVectorDB
    from picovdb_tpu_torch.ops import ivf as tivf
    from picovdb_tpu_torch.ops.exact import normalize_on_device

    t_phase = time.perf_counter()
    n, dim = MESH_N, DIM
    dev0 = device
    where = ("one shard a card" if torch.cuda.device_count() >= MESH_SHARDS
             else f"{MESH_SHARDS} shards on one card")
    total = {}

    def add(counts):
        for key, v in counts.items():
            if key != "shapes":
                total[key] = total.get(key, 0) + v

    corpus = rng.standard_normal((n, dim), dtype=np.float32)
    corpus /= np.linalg.norm(corpus, axis=1, keepdims=True)
    ids = [f"m{i}" for i in range(n)]
    near = corpus[rng.integers(0, n, MESH_Q)]
    qhost = near + 0.01 * rng.standard_normal(near.shape, dtype=np.float32)
    qdev = torch.from_numpy(qhost).to(dev0)
    corpus_dev = torch.from_numpy(corpus).to(dev0)
    chunks = [(s, corpus_dev[s:s + 131_072]) for s in range(0, n, 131_072)]
    ov, oi = oracle_masked(torch, chunks, qdev[:MESH_ORACLE_Q], None)
    del chunks, corpus_dev
    torch.cuda.empty_cache()
    tmp = tempfile.mkdtemp(prefix="picovdb_smoke_", dir=os.getcwd())

    def line(text):
        log(f"phase 11: {text}; card {card}")

    def store(name, **kw):
        db = PicoVectorDB(embedding_dim=dim, index="exact",
                          storage_file=os.path.join(tmp, name), **kw)
        db.upsert_columnar(corpus, ids=ids, copy=False)
        db.rebuild_index()
        torch.cuda.synchronize()
        return db

    # 11a: float32, K4 on every shard, beside one device and the plain scan
    single = store("single", device=dev0, scan_mode="fused")
    s_ids, _, _ = mesh_serve(torch, scan, single, qdev, qhost, False)
    assert single.last_query_debug()["strategy"] == "pallas_fused"
    s_times = mesh_times(torch, single, qdev, qhost)
    del single
    torch.cuda.empty_cache()
    for dp in (1, 2):
        mesh = mesh_grid(torch, dp)
        db = store(f"mesh_dp{dp}", mesh=mesh, scan_mode="fused")
        scan.reset_launch_counts()  # count this path's launches only
        got, _, seen = mesh_serve(torch, scan, db, qdev, qhost, False)
        counts = launch_counts(scan)
        assert db.last_query_debug()["strategy"] == "sharded_scan_pallas"
        assert k4_launches_ok(scan, counts), "a K4 launch missed the wgmma scan"
        launches = mesh_launches_ok(scan, mesh, "scan_topk", seen)
        add(counts)
        rec_s = mesh_oracle_check(got, ov, oi, f"11a dp={dp}", 0.99)
        bad = ids_off_oracle(got, "m", ov, oi)
        same = sum(set(a) != set(b) for a, b, v in zip(got, s_ids, ov)
                   if v[9] - v[10] > TOL_GAP)
        assert bad == 0 and same == 0, (bad, same)
        t = mesh_times(torch, db, qdev, qhost)
        extra = ""
        if dp == 1:
            extra = "; " + merge_share(torch, scan, db, qdev)
            db._dev.use_pallas, db._dev.scan_mode = False, "auto"
            with uncounted(scan):
                db.query_columnar(qhost[:1], top_k=10)
                assert db.last_query_debug()["strategy"] == "sharded_scan"
                extra += ("; the plain sharded scan (route sharded_scan) "
                          + fmt_times(mesh_times(torch, db, qdev, qhost)))
        line(
            f"11a {n} x {dim} float32 on a {dp} x {mesh.shape['shard']} mesh"
            f" ({where}), route sharded_scan_pallas (K4 a shard): {rec_s}, "
            f"ids = float64 oracle and = the one-device store outside the "
            f"gap on {MESH_ORACLE_Q}/{MESH_ORACLE_Q}; {fmt_times(t)} (one "
            f"device, route pallas_fused: {fmt_times(s_times)}); launches "
            f"{launches}{extra}")
        del db
        torch.cuda.empty_cache()

    # 11b / 11c: int8 / int4 storage, K3 / K6 on every shard, host rescore
    for sd in ("int8", "int4"):
        single = store(f"single_{sd}", device=dev0, storage_dtype=sd,
                       scan_mode="fused")
        s_times = mesh_times(torch, single, qdev, qhost)
        s_route = single.last_query_debug()["strategy"]
        del single
        torch.cuda.empty_cache()
        mesh = mesh_grid(torch)
        db = store(f"mesh_{sd}", mesh=mesh, storage_dtype=sd,
                   scan_mode="fused")
        scan.reset_launch_counts()
        got, served, seen = mesh_serve(torch, scan, db, qdev, qhost, True)
        counts = launch_counts(scan)
        route = db.last_query_debug()["strategy"]
        assert route == f"sharded_scan_i{sd[-1]}stor_pallas", route
        launches = mesh_launches_ok(scan, mesh, MESH_FAMILY[sd], seen)
        add(counts)
        plain = mesh_plain_check(torch, scan, db, served, sd)
        rec_s = mesh_oracle_check(got, ov, oi, f"11 {sd}", 0.99)
        rec_dev = recall_at_10(served[-1][1][0][:MESH_ORACLE_Q], oi[:, :10],
                               "m")
        t = mesh_times(torch, db, qdev, qhost)
        line(
            f"11{'b' if sd == 'int8' else 'c'} {n} x {dim} {sd} on a 1 x "
            f"{MESH_SHARDS} mesh ({where}), route {route}: host-rescored "
            f"{rec_s} (2048-query chunks at storage precision: "
            f"{rec_dev:.4f}); Q = 1, Q = 64 and the chunks at storage "
            f"precision {plain}; {fmt_times(t)} (one device, route {s_route}: "
            f"{fmt_times(s_times)}); launches {launches}, by shape "
            f"{counts['shapes'].get(MESH_FAMILY[sd])}")
        del db
        torch.cuda.empty_cache()
    del corpus, ids

    # 11d: clustered 2M x 1024, index="ivf": ShardedIVF, K7 on every shard
    seed = int(rng.integers(1 << 31))
    mix = np.empty((n, dim), dtype=np.float32)
    for s, rows in mixture_chunks(torch, dev0, n, dim, seed):
        mix[s:s + rows.shape[0]] = rows.cpu().numpy()
    qi = mix[rng.integers(0, n, 2048)] + 0.01 * rng.standard_normal(
        (2048, dim), dtype=np.float32)
    mesh = mesh_grid(torch)
    db = PicoVectorDB(embedding_dim=dim, index="ivf", mesh=mesh,
                      storage_file=os.path.join(tmp, "mesh_ivf"))
    db.upsert_columnar(mix, ids=[f"m{i}" for i in range(n)], copy=False)
    t0 = time.perf_counter()
    db.rebuild_index()
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    op = db.last_query_debug()["ann_operating_point"]
    assert type(db._ivf).__name__ == "ShardedIVF" and op["layout"] == "classic"
    scan.reset_launch_counts()
    with dispatch_log(db) as seen:
        hits1 = db.query(qi[0], top_k=10)  # Q = 1: K7's sweep on every shard
        got1, _ = db.query_columnar(qi[:64], top_k=10)
        assert db.last_query_debug()["strategy"] == "ivf"
        gotb, _ = db.query_columnar(qi, top_k=10, batch_size=512)
        full, _ = db.query_columnar(qi[:64], top_k=10, ef_search=10**6)
        assert db.last_query_debug()["strategy"] == "ivf"
        torch.cuda.synchronize()
    counts = launch_counts(scan)
    launches = mesh_launches_ok(scan, mesh, "ivf_scan_topk", seen)
    assert [nq for kind, nq, _ in seen] == [1, 64] + [512] * 4 + [64], seen
    add(counts)
    mix_dev = torch.from_numpy(mix).to(dev0)
    chunks = [(s, mix_dev[s:s + 131_072]) for s in range(0, n, 131_072)]
    qn = normalize_on_device(torch.from_numpy(qi).to(dev0))
    fv, fi = oracle_masked(torch, chunks, qn[:64], None)
    bad_full = ids_off_oracle(full, "m", fv, fi)
    assert bad_full == 0, f"{bad_full} of 64 full-probe id sets differ"
    recall = recall_at_10(got1, fi[:, :10], "m")
    assert recall >= 0.95, f"11d recall@10 {recall} < 0.95"
    # every default-probe answer (Q = 1, Q = 64 and the 512-query batches)
    # against the oracle restricted to the rows its batch scanned
    x = db._ivf
    npb = tivf.ef_to_nprobe(db._ef_search, x.nlist)
    ids1 = np.array([[h["_id_"] for h in hits1]], dtype=object)
    bad = 0
    for lo, hi, got in ((0, 1, ids1), (0, 64, got1), *(
            (b, b + 512, gotb[b:b + 512]) for b in range(0, 2048, 512))):
        rows = ivf_scanned(torch, tivf, x, qn[lo:hi], npb, n, dev0)
        bad += ids_off_oracle(got, "m", *oracle_masked(
            torch, chunks, qn[lo:hi], rows.expand(hi - lo, n)))
    assert bad == 0, f"{bad} default-probe id sets differ (restricted)"
    del mix_dev, chunks
    t = mesh_times(torch, db, torch.from_numpy(qi).to(dev0), qi)
    line(
        f"11d clustered {n} x {dim} float32, index=ivf on a 1 x "
        f"{MESH_SHARDS} mesh ({where}): ShardedIVF built in {build_s:.2f} s,"
        f" nlist {op['nlist']}, nprobe {op['nprobe_default']}, {x.n_tiles} "
        f"tiles a shard; full probe = float64 oracle outside the gap on "
        f"64/64; default probe recall@10 {recall:.4f}, ids = the oracle "
        f"restricted to each batch's scanned rows on 1 + 64 + 2048 queries "
        f"(Q = 1, Q = 64, 512-query batches); {fmt_times(t)} (2048 "
        f"queries in 2048-query chunks); launches {launches}, by shape "
        f"{counts['shapes'].get('ivf_scan_topk')}")
    del db, x, mix
    torch.cuda.empty_cache()
    shutil.rmtree(tmp)
    scope = ("" if torch.cuda.device_count() >= MESH_SHARDS else
             ": a run on one card checks the sharding, routing, per-shard "
             "launches and the merge, not scaling across cards")
    log(f"phase 11: mesh stores done in {time.perf_counter() - t_phase:.1f} s"
        f" ({where}{scope})")
    return total


# ---------------------------------------------------------------------------
# Phase 12: one store across processes (parallel/multihost.py)
# ---------------------------------------------------------------------------

MP_N = MESH_N  # 12a: float32 rows, in save(shards=world) files (8.4 GB)
MP_I8_N = 1_000_000  # 12b: int8 storage, upserted on every rank
MP_I4_N = 1 << 22  # 12c: 4,194,304 packed int4 rows, a shard a rank
MP_IVF_N = 2_000_000  # 12d: ShardedIVF over a gaussian mixture
MP_CHUNK = 262_144  # rows a seeded generator makes at a time
MP_TIMEOUT_S = 900  # every rank of phase 12 must end within this


def seeded_chunks(torch, device, seed: int, lo: int, hi: int, dim: int):
    """Unit rows [lo, hi) of a corpus made on `device` MP_CHUNK rows at a
    time, chunk c from a generator of its own (seed + c), so that any
    process makes any range of it alike. Yields (start, rows f32)."""
    from picovdb_tpu_torch.ops.exact import normalize_on_device

    for c in range(lo // MP_CHUNK, -(-hi // MP_CHUNK)):
        g = torch.Generator(device=device).manual_seed(seed + c)
        rows = normalize_on_device(torch.randn(MP_CHUNK, dim, generator=g,
                                               device=device))
        a, b = max(lo, c * MP_CHUNK), min(hi, (c + 1) * MP_CHUNK)
        yield a, rows[a - c * MP_CHUNK:b - c * MP_CHUNK]


def host_rows(torch, chunks, n: int, dim: int) -> np.ndarray:
    out = np.empty((n, dim), dtype=np.float32)
    for a, rows in chunks:
        out[a:a + rows.shape[0]] = rows.cpu().numpy()
    return out


def mp_checkpoint(torch, device, base: str, n: int, dim: int, world: int,
                  seed: int, rng):
    """Write 12a's checkpoint once, chunk by chunk, in save(shards=world)'s
    layout (file f: rows [f * per, (f + 1) * per), ids "m<row>"), and the
    queries (MESH_Q rows plus noise) with their float64 top-13 over the
    first MESH_ORACLE_Q. Returns (queries, oracle scores, oracle rows)."""
    from picovdb_tpu_torch import K_ID, persistence

    per = persistence.shard_split_rows(n, world)
    files = [np.lib.format.open_memmap(
        persistence.shard_path(base, f, world), mode="w+", dtype=np.float32,
        shape=(max(0, min(n, (f + 1) * per) - f * per), dim))
        for f in range(world)]
    pick = np.sort(rng.integers(0, n, MESH_Q))
    near = np.empty((MESH_Q, dim), dtype=np.float32)
    for a, rows in seeded_chunks(torch, device, seed, 0, n, dim):
        host = rows.cpu().numpy()
        b = a + host.shape[0]
        for f in range(world):
            lo, hi = max(a, f * per), min(b, (f + 1) * per)
            if lo < hi:
                files[f][lo - f * per:hi - f * per] = host[lo - a:hi - a]
        sel = (pick >= a) & (pick < b)
        near[sel] = host[pick[sel] - a]
    for f in files:
        f.flush()
    del files
    ids = [f"m{i}" for i in range(n)]
    persistence.save_ids_meta_atomic(base, ids, [{K_ID: i} for i in ids], {},
                                     dim)
    qhost = near + 0.01 * rng.standard_normal(near.shape, dtype=np.float32)
    ov, oi = oracle_masked(
        torch, seeded_chunks(torch, device, seed, 0, n, dim),
        torch.from_numpy(qhost[:MESH_ORACLE_Q]).to(device), None, k=13)
    return qhost, ov, oi


def phase_multiprocess(torch, scan, card: str, trace_dir=None) -> dict:
    """Phase 12: one store across processes. The parent writes 12a's
    checkpoint and spawns the ranks (`--mp-rank`), one a card under NCCL
    on two or more cards, else two on cuda:0 under gloo (NCCL refuses two
    ranks on one device); each rank runs `mp_rank_main` and any rank's
    failure or a timeout fails the phase. Returns the launches summed over
    the ranks."""
    count = torch.cuda.device_count()
    world, backend = (count, "nccl") if count >= 2 else (2, "gloo")
    where = ("one rank a card" if backend == "nccl" else
             "two ranks on cuda:0, collectives staged through host memory")
    t_phase = time.perf_counter()
    rng = np.random.default_rng(SEED + 12)
    seeds = {key: int(rng.integers(1 << 30)) for key in "abcdm"}
    tmp = tempfile.mkdtemp(prefix="picovdb_smoke_mp_", dir=os.getcwd())
    base = os.path.join(tmp, "a")
    t0 = time.perf_counter()
    qhost, ov, oi = mp_checkpoint(torch, torch.device("cuda:0"), base, MP_N,
                                  DIM, world, seeds["a"], rng)
    np.savez(os.path.join(tmp, "q12a.npz"), q=qhost, ov=ov, oi=oi)
    log(f"phase 12: 12a's checkpoint, {MP_N} x {DIM} float32 in {world} "
        f"shard files, written in {time.perf_counter() - t0:.2f} s")
    cfg = {"world": world, "backend": backend, "tmp": tmp, "base": base,
           "device": "cuda:0" if backend == "gloo" else None, "dim": DIM,
           "n": [MP_N, MP_I8_N, MP_I4_N, MP_IVF_N], "seeds": seeds,
           "trace_dir": trace_dir}
    cfg_path = os.path.join(tmp, "cfg.json")
    with open(cfg_path, "w") as f:
        json.dump(cfg, f)
    results = run_ranks(world, backend, cfg_path, tmp)
    shutil.rmtree(tmp)
    scope = ("" if backend == "nccl" else
             ": two ranks time-slice one card, so its times check the "
             "path, not the deployment")
    log(f"phase 12: stores across {world} processes done in "
        f"{time.perf_counter() - t_phase:.1f} s ({where}{scope}); launches "
        f"by rank {results}")
    return {key: sum(r.get(key, 0) for r in results)
            for key in set().union(*results)}


def run_ranks(world: int, backend: str, cfg_path: str, tmp: str) -> list:
    """Start `world` ranks of this script (`--mp-rank r port cfg`), each
    writing its output to a file, wait for all of them within
    MP_TIMEOUT_S, forward their lines, and return each rank's launches.
    Raises if a rank fails or the time runs out (every rank is killed)."""
    import socket

    sock = socket.socket()
    sock.bind(("127.0.0.1", 0))
    port = sock.getsockname()[1]
    sock.close()
    procs, logs = [], []
    for r in range(world):
        env = dict(os.environ, LOCAL_RANK=str(r))
        logs.append(open(os.path.join(tmp, f"rank{r}.log"), "w+"))
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--mp-rank", str(r),
             str(port), cfg_path], stdout=logs[-1],
            stderr=subprocess.STDOUT, env=env))
    deadline = time.perf_counter() + MP_TIMEOUT_S
    timed_out = False
    try:
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.perf_counter()))
    except subprocess.TimeoutExpired:
        timed_out = True
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, f in enumerate(logs):
        f.seek(0)
        for text in f.read().splitlines():
            log(text)
        f.close()
    assert not timed_out, f"phase 12: a rank ran past {MP_TIMEOUT_S} s"
    for r, p in enumerate(procs):
        assert p.returncode == 0, f"phase 12: rank {r} exited {p.returncode}"
    out = []
    for r in range(world):
        with open(os.path.join(tmp, f"rank{r}.json")) as f:
            out.append(json.load(f))
    return out


def mp_rank_main(torch, rank: int, port: int, cfg_path: str) -> int:
    """One rank of phase 12: join the group, build the pod mesh over this
    rank's card and serve 12a-12d on it, writing its launches."""
    import torch.distributed as dist

    from picovdb_tpu_torch.ops import scan
    from picovdb_tpu_torch.parallel.multihost import (
        barrier,
        init_distributed,
        pod_mesh,
    )

    with open(cfg_path) as f:
        cfg = json.load(f)
    world, backend = cfg["world"], cfg["backend"]
    init_distributed(f"tcp://127.0.0.1:{port}", world_size=world, rank=rank,
                     backend=backend, timeout_s=MP_TIMEOUT_S)
    mesh = pod_mesh(devices=None if cfg["device"] is None
                    else [torch.device(cfg["device"])])
    tag = f"phase 12 [rank {rank}/{world}, {backend}]"
    card = card_line() if mesh.first.type == "cuda" else "cpu"

    def say(text):
        log(f"{tag} {text}; card {card}")

    total = {}
    for run in (mp_f32, mp_int8, mp_int4, mp_ivf):
        counts = run(torch, scan, mesh, cfg, say)
        for key, v in counts.items():
            if key != "shapes":
                total[key] = total.get(key, 0) + v
        torch.cuda.empty_cache()
    with open(os.path.join(cfg["tmp"], f"rank{rank}.json"), "w") as f:
        json.dump(total, f)
    barrier(mesh)
    dist.destroy_process_group()
    return 0


def mp_same_everywhere(mesh, arr) -> bool:
    """Whether every rank holds the same `arr` (a digest, all-gathered)."""
    import hashlib

    import torch.distributed as dist

    digest = hashlib.md5(np.asarray(arr).astype(str).tobytes()).hexdigest()
    every = [None] * mesh.world_size
    dist.all_gather_object(every, digest)
    return len(set(every)) == 1


def mp_sync(torch, mesh) -> None:
    from picovdb_tpu_torch.parallel.multihost import barrier

    if mesh.first.type == "cuda":
        torch.cuda.synchronize(mesh.first)
    barrier(mesh)


def mp_times(torch, mesh, db, qdev, qhost) -> dict:
    """Q = 1 and Q = 64 latency (CUDA events around query_columnar of host
    queries, median of 10, every rank calling) and batch QPS: the
    CUDA-resident queries in 2048-query chunks between two barriers, on
    this rank's clock, after a warm run."""
    one = cuda_ms(torch, lambda: db.query_columnar(qhost[:1], top_k=10), 10)
    q64 = cuda_ms(torch, lambda: db.query_columnar(qhost[:64], top_k=10), 10)
    db.query_columnar(qdev, top_k=10, batch_size=2048)
    mp_sync(torch, mesh)
    t0 = time.perf_counter()
    db.query_columnar(qdev, top_k=10, batch_size=2048)
    mp_sync(torch, mesh)
    return {"q1_ms": one, "q64_ms": q64,
            "qps": qdev.shape[0] / (time.perf_counter() - t0)}


def oracle_update(ov, oi, qn, drop, add_rows, add_ids, k: int = 11):
    """A float64 top-k after a mutation epoch, from the old top-13 (ov,
    oi): the dropped rows leave, the added rows (new or rewritten) enter
    with their exact scores. Exact while the drops leave k of the 13."""
    v = np.where(np.isin(oi, drop), -np.inf, ov)
    add = qn.astype(np.float64) @ add_rows.astype(np.float64).T
    v = np.concatenate([v, add], 1)
    i = np.concatenate([oi, np.broadcast_to(add_ids, add.shape)], 1)
    order = np.lexsort((i, -v), axis=1)[:, :k]
    return np.take_along_axis(v, order, 1), np.take_along_axis(i, order, 1)


def own_shard_k4(torch, scan, db, q) -> str:
    """K4 on this rank's first shard (Q = 64, k_sel 14) against its plain
    version on the same inputs, both timed (launches uncounted)."""
    dev = db._dev
    s = dev.mesh.local_shards[0]
    v, m = dev.vectors[s], dev.active[s]
    with uncounted(scan):
        got = scan.fused_topk(q, v, m, 14)
        ref = scan.scan_topk_plain(q, v, None, m, 14)
        err = exact_err(torch, got[0], ref[0])
        assert err <= TOL_SCORE, f"K4 off its plain version by {err}"
        ms = cuda_ms(torch, lambda: scan.fused_topk(q, v, m, 14))
        plain = cuda_ms(torch, lambda: scan.scan_topk_plain(q, v, None, m,
                                                            14), 3)
    return (f"K4 on its own shard ({v.shape[0]} rows, Q = {q.shape[0]}, "
            f"k_sel 14) {ms:.4f} ms, its plain version {plain:.4f} ms, max "
            f"|err| {err:.3g}")


def mp_f32(torch, scan, mesh, cfg, say) -> dict:
    """12a: the checkpoint loads distributed (each rank reads its file),
    serves with K4 a local shard, takes a mutation epoch, saves
    distributed and reloads."""
    from picovdb_tpu_torch import K_ID, K_VECTOR, PicoVectorDB
    from picovdb_tpu_torch.ops.exact import normalize_on_device
    from picovdb_tpu_torch.parallel import sharded_query as tsq

    n, dim = cfg["n"][0], cfg["dim"]
    z = np.load(os.path.join(cfg["tmp"], "q12a.npz"))
    qhost, ov, oi = z["q"], z["ov"], z["oi"]
    mp_sync(torch, mesh)
    t0 = time.perf_counter()

    def load():
        return PicoVectorDB(embedding_dim=dim, index="exact", mesh=mesh,
                            storage_file=cfg["base"], scan_mode="fused")

    db = load()
    mp_sync(torch, mesh)
    load_s = time.perf_counter() - t0
    assert db._host_lazy and db.count() == n
    resident = sum(t.numel() * t.element_size()
                   for t in db._dev.vectors + db._dev.active if t is not None)
    qdev = torch.from_numpy(qhost).to(mesh.first)
    scan.reset_launch_counts()  # count this path's launches only
    got, served, seen = mesh_serve(torch, scan, db, qdev, qhost, False)
    counts = launch_counts(scan)
    assert db.last_query_debug()["strategy"] == "sharded_scan_pallas"
    assert k4_launches_ok(scan, counts), "a K4 launch missed the wgmma scan"
    launches = mesh_launches_ok(scan, mesh, "scan_topk", seen)
    rec = mesh_oracle_check(got, ov, oi, "12a", 0.99)
    bad = ids_off_oracle(got, "m", ov, oi)
    assert bad == 0, f"12a: {bad} id sets differ from the oracle"
    assert mp_same_everywhere(mesh, served[-1][1][0]), "ranks disagree"
    plain = mesh_plain_check(torch, scan, db, served, "float32")
    t = mp_times(torch, mesh, db, qdev, qhost)
    q = normalize_on_device(qdev[:2048])
    fn = tsq.make_sharded_topk(mesh, "shard", 10, use_pallas=True,
                               normalize=False)
    dev = db._dev
    with uncounted(scan):
        route = cuda_ms(torch, lambda: fn(q, [dev.vectors], [dev.active]), 3)
        v, i = fn(q, [dev.vectors], [dev.active])
        merge = cuda_ms(torch, lambda: tsq.merge_ranks(mesh, v, i, 10))
    own = own_shard_k4(torch, scan, db, q[:64])
    if cfg.get("trace_dir"):  # `--multiprocess`: where a rank's chunk waits
        with uncounted(scan):
            trace = trace_chunks(
                torch, lambda: db.query_columnar(qdev[:2048], top_k=10),
                path=os.path.join(cfg["trace_dir"],
                                  f"trace_mp_rank{mesh.rank}.json"))
    say(f"12a {n} x {dim} float32 loaded from this rank's file in "
        f"{load_s:.2f} s, {resident / 2**30:.2f} GiB resident here, route "
        f"sharded_scan_pallas (K4 a local shard): {rec}, ids = the float64 "
        f"oracle on {MESH_ORACLE_Q}/{MESH_ORACLE_Q} and the same on every "
        f"rank; {plain}; {fmt_times(t)}; a 2048-query chunk {route:.4f} ms, "
        f"all_gather + merge {merge:.4f} ms of it "
        f"({100 * merge / route:.2f} %); {own}; launches {launches}")
    if cfg.get("trace_dir"):
        say(f"12a {trace}")

    mg = np.random.default_rng(cfg["seeds"]["m"])
    newv = mg.standard_normal((5, dim)).astype(np.float32)
    newv /= np.linalg.norm(newv, axis=1, keepdims=True)
    db.upsert([{K_ID: "m2", K_VECTOR: newv[0]}]
              + [{K_ID: f"m{n + j}", K_VECTOR: newv[1 + j]} for j in range(4)])
    db.delete(["m5"])
    qn = qhost[:MESH_ORACLE_Q] / np.linalg.norm(qhost[:MESH_ORACLE_Q], axis=1,
                                                keepdims=True)
    ov2, oi2 = oracle_update(ov, oi, qn, [2, 5], newv,
                             np.array([2] + [n + j for j in range(4)]))
    want = db.query_columnar(qhost[:MESH_ORACLE_Q], top_k=10)
    bad = ids_off_oracle(want[0], "m", ov2, oi2)
    assert bad == 0, f"12a after the mutation epoch: {bad} id sets differ"
    assert db.query(newv[1], top_k=1)[0][K_ID] == f"m{n}"
    mode = db._last_sync_mode
    mp_sync(torch, mesh)
    t0 = time.perf_counter()
    db.save()
    save_s = time.perf_counter() - t0
    del db
    torch.cuda.empty_cache()
    mp_sync(torch, mesh)
    t0 = time.perf_counter()
    db = load()
    mp_sync(torch, mesh)
    reload_s = time.perf_counter() - t0
    assert db.count() == n + 3
    again = db.query_columnar(qhost[:MESH_ORACLE_Q], top_k=10)
    assert (again[0] == want[0]).all(), "the reloaded store answers otherwise"
    np.testing.assert_allclose(again[1], want[1], rtol=0, atol=1e-6)
    say(f"12a mutation epoch (update 1, delete 1, append 4; sync {mode}): "
        f"ids = the updated oracle on {MESH_ORACLE_Q}/{MESH_ORACLE_Q}; "
        f"distributed save {save_s:.2f} s, reload {reload_s:.2f} s, the "
        f"reloaded store answers the same")
    del db
    return counts


def mp_int8(torch, scan, mesh, cfg, say) -> dict:
    """12b: int8 storage upserted on every rank (each holds the host
    matrix), K3 a local shard under the host rescore, the storage-precision
    answers held to the plain sharded route, and the distributed save's
    dequantized float32 shards."""
    from picovdb_tpu_torch import K_ID, PicoVectorDB, persistence

    n, dim, world = cfg["n"][1], cfg["dim"], mesh.world_size
    seed = cfg["seeds"]["b"]
    corpus = host_rows(torch, seeded_chunks(torch, mesh.first, seed, 0, n,
                                            dim), n, dim)
    mg = np.random.default_rng(seed)
    near = corpus[mg.integers(0, n, 2048)]
    qhost = near + 0.01 * mg.standard_normal(near.shape, dtype=np.float32)
    qdev = torch.from_numpy(qhost).to(mesh.first)
    base = os.path.join(cfg["tmp"], "b")
    db = PicoVectorDB(embedding_dim=dim, index="exact", mesh=mesh,
                      storage_file=base, storage_dtype="int8",
                      scan_mode="fused")
    db.upsert_columnar(corpus, ids=[f"b{i}" for i in range(n)], copy=False)
    db.rebuild_index()
    ov, oi = oracle_masked(torch, ((s, torch.from_numpy(
        corpus[s:s + MP_CHUNK]).to(mesh.first)) for s in range(0, n,
                                                                MP_CHUNK)),
        qdev[:128], None)
    scan.reset_launch_counts()
    with dispatch_log(db) as seen:
        db.query_columnar(qhost[:1], top_k=10)  # the sweep, host rescore
        assert db.last_query_debug()["rescore"] == "host"
        db.query_columnar(qhost[:64], top_k=10)  # the tensor-core scan
        got = db.query_columnar(qhost[:128], top_k=10)[0]
        served = [(qdev[:1], db.query_columnar(qdev[:1], top_k=10)),
                  (qdev[:64], db.query_columnar(qdev[:64], top_k=10)),
                  (qdev, db.query_columnar(qdev, top_k=10, batch_size=2048))]
        torch.cuda.synchronize()
    counts = launch_counts(scan)
    assert db.last_query_debug()["strategy"] == "sharded_scan_i8stor_pallas"
    launches = mesh_launches_ok(scan, mesh, "scan_topk_i8", seen)
    assert (counts["scan_topk_i8_sweep"] > 0
            and counts["scan_topk_i8_wgmma"] > 0), counts
    rec = mesh_oracle_check(got, ov, oi, "12b", 0.99)
    assert ids_off_oracle(got, "b", ov, oi) == 0
    plain = mesh_plain_check(torch, scan, db, served, "int8")
    assert mp_same_everywhere(mesh, served[-1][1][0]), "ranks disagree"
    t0 = time.perf_counter()
    db.save()
    save_s = time.perf_counter() - t0
    per = persistence.shard_split_rows(n, world)
    mine = np.load(persistence.shard_path(base, mesh.rank, world))
    lo = mesh.rank * per
    err = float(np.abs(mine - corpus[lo:lo + mine.shape[0]]).max())
    assert err <= 2e-2, f"12b: the saved shard is off its rows by {err}"
    del db
    torch.cuda.empty_cache()
    db = PicoVectorDB(embedding_dim=dim, index="exact", mesh=mesh,
                      storage_file=base)
    checked = (0, n // 2 + 3, n - 1)
    for i in checked:
        assert db.query(corpus[i], top_k=1)[0][K_ID] == f"b{i}", i
    say(f"12b {n} x {dim} int8 upserted on every rank, route "
        f"sharded_scan_i8stor_pallas (K3 a local shard: the sweep at Q = 1, "
        f"the tensor-core scan at Q = 64): host-rescored {rec}; Q = 1, "
        f"Q = 64 and the chunks at storage precision {plain}; save {save_s:.2f}"
        f" s, this rank's float32 shard within {err:.4f} of its rows, the "
        f"reload ranks rows {checked} first; launches {launches}, by shape "
        f"{counts['shapes'].get('scan_topk_i8')}")
    del db, corpus
    return counts


@contextlib.contextmanager
def plain_k6(scan, tsq):
    """K6's plain version in the sharded route's place (its selection
    only; the rescore stays)."""
    real = tsq.fused_topk_i4
    tsq.fused_topk_i4 = lambda q8, v, s, m, k: scan.scan_topk_plain(
        q8, v, s, m, k, int4=True)
    try:
        yield
    finally:
        tsq.fused_topk_i4 = real


def mp_int4(torch, scan, mesh, cfg, say) -> dict:
    """12c: packed int4 rows, a shard a rank made on its card, through
    make_sharded_topk(storage_i4=True): K6 a local shard at Q = 1 and
    Q = 2048, the answers bit for bit the route with K6's plain version."""
    from picovdb_tpu_torch.ops.exact import normalize_on_device
    from picovdb_tpu_torch.parallel import sharded_query as tsq

    n, dim = cfg["n"][2], cfg["dim"]
    shards = mesh.shape["shard"]
    rl = n // shards
    v4, sc, mk = ([None] * shards for _ in range(3))
    for s in mesh.local_shards:
        dev = mesh.row(0)[s]
        v4[s] = torch.empty((rl, dim // 2), dtype=torch.int8, device=dev)
        sc[s] = torch.empty((rl,), dtype=torch.float32, device=dev)
        for a, rows in seeded_chunks(torch, dev, cfg["seeds"]["c"], s * rl,
                                     (s + 1) * rl, dim):
            b = a - s * rl + rows.shape[0]
            v4[s][a - s * rl:b], sc[s][a - s * rl:b] = \
                scan.quantize_rows_i4(rows)
        mk[s] = torch.ones(rl, dtype=torch.bool, device=dev)
    g = torch.Generator(device=mesh.first).manual_seed(cfg["seeds"]["c"] - 1)
    q = normalize_on_device(torch.randn(2048, dim, generator=g,
                                        device=mesh.first))
    fn = tsq.make_sharded_topk(mesh, "shard", 10, use_pallas=True,
                               storage_i4=True)
    scan.reset_launch_counts()
    outs = [fn(q[:1], [v4], [sc], [mk]), fn(q, [v4], [sc], [mk])]
    torch.cuda.synchronize()
    counts = launch_counts(scan)
    local = len(mesh.local_shards)
    assert counts["scan_topk_i4"] == 2 * local, counts["scan_topk_i4"]
    assert (counts["scan_topk_i4_sweep"] == local
            and counts["scan_topk_i4_wgmma"] == local), counts
    with uncounted(scan):
        ms = cuda_ms(torch, lambda: fn(q, [v4], [sc], [mk]), 3)
        with plain_k6(scan, tsq):
            refs = [fn(q[:1], [v4], [sc], [mk]), fn(q, [v4], [sc], [mk])]
            t0 = time.perf_counter()
            fn(q, [v4], [sc], [mk])
            mp_sync(torch, mesh)
            plain_ms = (time.perf_counter() - t0) * 1e3
    for (gv, gi), (rv, ri) in zip(outs, refs):
        assert torch.equal(gv, rv) and torch.equal(gi, ri), \
            "12c: K6's route differs from the plain version's"
    assert mp_same_everywhere(mesh, outs[1][1].cpu().numpy())
    say(f"12c {n} x {dim} int4 ({rl} packed rows a shard), "
        f"make_sharded_topk(storage_i4=True) with K6 a local shard (the "
        f"sweep at Q = 1, the tensor-core scan at Q = 2048): scores and rows "
        f"bit for bit the route with K6's plain version; Q = 2048 "
        f"{ms:.4f} ms (plain version {plain_ms:.1f} ms, one run); launches "
        f"{counts['scan_topk_i4']} = {local} local shards x 2 calls")
    del v4, sc, mk
    return counts


@contextlib.contextmanager
def plain_k7(tivf):
    real = tivf.ivf_scan_topk
    tivf.ivf_scan_topk = tivf.ivf_scan_topk_plain
    try:
        yield
    finally:
        tivf.ivf_scan_topk = real


def mp_ivf(torch, scan, mesh, cfg, say) -> dict:
    """12d: ShardedIVF over a clustered corpus, every rank building from
    the host matrix and uploading its own shards: K7 a local shard; the
    full probe equals the float64 oracle, before and after one
    incremental update epoch; K7's answers equal its plain version's."""
    from picovdb_tpu_torch.constants import HNSW_EFS
    from picovdb_tpu_torch.ops import ivf as tivf
    from picovdb_tpu_torch.parallel.ivf_mesh import ShardedIVF

    n, dim = cfg["n"][3], cfg["dim"]
    seed = cfg["seeds"]["d"]
    mix = host_rows(torch, mixture_chunks(torch, mesh.first, n, dim, seed),
                    n, dim)
    mg = np.random.default_rng(seed)
    qi = mix[mg.integers(0, n, 64)] + 0.01 * mg.standard_normal(
        (64, dim), dtype=np.float32)
    qn = qi / np.linalg.norm(qi, axis=1, keepdims=True)
    mp_sync(torch, mesh)
    t0 = time.perf_counter()
    x = ShardedIVF.build(mix, np.ones(n, dtype=bool), mesh, dim=dim)
    mp_sync(torch, mesh)
    build_s = time.perf_counter() - t0

    def chunks(rows):
        return ((s, torch.from_numpy(rows[s:s + MP_CHUNK]).to(mesh.first))
                for s in range(0, rows.shape[0], MP_CHUNK))

    ov, oi = oracle_masked(torch, chunks(mix), torch.from_numpy(qi).to(
        mesh.first), None, k=13)
    searches = ((qi[:1], HNSW_EFS),  # Q = 1: K7's sweep
                (qi, HNSW_EFS),  # Q = 64 at the default probe: its template
                (qi, 10**6))  # the full probe
    scan.reset_launch_counts()
    got = [x.search(q, 10, ef=ef, dev=None) for q, ef in searches]
    torch.cuda.synchronize()
    counts = launch_counts(scan)
    local = len(mesh.local_shards)
    assert counts["ivf_scan_topk"] == 3 * local, counts["ivf_scan_topk"]
    assert counts["ivf_scan_topk_sweep"] == local, counts
    fs = got[2][1]
    bad = ids_off_oracle(np.array([[f"d{j}" for j in r] for r in fs]), "d",
                         ov, oi)
    assert bad == 0, f"12d: {bad} full-probe id sets differ from the oracle"
    with uncounted(scan), plain_k7(tivf):
        refs = [x.search(q, 10, ef=ef, dev=None) for q, ef in searches]
    err = 0.0
    for (gv, gs), (pv, ps), (q, ef) in zip(got, refs, searches):
        err = max(err, float(np.abs(pv - gv).max()))
        assert err <= TOL_SCORE and (ps == gs).all(), \
            f"12d: K7 differs from its plain version (Q = {q.shape[0]}, " \
            f"ef {ef})"
    one = cuda_ms(torch, lambda: x.search(qi[:1], 10, ef=HNSW_EFS, dev=None))
    q64 = cuda_ms(torch, lambda: x.search(qi, 10, ef=HNSW_EFS, dev=None))
    rows = np.random.default_rng(seed + 1).standard_normal(
        (2, dim)).astype(np.float32)
    rows /= np.linalg.norm(rows, axis=1, keepdims=True)
    ok = x.update(np.array([int(oi[0, 0]), n, n + 1]),
                  np.vstack([np.zeros((1, dim), np.float32), rows]),
                  np.array([False, True, True]))
    assert ok, "12d: the incremental update was refused"
    ov2, oi2 = oracle_update(ov, oi, qn, [int(oi[0, 0])], rows,
                             np.array([n, n + 1]))
    fv2, fs2 = x.search(qi, 10, ef=10**6, dev=None)
    bad2 = ids_off_oracle(np.array([[f"d{j}" for j in r] for r in fs2]), "d",
                          ov2, oi2)
    assert bad2 == 0, f"12d after the update: {bad2} id sets differ"
    assert x.search(rows[:1], 1, ef=10**6, dev=None)[1][0, 0] == n
    say(f"12d clustered {n} x {dim}, ShardedIVF built on every rank in "
        f"{build_s:.2f} s (nlist {x.nlist}, {x.n_tiles} tiles a shard): full "
        f"probe = the float64 oracle on 64/64, and after an incremental "
        f"update (delete 1, append 2) again; K7 = its plain version (Q = 1 "
        f"and Q = 64 at the default probe, Q = 64 full) within "
        f"{err:.3g}; Q = 1 {one:.4f} ms, Q = 64 {q64:.4f} ms at the default "
        f"probe; launches {counts['ivf_scan_topk']} = {local} local shards x"
        f" 3 searches, by shape {counts['shapes'].get('ivf_scan_topk')}")
    del x, mix
    return counts


# ---------------------------------------------------------------------------
# Where a mesh store's chunk waits (`--trace-mesh`, and phase 12a's ranks)
# ---------------------------------------------------------------------------

TRACE_RANGES = (("_local_float", "shard scan"), ("_local_quant", "shard scan"),
                ("merge_topk", "merge_topk"), ("merge_ranks", "merge_ranks"),
                ("normalize_on_device", "normalize"))


@contextlib.contextmanager
def traced_ranges(torch):
    """The sharded route's steps (parallel/sharded_query.py: the shard
    scans, the merges, the query normalization) wrapped in
    torch.profiler.record_function ranges, so a trace shows which host
    step waits."""
    from torch.profiler import record_function

    from picovdb_tpu_torch.parallel import sharded_query as tsq

    saved = []
    for fn_name, label in TRACE_RANGES:
        real = getattr(tsq, fn_name, None)
        if real is None:
            continue

        def wrap(*a, _r=real, _l=label, **kw):
            with record_function(_l):
                return _r(*a, **kw)

        saved.append((fn_name, real))
        setattr(tsq, fn_name, wrap)
    try:
        yield
    finally:
        for fn_name, real in saved:
            setattr(tsq, fn_name, real)


def trace_chunks(torch, run, reps: int = 4, path=None) -> str:
    """torch.profiler over `reps` calls of `run` (each ended by a device
    synchronize, inside a "chunk" range), after a warm call; the chrome
    trace goes to `path` when given. Returns `trace_summary` of it."""
    from torch.profiler import ProfilerActivity, profile, record_function

    run()
    torch.cuda.synchronize()
    with traced_ranges(torch), profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            with record_function("chunk"):
                run()
                torch.cuda.synchronize()
    fd, tmp = tempfile.mkstemp(suffix=".json", dir=os.getcwd())
    os.close(fd)
    prof.export_chrome_trace(tmp)
    with open(tmp) as f:
        events = json.load(f)["traceEvents"]
    if path:
        shutil.move(tmp, path)
    else:
        os.remove(tmp)
    return trace_summary(events)


def trace_summary(events) -> str:
    """Medians over the traced chunks after the first (the profiler's own
    start lands in it): the chunk's wall time, each card's busy time and
    the span of its scan kernels (ms from the chunk's start), and the
    host time in each traced step."""
    chunks = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                    if e.get("name") == "chunk" and e.get("ph") == "X"
                    and e.get("cat") == "user_annotation")[1:]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    if not chunks or not kernels:
        return "trace: not measured (the profiler recorded no device time)"
    walls, busy, starts, ends, host = [], {}, {}, {}, {}
    for lo, hi in chunks:
        walls.append((hi - lo) / 1e3)
        b, s0, s1, h = {}, {}, {}, {}
        for e in kernels:
            a, z = e["ts"], e["ts"] + e["dur"]
            if lo <= a <= hi:
                dev = e.get("args", {}).get("device", -1)
                b[dev] = b.get(dev, 0.0) + e["dur"] / 1e3
                if "scan" in e["name"] or "sweep" in e["name"]:
                    s0[dev] = min(s0.get(dev, 1e30), (a - lo) / 1e3)
                    s1[dev] = max(s1.get(dev, 0.0), (z - lo) / 1e3)
        for e in events:
            if (e.get("ph") == "X" and e.get("cat") == "user_annotation"
                    and e.get("name") != "chunk" and lo <= e["ts"] <= hi):
                h[e["name"]] = h.get(e["name"], 0.0) + e["dur"] / 1e3
        for src, dst in ((b, busy), (s0, starts), (s1, ends), (h, host)):
            for key, v in src.items():
                dst.setdefault(key, []).append(v)
    cards = "; ".join(
        f"card {d}: busy {np.median(busy[d]):.2f} ms"
        + (f", scans {np.median(starts[d]):.2f}-{np.median(ends[d]):.2f} ms"
           if d in starts else "")
        for d in sorted(busy))
    steps = ", ".join(f"{n} {np.median(v):.2f}"
                      for n, v in sorted(host.items()))
    return (f"trace: chunk {np.median(walls):.2f} ms (median of "
            f"{len(chunks)}); {cards} (scan spans from the chunk's start); "
            f"host ms a chunk: {steps}")


def trace_mesh_main(torch, card: str) -> int:
    """`--trace-mesh`: phase 11a's store (MESH_N x DIM float32, K4 a shard,
    `mesh_grid`: one shard a card on four cards) and a trace of its
    2048-query chunks (`trace_chunks`), the chrome traces kept under
    traces/. Uses nothing of the multi-process layer, so the script can
    trace a checkout of the package from before it too."""
    from picovdb_tpu_torch import PicoVectorDB

    rng = np.random.default_rng(SEED + 11)
    n, dim = MESH_N, DIM
    corpus = rng.standard_normal((n, dim), dtype=np.float32)
    corpus /= np.linalg.norm(corpus, axis=1, keepdims=True)
    q = torch.from_numpy(corpus[:2048] + 0.01 * rng.standard_normal(
        (2048, dim), dtype=np.float32)).to("cuda:0")
    tmp = tempfile.mkdtemp(prefix="picovdb_smoke_", dir=os.getcwd())
    out = os.path.join(os.getcwd(), "traces")
    os.makedirs(out, exist_ok=True)
    for dp in (1, 2):
        db = PicoVectorDB(embedding_dim=dim, index="exact", scan_mode="fused",
                          mesh=mesh_grid(torch, dp),
                          storage_file=os.path.join(tmp, f"t{dp}"))
        db.upsert_columnar(corpus, ids=[f"m{i}" for i in range(n)],
                           copy=False)
        db.rebuild_index()
        line = trace_chunks(torch, lambda: db.query_columnar(q, top_k=10),
                            path=os.path.join(out, f"trace_mesh_dp{dp}.json"))
        log(f"trace-mesh: {n} x {dim} float32 on a {dp} x "
            f"{MESH_SHARDS // dp} mesh over {torch.cuda.device_count()} "
            f"card(s), 2048-query chunks: {line}; card {card}")
        del db
        torch.cuda.empty_cache()
    shutil.rmtree(tmp)
    print(card)
    return 0


# Phase 13: the embedding model and the on-device RAG pipeline (its own
# generator, SEED + 13). The encoder is BertConfig()'s MiniLM-L6 widths
# with random_init's weights; its corpus feeds ingest_device and
# query_columnar without leaving the card.
RAG_N = 131_072  # chunks of the encoder's corpus, and rows of each store
RAG_WORDS = 50_000  # made-up words the chunks are drawn from (Zipf)
RAG_LEN = (40, 51)  # words a chunk (40-50)
RAG_MAX_LEN = 128  # tokens the encoder reads a chunk
RAG_BATCH = 512  # chunks a forward
RAG_CHUNK = 2048  # queries a query_columnar chunk
RAG_HOST = 256  # chunks held to the host forward
RAG_ORACLE_Q = 512  # sampled self-retrieval queries held to the oracle
RAG_STORE_Q = 8192  # queries served on each store of (c)
RAG_TEXT_Q = 64  # text queries with words dropped, and the where batch
RAG_ROWS = ("segmax_scan", "topk_packed_keys", "fused_topk_i8", "fused_topk")
RAG_K, RAG_GUARD = 10, 6  # top-10; the segmax band: k_sel = k + 6
F32_HOST_ATOL = 2e-5  # the encoder's float32 forward, card against host
BF16_MIN_COS = 0.999  # its bf16 forward against the host's float32
RAG_RECALL_FLOOR = 0.95  # the route's own answers: wrong rows miss it


def rag_corpus(rng, n: int):
    """n chunks of RAG_LEN words drawn by a Zipf law (s = 1.07) from
    RAG_WORDS made-up lowercase words; returns (texts, tokens a chunk
    without truncation, i.e. words + CLS + SEP)."""
    wl = rng.integers(2, 10, RAG_WORDS)
    letters = np.frombuffer(bytes(range(97, 123)), dtype=np.uint8)
    chars = letters[rng.integers(0, 26, int(wl.sum()))].tobytes().decode()
    cuts = np.concatenate([[0], np.cumsum(wl)])
    words = np.asarray([chars[a:b] for a, b in zip(cuts[:-1], cuts[1:])],
                       dtype=object)
    p = 1.0 / np.arange(1, RAG_WORDS + 1) ** 1.07
    lens = rng.integers(*RAG_LEN, n)
    draws = words[rng.choice(RAG_WORDS, size=int(lens.sum()), p=p / p.sum())]
    ends = np.cumsum(lens)
    texts = [" ".join(draws[e - m:e]) for e, m in zip(ends, lens)]
    return texts, lens + 2


def bert_flops(cfg, batch: int, tokens: int) -> float:
    """Multiply-adds x 2 of one BERT forward over (batch, tokens): the
    dense layers and the two attention products, every layer."""
    h, f = cfg.hidden_size, cfg.intermediate_size
    dense = 2 * batch * tokens * (4 * h * h + 2 * h * f)
    attn = 2 * 2 * batch * tokens * tokens * h
    return float(cfg.num_layers * (dense + attn))


def oracle_band(torch, rows, queries, kk: int, live=None, step: int = 2048):
    """Float64 top-kk (scores, rows) of each query over the unit `rows`
    (float64 normalizations of both), on the card, `step` queries at a
    time; rows outside `live` never qualify."""
    v = rows.double()
    v = v / v.norm(dim=1, keepdim=True)
    vals, idx = [], []
    for s in range(0, queries.shape[0], step):
        q = queries[s:s + step].double()
        sc = (q / q.norm(dim=1, keepdim=True)) @ v.T
        if live is not None:
            sc[:, ~live] = float("-inf")
        top = torch.topk(sc, kk, dim=1)
        vals.append(top.values)
        idx.append(top.indices)
        del sc
    return torch.cat(vals), torch.cat(idx)


class RouteTap:
    """What a store's route returned for each query before the engine's
    exact retry, and the inputs of its crowding mark: wraps the store's
    `DeviceIndex.query_async` (the route's (vals, slots), a -inf marking
    a query the engine re-serves) and `ops/scan.py::_mark_crowded` (each
    band's exact k-th and last scores and the margin). Reads only; `close`
    restores both."""

    def __init__(self, torch, scan, db):
        self.torch, self.scan, self.dev = torch, scan, db._dev
        self.vals, self.slots, self.kth, self.bottom, self.margins = (
            [], [], [], [], set())
        self._dispatch, self._mark = db._dev.query_async, scan._mark_crowded

        def query_async(chunk, k, *args, **kwargs):
            vd, xd, nq, ke = self._dispatch(chunk, k, *args, **kwargs)
            self.vals.append(vd[:nq, :ke])
            self.slots.append(xd[:nq, :ke])
            return vd, xd, nq, ke

        def mark(vals_k, exact_full, k, margin):
            if margin > 0.0:
                self.kth.append(exact_full[:, k - 1])
                self.bottom.append(exact_full[:, -1])
                self.margins.add(margin)
            return self._mark(vals_k, exact_full, k, margin)

        db._dev.query_async, scan._mark_crowded = query_async, mark

    def close(self):
        del self.dev.query_async  # the instance attribute: the method again
        self.scan._mark_crowded = self._mark

    def take(self):
        """(route vals, route slots, k-th and band-bottom exact scores,
        the margin) of everything served since the last take."""
        cat = self.torch.cat
        out = (cat(self.vals), cat(self.slots), cat(self.kth),
               cat(self.bottom), self.margins)
        self.vals, self.slots, self.kth, self.bottom, self.margins = (
            [], [], [], [], set())
        return out


def crowding_check(torch, tap_out, ov, what: str) -> str:
    """Holds the route's crowding mark to the float64 oracle `ov` (each
    query's exact top-k_sel scores over the store): a query is crowded
    when its exact k-th minus k_sel-th score is under the margin the route
    used. The set the route marked (and the engine re-served) must equal
    the crowded set, except in the band of ties: queries whose exact gap
    lies within TOL_SCORE of the margin, and queries whose band is not
    the oracle's (its k-th or last exact score off the oracle's by more
    than TOL_SCORE: the bf16 keys could not order the rows at the band's
    edges, and took another row into it). Returns the counts."""
    vals, _, kth, bottom, margins = tap_out
    assert len(margins) == 1, margins
    margin = margins.pop()
    k, k_sel = RAG_K, RAG_K + RAG_GUARD
    marked = torch.isneginf(vals).any(dim=1)
    gap = ov[:, k - 1] - ov[:, k_sel - 1]
    crowded = gap < margin
    near = (gap - margin).abs() <= TOL_SCORE
    off = (((kth.double() - ov[:, k - 1]).abs() > TOL_SCORE)
           | ((bottom.double() - ov[:, k_sel - 1]).abs() > TOL_SCORE))
    differ = marked != crowded
    bad = int((differ & ~near & ~off).sum())
    assert bad == 0, f"{what}: {bad} queries marked against the oracle"
    return (f"marked {int(marked.sum())} of {marked.shape[0]} (the engine "
            f"re-serves each chunk holding one), the oracle crowded "
            f"{int(crowded.sum())} (margin {margin:.3g}); they differ "
            f"on {int(differ.sum())}, all in the band of ties ({int(near.sum())}"
            f" within {TOL_SCORE:g} of the margin, {int(off.sum())} whose bf16 "
            f"band is not the oracle's)")


def route_vs_oracle(torch, scan, vals, slots, ov, oi, keep, what: str):
    """The route's own top-k (scores, slots) on the queries in `keep`
    against the oracle: scores within TOL_SCORE, ids equal wherever the
    exact k-th/(k+1)-th gap exceeds TOL_GAP. Queries whose oracle top-k
    holds three or more rows of one 128-row segment are left out: K1 keeps
    two rows a segment, as the TPU kernel does, so the route cannot return
    them all. Returns (queries held, queries left out)."""
    k = RAG_K
    seg = torch.sort(oi[:, :k] // scan.SEG, dim=1).values
    three = (seg[:, 2:] == seg[:, :-2]).any(dim=1)
    keep = keep & ~three
    v, s, o_v, o_i = vals[keep], slots[keep].long(), ov[keep], oi[keep]
    err = float((v.double() - o_v[:, :k]).abs().max()) if v.numel() else 0.0
    assert err <= TOL_SCORE, f"{what}: scores off the oracle by {err}"
    wide = (o_v[:, k - 1] - o_v[:, k]) > TOL_GAP
    same = (torch.sort(s, dim=1).values
            == torch.sort(o_i[:, :k], dim=1).values).all(dim=1)
    bad = int((wide & ~same).sum())
    assert bad == 0, f"{what}: ids differ from the oracle on {bad} queries"
    return int(keep.sum()), int(three.sum())


def final_vs_oracle(torch, db, queries, ids, scores, ov, oi, what: str,
                    strict: bool = True) -> str:
    """A query_columnar / query answer (ids, scores) to `queries`, after
    any retry, against the float64 oracle's (ov, oi) on the card: every
    returned score within TOL_SCORE of its row's float64 score (the exact
    rescore), and ids equal to the oracle's wherever the exact
    k-th/(k+1)-th gap exceeds TOL_GAP (`strict`, where every band was
    re-served exactly). Otherwise the answer is the route's own: its
    recall@10 is reported beside the exact tiers' 0.99 limit (PERF.md §2),
    and held only to RAG_RECALL_FLOOR, which wrong rows would miss (on a
    nearly collinear store the crowding mark re-serves few bands whose
    bf16 order is wrong: PERF.md §6-§7). Returns a summary."""
    k = RAG_K
    slot = {name: i for i, name in enumerate(db._ids_array())}
    got = torch.tensor([[slot[x] for x in row] for row in ids],
                       device=ov.device)
    rows = db._dev.vectors[got.view(-1)].double().view(*got.shape, -1)
    q = queries.double()
    q = q / q.norm(dim=1, keepdim=True)
    exact = torch.einsum("qd,qkd->qk", q, rows / rows.norm(dim=2,
                                                          keepdim=True))
    err = float((torch.from_numpy(np.asarray(scores, dtype=np.float64))
                 .to(ov.device) - exact).abs().max())
    assert err <= TOL_SCORE, f"{what}: scores off their rows' by {err}"
    truth = oi[:, :k]
    hit = (got[:, :, None] == truth[:, None, :]).any(dim=2)
    recall = float(hit.float().mean())
    same = hit.all(dim=1) | ((ov[:, k - 1] - ov[:, k]) <= TOL_GAP)
    assert bool(same.all()) or not strict, (
        f"{what}: {int((~same).sum())} queries differ from the oracle")
    assert recall >= (0.99 if strict else RAG_RECALL_FLOOR), (
        f"{what}: recall@10 {recall}")
    return (f"= the oracle on {int(same.sum())}/{ids.shape[0]} (recall@10 "
            f"{recall:.5f}{'' if recall >= 0.99 else ', under the 0.99 limit'})")


def phase_rag(torch, scan, device, card: str, rec, n: int = RAG_N,
              config=None, max_len: int = RAG_MAX_LEN, **db_kwargs) -> dict:
    """Phase 13: BertMeanPoolEncoder at MiniLM-L6's widths embeds a seeded
    corpus on the card, then (b) ingest_device + self-retrieval through
    query_columnar with the crowding mark held to the float64 oracle, (c)
    K1 + K2's own answers on a centred copy of the corpus and on an
    isotropic store, and K1-K4 at dim 384 against their plain versions,
    (d) text queries, Q = 1 and a where= batch, (e) the rag_demo tool.
    Adds 'rag_384' entries to K1-K4's records in `rec`; returns the
    launch counts of (b)-(d). `db_kwargs` go to every store it builds."""
    from picovdb_tpu_torch import K_ID, K_METRICS, PicoVectorDB
    from picovdb_tpu_torch.models import (BertConfig, BertMeanPoolEncoder,
                                          init_params)
    from picovdb_tpu_torch.ops.exact import normalize_on_device

    t_phase = time.perf_counter()
    rng = np.random.default_rng(SEED + 13)
    cfg = config or BertConfig()
    k = RAG_K
    sync = torch.cuda.synchronize

    # (a) the corpus and the encoder
    t0 = time.perf_counter()
    texts, ntok = rag_corpus(rng, n)
    t_corpus = time.perf_counter() - t0
    t0 = time.perf_counter()
    enc = BertMeanPoolEncoder.random_init(cfg, seed=SEED, corpus_texts=texts,
                                          max_len=max_len, device=device)
    t_init = time.perf_counter() - t0
    toks, msk = enc.tokenize(texts[:RAG_BATCH])
    unk = float((toks == enc.tokenizer.UNK).sum() / msk.sum())
    sync()
    t0 = time.perf_counter()
    corpus = torch.cat([enc.embed_device(texts[s:s + RAG_BATCH])
                        for s in range(0, n, RAG_BATCH)])
    sync()
    t_embed = time.perf_counter() - t0
    real = int(np.minimum(ntok, max_len).sum())
    fwd_ms = cuda_ms(torch, lambda: enc.embed_tokens_device(toks, msk), 5)
    tf = bert_flops(cfg, RAG_BATCH, max_len) / fwd_ms / 1e9
    assert corpus.shape == (n, cfg.hidden_size) and corpus.device == device
    assert bool(torch.isfinite(corpus).all())
    norms = torch.linalg.vector_norm(corpus, dim=1)
    assert float((norms - 1).abs().max()) <= 1e-5
    # the host's forward on RAG_HOST chunks: the same weights in float32
    pick = np.sort(rng.choice(n, RAG_HOST, replace=False))
    params = init_params(cfg, SEED)
    ht, hm = enc.tokenize([texts[i] for i in pick])
    t0 = time.perf_counter()
    host = BertMeanPoolEncoder(params, cfg, max_len=max_len,
                               compute_dtype=None, device="cpu"
                               ).embed_tokens_device(ht, hm)
    t_host = time.perf_counter() - t0
    f32 = BertMeanPoolEncoder(params, cfg, max_len=max_len, compute_dtype=None,
                              device=device).embed_tokens_device(ht, hm)
    f32_err = float((f32.cpu() - host).abs().max())
    bf_cos = float((corpus[torch.from_numpy(pick).to(device)].cpu() * host)
                   .sum(1).min())
    assert f32_err <= F32_HOST_ATOL, f"encoder float32 card vs host {f32_err}"
    assert bf_cos >= BF16_MIN_COS, f"encoder bf16 vs host cosine {bf_cos}"
    del params, f32
    log(f"phase 13: corpus {n} chunks of {RAG_LEN[0]}-{RAG_LEN[1] - 1} "
        f"words ({sum(map(len, texts)) / 1e6:.1f} MB of text, {RAG_WORDS} "
        f"Zipf words, made in {t_corpus:.1f} s); encoder BertConfig() "
        f"(hidden {cfg.hidden_size}, {cfg.num_layers} layers, "
        f"{cfg.num_heads} heads, FFN {cfg.intermediate_size}, vocab "
        f"{cfg.vocab_size}) random_init(seed={SEED}) + WordVocabTokenizer "
        f"fit on the corpus in {t_init:.1f} s ({100 * unk:.2f} % of a "
        f"batch's tokens UNK)")
    log(f"phase 13: encoder on {card}: {n / t_embed:.1f} chunks/s, "
        f"{real / t_embed:.1f} tokens/s ({n * max_len / t_embed:.1f} padded) "
        f"through embed_device (tokenizer included), {t_embed:.2f} s for the "
        f"corpus; one {RAG_BATCH} x {max_len} forward {fwd_ms:.3f} ms = "
        f"{tf:.1f} TF/s of the bf16 dense peak "
        f"{PEAK_OPS_PER_S['bf16'] / 1e12:.0f} (CUDA events); card vs host on "
        f"{RAG_HOST} chunks: float32 max |d| {f32_err:.3g}, bf16 min cosine "
        f"{bf_cos:.6f} (host float32 {t_host:.1f} s)")

    # (b) the device pipeline over the encoder's corpus
    tmp = tempfile.mkdtemp(prefix="picovdb_smoke_", dir=os.getcwd())
    ids = [f"c{i}" for i in range(n)]
    meta = [{"src": i % 8} for i in range(n)]
    scan.reset_launch_counts()  # (b)-(d) are this phase's path
    db = PicoVectorDB(embedding_dim=cfg.hidden_size,
                      storage_file=os.path.join(tmp, "enc"), device=device,
                      **db_kwargs)
    t0 = time.perf_counter()
    db.ingest_device(corpus, ids=ids, metadata=meta)
    sync()
    t_ingest = time.perf_counter() - t0
    assert db.last_query_debug()["mirrors"] == {"bf16": True, "int8": True}
    mean = corpus.mean(0)
    coll = float(mean @ mean)
    tap = RouteTap(torch, scan, db)
    retries = db.stats()["exact_retries"]
    t0 = time.perf_counter()
    got, got_sc = db.query_columnar(corpus, top_k=k, batch_size=RAG_CHUNK)
    t_self = time.perf_counter() - t0
    route = db.last_query_debug()["strategy"]
    assert route == "segmax_mixed_stream", route
    chunks_retried = db.stats()["exact_retries"] - retries
    b_out = tap.take()
    ov, oi = oracle_band(torch, db._dev.vectors[:n], corpus, k + RAG_GUARD)
    b_line = crowding_check(torch, b_out, ov, "(b) the encoder's store")
    miss = sum(1 for i in range(n) if got[i][0] != ids[i])
    assert miss == 0, f"self-retrieval missed {miss}"
    samp = np.sort(rng.choice(n, RAG_ORACLE_Q, replace=False))
    samp_t = torch.from_numpy(samp).to(device)
    b_final = final_vs_oracle(torch, db, corpus[samp_t], got[samp],
                              got_sc[samp], ov[samp_t], oi[samp_t],
                              "(b) sampled")
    with uncounted(scan):
        t0 = time.perf_counter()
        db.query_columnar(corpus, top_k=k, batch_size=RAG_CHUNK)
        t_self2 = time.perf_counter() - t0
        tap.take()
    log(f"phase 13: store PicoVectorDB(embedding_dim={cfg.hidden_size}) "
        f"ingest_device {t_ingest:.3f} s (mirrors bf16 + int8); |mean row|^2 "
        f"{coll:.4f}; self-retrieval query_columnar over all {n} chunks "
        f"({route}, {n // RAG_CHUNK} chunks of {RAG_CHUNK}): mismatches "
        f"{miss}/{n}, {n / t_self:.1f} QPS counted pass, {n / t_self2:.1f} QPS "
        f"second pass; exact retries in {chunks_retried} of "
        f"{-(-n // RAG_CHUNK)} chunks (each re-serves its {RAG_CHUNK} "
        f"queries); crowding mark vs the float64 oracle: "
        f"{b_line}; {RAG_ORACLE_Q} sampled answers {b_final} (scores within "
        f"{TOL_SCORE:g}, ids outside a {TOL_GAP:g} gap); card {card}")
    del ov, oi

    # (c1) the encoder's corpus centred and renormalised (this phase's own
    # test data: the store is given unit rows, its semantics unchanged)
    cen = normalize_on_device(corpus - mean)
    c1 = PicoVectorDB(embedding_dim=cfg.hidden_size,
                      storage_file=os.path.join(tmp, "c1"), device=device,
                      **db_kwargs)
    c1.ingest_device(cen, ids=ids)
    qsel = torch.from_numpy(np.sort(rng.choice(n, RAG_STORE_Q, replace=False))
                            ).to(device)
    tap.close()
    tap = RouteTap(torch, scan, c1)
    c1.query_columnar(cen[qsel], top_k=k, batch_size=RAG_CHUNK)
    assert c1.last_query_debug()["strategy"] == "segmax_mixed_stream"
    c_out = tap.take()
    ov, oi = oracle_band(torch, c1._dev.vectors[:n], cen[qsel], k + RAG_GUARD)
    c1_line = crowding_check(torch, c_out, ov, "(c1) the centred store")
    unmarked = ~torch.isneginf(c_out[0]).any(dim=1)
    held, c1_three = route_vs_oracle(torch, scan, c_out[0], c_out[1], ov,
                                     oi, unmarked, "(c1) K1 + K2 -> rescore")
    del ov, oi
    log(f"phase 13: centred store (the corpus mean subtracted, rows "
        f"renormalised): query_columnar {RAG_STORE_Q} of its rows, "
        f"{c1_line}; K1 + K2 -> rescore = the float64 oracle on the {held} "
        f"queries not re-served (scores within {TOL_SCORE:g}, ids outside a "
        f"{TOL_GAP:g} gap; {c1_three} queries left out, whose top-10 holds 3 "
        f"rows of one segment); card {card}")

    # (c2) an isotropic store, its queries its rows plus noise
    g = torch.Generator(device=device).manual_seed(SEED + 13)
    iso = normalize_on_device(torch.randn(n, cfg.hidden_size, generator=g,
                                          device=device))
    c2 = PicoVectorDB(embedding_dim=cfg.hidden_size,
                      storage_file=os.path.join(tmp, "c2"), device=device,
                      **db_kwargs)
    c2.ingest_device(iso, ids=ids)
    q2 = iso[:RAG_STORE_Q] + 0.01 * torch.randn(
        RAG_STORE_Q, cfg.hidden_size, generator=g, device=device)
    tap.close()
    tap = RouteTap(torch, scan, c2)
    retries = c2.stats()["exact_retries"]
    t0 = time.perf_counter()
    c2_ids, _ = c2.query_columnar(q2, top_k=k, batch_size=RAG_CHUNK)
    t_c2 = time.perf_counter() - t0
    assert c2.last_query_debug()["strategy"] == "segmax_mixed_stream"
    c2_retries = c2.stats()["exact_retries"] - retries
    c2_out = tap.take()
    tap.close()
    ov, oi = oracle_band(torch, c2._dev.vectors[:n], q2, k + RAG_GUARD)
    c2_line = crowding_check(torch, c2_out, ov, "(c2) the isotropic store")
    marked = int(torch.isneginf(c2_out[0]).any(dim=1).sum())
    assert marked == 0 and c2_retries == 0, (marked, c2_retries)
    held2, c2_three = route_vs_oracle(
        torch, scan, c2_out[0], c2_out[1], ov, oi,
        torch.ones(RAG_STORE_Q, dtype=torch.bool, device=device),
        "(c2) K1 + K2 -> rescore")
    truth = oi[:, :k].cpu().numpy()
    recall = float(np.mean([
        len({int(x[1:]) for x in c2_ids[i]} & set(truth[i].tolist())) / k
        for i in range(RAG_STORE_Q)]))
    assert recall >= 0.999, recall
    del ov, oi
    log(f"phase 13: isotropic store ({n} seeded rows at dim "
        f"{cfg.hidden_size}): query_columnar {RAG_STORE_Q} "
        f"(segmax_mixed_stream, K1 + K2 {RAG_STORE_Q // RAG_CHUNK} chunks) "
        f"{RAG_STORE_Q / t_c2:.1f} QPS, {c2_line}, exact retries 0, "
        f"recall@10 {recall:.5f}, K1 + K2 -> rescore = the float64 oracle "
        f"on {held2}/{RAG_STORE_Q} ({c2_three} left out, whose top-10 holds 3 "
        f"rows of one segment); card {card}")

    # (d) the rest of the API on the encoder's store
    pick = np.sort(rng.choice(n, RAG_TEXT_Q, replace=False))
    qtexts = [" ".join(w for j, w in enumerate(texts[i].split()) if j % 3 != 1)
              for i in pick]
    retries = db.stats()["exact_retries"]
    t0 = time.perf_counter()
    tq = enc.embed_device(qtexts)
    t_ids, t_sc = db.query_columnar(tq, top_k=k)
    t_text = time.perf_counter() - t0
    t_route = db.last_query_debug()["strategy"]
    assert t_route == "segmax_mixed", t_route
    ov, oi = oracle_band(torch, db._dev.vectors[:n], tq, k + 1)
    t_line = final_vs_oracle(torch, db, tq, t_ids, t_sc, ov, oi,
                             "(d) text queries", strict=False)
    first = sum(1 for i, row in zip(pick, t_ids) if row[0] == ids[i])
    one = tq[:1].cpu().numpy()[0]
    r0, s0 = db.stats()["exact_retries"], scan.LAUNCHES["scan_topk_i8_sweep"]
    res = db.query(one, top_k=k)
    # K3's sweep served it; a crowded band re-runs it exact (that route's
    # name is then the last)
    assert scan.LAUNCHES["scan_topk_i8_sweep"] == s0 + 1, "Q=1 missed K3"
    q1_retry = db.stats()["exact_retries"] - r0
    assert q1_retry or db.last_query_debug()["strategy"] == "i8_fused_smallq"
    q1_line = final_vs_oracle(
        torch, db, tq[:1], np.asarray([[h[K_ID] for h in res]], dtype=object),
        np.asarray([[h[K_METRICS] for h in res]]), ov[:1], oi[:1], "(d) Q=1",
        strict=False)
    src3 = torch.from_numpy(np.arange(n) % 8 == 3).to(device)
    res_w = db.query(tq.cpu().numpy(), top_k=k, where={"src": 3})
    w_route = db.last_query_debug()["strategy"]
    assert w_route == "mixed_fused_batch_filtered", w_route
    fv, fi = oracle_band(torch, db._dev.vectors[:n], tq, k + 1, live=src3)
    assert all(h["src"] == 3 for hits in res_w for h in hits)
    w_line = final_vs_oracle(
        torch, db, tq, np.asarray([[h[K_ID] for h in hits] for hits in res_w],
                                  dtype=object),
        np.asarray([[h[K_METRICS] for h in hits] for hits in res_w]), fv, fi,
        "(d) where=", strict=False)
    d_retries = db.stats()["exact_retries"] - retries
    counts = launch_counts(scan)
    with uncounted(scan):
        q1_ms = cuda_ms(torch, lambda: db.query(one, top_k=k), 20)
        q1_text_ms = cuda_ms(torch, lambda: db.query_columnar(
            enc.embed_device(qtexts[:1]), top_k=k), 20)
        w_ms = cuda_ms(torch, lambda: db.query(tq.cpu().numpy(), top_k=k,
                                               where={"src": 3}), 10)
    for name in RAG_ROWS:
        key = KERNELS[name][0]
        assert counts[key] > 0, f"{name} never launched on phase 13's path"
    log(f"phase 13: {RAG_TEXT_Q} text queries (a third of the words dropped) "
        f"embed_device + query_columnar ({t_route}) {t_line}, source chunk "
        f"first on {first}/{RAG_TEXT_Q}, {RAG_TEXT_Q / t_text:.1f} QPS text "
        f"to ids; Q=1 query() (i8_fused_smallq, exact retries {q1_retry}) "
        f"{q1_line}, {q1_ms:.4f} ms "
        f"by CUDA events ({q1_text_ms:.4f} ms from the text through "
        f"embed_device + query_columnar); where={{'src': 3}} Q={RAG_TEXT_Q} "
        f"({w_route}) {w_line} (the filtered oracle), {w_ms:.4f} ms a batch; "
        f"exact retries in (d) {d_retries}; card {card}; launches {counts}")

    # K1-K4 at dim 384 against their plain versions (uncounted): K1 + K2 on
    # (c2)'s planes at Q = 2048, K3 on the encoder's int8 mirror at Q = 1,
    # K4 at the where batch's shape and at the exact retry's
    parts, dim = [], cfg.hidden_size
    with uncounted(scan):
        dev = c2._dev
        cap, live = dev.active.shape[0], int(dev.active.sum())
        qf = normalize_on_device(q2[:RAG_CHUNK])
        qb = qf.to(torch.bfloat16)
        keys, keys_p, err1 = k1_on_mirror(torch, scan, dev, qf, qb,
                                          "K1 at dim 384")
        nq = qf.shape[0]
        slab = keys.numel() * 4
        e1 = entry(err1, cuda_ms(torch, lambda: scan.segmax_scan(
            qb, dev.vectors_lp, dev.active)), cuda_ms(
            torch, lambda: scan.segmax_scan_plain(qb, dev.vectors_lp,
                                                  dev.active)),
            nq * dim * 2 + live * dim * 2 + cap + slab, 2 * nq * live * dim,
            "bf16")
        ks = k + RAG_GUARD
        tk, _ = scan.topk_packed_keys(keys, ks)
        tk_p, _ = scan.topk_packed_keys_plain(keys, ks)
        e2 = entry(exact_err(torch, tk, tk_p), cuda_ms(
            torch, lambda: scan.topk_packed_keys(keys, ks)), cuda_ms(
            torch, lambda: scan.topk_packed_keys_plain(keys, ks)),
            slab + nq * ks * 8, 0, "int8",
            cuda_ms(torch, lambda: torch.topk(keys, ks, dim=1)))
        del keys, keys_p
        dev = db._dev
        cap, live = dev.active.shape[0], int(dev.active.sum())
        q8, _ = scan.quantize_rows_i8(normalize_on_device(tq[:1]))
        args = (q8, dev.vectors_i8, dev.vscale, dev.active, k + 4)
        served3, t3 = k3_timed(torch, scan, args, 10)
        assert served3 == "sweep", served3  # the K3 row is the sweep's
        e3 = entry(0.0, t3[served3], cuda_ms(torch, lambda: scan.scan_topk_plain(
            *args, chunk=131_072)), dim + live * (dim + 4) + cap + (k + 4) * 8,
            2 * live * dim, "int8")
        wmask = src3 & dev.active[:n]
        wmask = torch.cat([wmask, dev.active[n:]])
        qw = normalize_on_device(tq)
        e4 = {}
        for what, q, rows, msk in (
                (f"Q={RAG_TEXT_Q} k_sel=14 filtered", qw, dev.vectors_lp,
                 wmask),
                (f"Q={RAG_CHUNK} k_sel=14 float32",
                 normalize_on_device(corpus[:RAG_CHUNK]), dev.vectors,
                 dev.active)):
            served4, t4, err4 = k4_timed(torch, scan, q, rows, msk, k + 4, 10)
            nl, es = int(msk.sum()), rows.element_size()
            e4[what] = entry(
                err4, t4[served4], cuda_ms(torch, lambda: scan.scan_topk_plain(
                    q, rows, None, msk, k + 4, chunk=131_072), 3),
                q.shape[0] * dim * 4 + nl * dim * es + cap
                + q.shape[0] * (k + 4) * 8,
                *tc_ops(torch, q.shape[0], nl, dim, rows.dtype, 3))
            parts.append(f"fused_topk {what}: {t4[served4]:.4f} ms ({served4}; "
                         + ", ".join(f"{nm} {ms:.4f}" for nm, ms in t4.items())
                         + f"; plain {e4[what]['plain_ms']:.4f}; bound "
                         f"{e4[what]['bound_ms']:.4f} by "
                         f"{e4[what]['bound_by']}; max |err| {err4:.3g})")
    new = {"segmax_scan": {f"Q={RAG_CHUNK}": e1},
           "topk_packed_keys": {f"Q={RAG_CHUNK} k_sel={ks}": e2},
           "fused_topk_i8": {"Q=1 k_sel=14": e3},
           "fused_topk": e4}
    for name, shapes in new.items():
        row = rec.setdefault(name, {"max_abs_err": 0.0})
        row["rag_384"] = shapes
        row["max_abs_err"] = max([row["max_abs_err"]] + [
            e["max_abs_err"] for e in shapes.values()])
    log(f"phase 13: kernels at dim {dim} (CUDA events, uncounted): "
        f"segmax_scan Q={RAG_CHUNK} on the isotropic store's mirror: "
        f"{e1['ms']:.4f} ms (plain {e1['plain_ms']:.4f}; bound "
        f"{e1['bound_ms']:.4f} by {e1['bound_by']}; max |dkey value| "
        f"{err1:.3g}); topk_packed_keys Q={RAG_CHUNK} k_sel={ks} over "
        f"{slab // 4 // RAG_CHUNK} keys: {e2['ms']:.4f} ms (plain "
        f"{e2['plain_ms']:.4f}, torch.topk {e2['library_ms']:.4f}; bound "
        f"{e2['bound_ms']:.4f} by {e2['bound_by']}; max |err| "
        f"{e2['max_abs_err']:.3g}); fused_topk_i8 Q=1 k_sel=14 on the "
        f"encoder's int8 mirror: {e3['ms']:.4f} ms ({served3}; "
        + ", ".join(f"{nm} {ms:.4f}" for nm, ms in t3.items())
        + f"; plain {e3['plain_ms']:.4f}; bound {e3['bound_ms']:.4f} by "
        f"{e3['bound_by']}; bit for bit); " + "; ".join(parts)
        + f"; card {card}")

    # (e) the tool, as a user runs it
    with tempfile.TemporaryDirectory(dir=os.getcwd()) as work:
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            [os.path.dirname(os.path.abspath(__file__))]
            + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
        t0 = time.perf_counter()
        out = subprocess.run(
            [sys.executable, "-m", "picovdb_tpu_torch.tools.rag_demo",
             "--device-pipeline", "--embedder", "bert-random", "--device",
             device.type], cwd=work, env=env, capture_output=True, text=True,
            timeout=600)
        t_tool = time.perf_counter() - t0
    assert out.returncode == 0, out.stderr[-3000:]
    last = [ln for ln in out.stdout.splitlines()
            if ln.startswith("self-retrieval mismatches:")]
    assert last and last[0].split()[2].startswith("0/"), out.stdout[-2000:]
    log(f"phase 13: tools.rag_demo --device-pipeline --embedder bert-random "
        f"(a subprocess, {t_tool:.1f} s): {last[0]}; card {card}")
    shutil.rmtree(tmp)
    log(f"phase 13: {time.perf_counter() - t_phase:.1f} s; card {card}")
    return counts


# Phase 14: the API-driving tools (picovdb_tpu_torch/tools/) and the entry
# points (picovdb_tpu_torch/graft_entry.py), each as a user runs it
TOOLS_N = 100_000  # upserts, queries, batch_queries: the reference's sizes
TOOLS_MANY_N = 10_000  # many_upserts: the reference's 10k single upserts
PROFILER_STORES = ((100_000, "host"), (1_000_000, "device"))
PROFILER_BS = (1, 16, 256)
PROFILER_CALLS = 16  # timed calls a cell
PROFILER_PIPELINE = 8
PROFILER_CHECK_Q = 256  # queries a scenario holds to the oracle (bs 16, 256)
PROFILER_RECALL = 0.99  # PERF.md §2's limit on the exact tiers
# the kernels line's rows phase 14 reaches: K1-K4, K6, K7, and K8 on the
# 1M store's IVF route at bs 16. K6's rows stay at 0: the dry run's dim
# 64, Q = 8 shards take K6's template (counted under "scan_topk_i4").
TOOLS_ROWS = ("segmax_scan", "topk_packed_keys", "fused_topk_i8",
              "fused_topk_i8_wgmma", "fused_topk", "fused_topk_i4",
              "fused_topk_i4_wgmma", "ivf_scan_topk", "ivf_segmax_scan")
NUM_RE = r"(\d+(?:\.\d+)?)"


def run_tool(name: str, args: list, cwd: str, card: str) -> list:
    """`python -m picovdb_tpu_torch.tools.<name> <args>` in `cwd`, as a user
    runs it (on the card: the tools' default); it must exit 0. Echoes and
    returns its lines."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.dirname(os.path.abspath(__file__))]
        + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-m", f"picovdb_tpu_torch.tools.{name}", *args],
        cwd=cwd, env=env, capture_output=True, text=True, timeout=600)
    took = time.perf_counter() - t0
    assert out.returncode == 0, \
        f"tools.{name} exited {out.returncode}: {out.stderr[-3000:]}"
    lines = [ln.strip() for ln in out.stdout.splitlines() if ln.strip()]
    for ln in lines:
        log(f"phase 14: tools.{name} {' '.join(args)}: {ln}")
    log(f"phase 14: tools.{name} exited 0 in {took:.1f} s (a subprocess, "
        f"imports and the store included); card {card}")
    return lines


def tool_numbers(pattern: str, lines: list, name: str) -> list:
    """The numbers `pattern` (NUM_RE groups) captures in a tool's lines."""
    for ln in lines:
        m = re.search(pattern, ln)
        if m:
            return [float(x) for x in m.groups()]
    raise AssertionError(f"tools.{name} printed no line like {pattern!r}")


def phase_tools_scripts(torch, device, work: str, card: str) -> dict:
    """(a) The four simple tools at the reference's documented sizes, each
    a subprocess in `work`; `upserts`' saved store reloads in this process
    with every row."""
    from picovdb_tpu_torch import PicoVectorDB

    out = {}
    n, d = str(TOOLS_N), str(DIM)
    lines = run_tool("upserts", ["--n", n, "--dim", d], work, card)
    _, _, ins_s, rate, save_s = tool_numbers(
        rf"insert {NUM_RE}x{NUM_RE}: {NUM_RE} s \({NUM_RE} vec/s\), "
        rf"save: {NUM_RE} s", lines, "upserts")
    back = PicoVectorDB(embedding_dim=DIM, device=device,
                        storage_file=os.path.join(work, "bench_upserts_db"))
    assert back.count() == TOOLS_N, back.count()
    del back
    out["upserts"] = {"insert_s": ins_s, "vec_per_s": rate, "save_s": save_s,
                      "reloaded_count": TOOLS_N}
    lines = run_tool("queries", ["--n", n, "--dim", d], work, card)
    total, p50, p95 = tool_numbers(
        rf"100 single queries over {TOOLS_N}: {NUM_RE} s total, p50 "
        rf"{NUM_RE} ms, p95 {NUM_RE} ms", lines, "queries")
    out["queries"] = {"total_s": total, "p50_ms": p50, "p95_ms": p95}
    lines = run_tool("batch_queries", ["--n", n, "--dim", d, "--batches",
                                       "20", "--batch", "50"], work, card)
    out["batch_queries"] = {
        mode: tool_numbers(rf"^{mode} .*-> {NUM_RE} QPS", lines,
                           "batch_queries")[0]
        for mode in ("reference", "query_batched", "query_columnar")}
    lines = run_tool("many_upserts", ["--n", str(TOOLS_MANY_N), "--dim", d],
                     work, card)
    total, per_call, rate = tool_numbers(
        rf"{TOOLS_MANY_N} single upserts: {NUM_RE} s \({NUM_RE} us/call, "
        rf"{NUM_RE} vec/s\)", lines, "many_upserts")
    out["many_upserts"] = {"total_s": total, "us_per_call": per_call,
                           "vec_per_s": rate}
    return out


def admitted_rows(torch, n: int, kwargs: dict, device):
    """(n,) bool: the rows (= ids "0" ... str(n - 1)) a profiler scenario's
    filter admits, from its query kwargs (the profiler's metadata is
    bucket2 = i % 2, bucket10 = i % 10)."""
    i = torch.arange(n, device=device)
    keep = torch.ones(n, dtype=torch.bool, device=device)
    for key, val in (kwargs.get("where") or {}).items():
        keep &= i % {"bucket2": 2, "bucket10": 10}[key] == val
    if kwargs.get("ids") is not None:
        allow = torch.zeros(n, dtype=torch.bool, device=device)
        allow[torch.tensor([int(x) for x in kwargs["ids"]], device=device)] = \
            True
        keep &= allow
    return keep


def profiler_rows(torch, qp, n: int, gen: str, seed: int, device):
    """The profiled store's raw rows (on the card) and the queries
    `run_suite` draws after them, made again from the seed as
    `_make_store` and `run_suite` make them."""
    rng = np.random.default_rng(seed)
    if gen == "device":
        rows = qp.device_corpus(n, DIM, rng, device)
    else:
        host = np.empty((n, DIM), dtype=np.float32)
        for s in range(0, n, qp.GEN_CHUNK):
            e = min(n, s + qp.GEN_CHUNK)
            host[s:e] = rng.standard_normal((e - s, DIM), dtype=np.float32)
        rows = torch.from_numpy(host).to(device)
    queries = rng.standard_normal(
        (max(PROFILER_BS) * PROFILER_CALLS, DIM), dtype=np.float32)
    return rows, queries


def check_profiler_cells(torch, scan, qp, n: int, gen: str, seed: int,
                         device, card: str) -> list:
    """Every scenario x batch size of the profiler on a store `_make_store`
    builds from `seed`, held to a float64 oracle over the rows the
    scenario admits (made again from the seed, on the card): each returned
    score is its row's exact score within TOL_SCORE, `better_than` holds,
    ids equal the oracle's wherever its k-th / (k + 1)-th gap exceeds
    TOL_GAP, and recall@10 >= PROFILER_RECALL. A cell the IVF tier serves
    is held to the oracle restricted to the rows its probe scanned (PERF.md
    §2's IVF limit; recall over every row reported). Bs 1 checks the 16
    timed queries one call each, bs 16 and 256 the first 256 queries.
    Returns one record a cell: route(s), recall, ids, error, launches."""
    from picovdb_tpu_torch import K_ID, K_METRICS
    from picovdb_tpu_torch.ops.exact import normalize_on_device

    db = qp._make_store(n, DIM, np.random.default_rng(seed), gen, device)
    rows, queries = profiler_rows(torch, qp, n, gen, seed, device)
    db.query(queries[0], top_k=10)  # the first sync: upload, mirrors, IVF
    assert np.array_equal(db._ids_array()[:n],
                          np.arange(n).astype(str).astype(object)), \
        "the profiled store's slots are not its rows"
    step = 131_072
    unit = torch.cat([normalize_on_device(rows[s:s + step])
                      for s in range(0, n, step)])
    del rows
    chunks = [(s, unit[s:s + step]) for s in range(0, n, step)]
    qdev = torch.from_numpy(queries[:PROFILER_CHECK_Q]).to(device)
    qn = normalize_on_device(qdev)
    cells = []
    for scenario, kwargs_fn in qp.scenario_generators(n).items():
        kw = kwargs_fn()
        thr = kw.get("better_than")
        adm = admitted_rows(torch, n, kw, device)
        ov, oi = oracle_masked(torch, chunks, qdev,
                               adm.expand(PROFILER_CHECK_Q, -1))
        for bs in PROFILER_BS:
            nq = PROFILER_CALLS if bs == 1 else PROFILER_CHECK_Q
            got = np.full((nq, 10), -1, dtype=np.int64)
            got_sc = np.full((nq, 10), -np.inf)
            routes, probed = [], {}
            before = dict(scan.LAUNCHES)
            for a in range(0, nq, bs):
                res = db.query(queries[a] if bs == 1 else queries[a:a + bs],
                               top_k=10, **kw)
                route = db.last_query_debug()["strategy"]
                routes.append(route)
                if route.startswith("ivf"):
                    probed[a] = probed_slots(torch, db, qn[a:a + bs], n)
                for j, hits in enumerate([res] if bs == 1 else res):
                    got[a + j, :len(hits)] = [int(h[K_ID]) for h in hits]
                    got_sc[a + j, :len(hits)] = [h[K_METRICS] for h in hits]
            launches = {k: scan.LAUNCHES[k] - before[k] for k in scan.LAUNCHES
                        if scan.LAUNCHES[k] != before[k]}
            valid = got >= 0
            assert valid.any(axis=1).all(), f"{scenario} bs={bs}: empty answer"
            assert bool(adm[torch.from_numpy(got[valid]).to(device)].all()), \
                f"{scenario} bs={bs}: a row the filter excludes"
            if thr is not None:
                assert (got_sc[valid] >= thr).all(), \
                    f"{scenario} bs={bs}: better_than={thr} broken"
            # each returned score against its row's float64 score
            rid = torch.from_numpy(np.where(valid, got, 0)).to(device)
            exact = torch.einsum("qd,qkd->qk", qn[:nq].double(),
                                 unit[rid].double()).cpu().numpy()
            err = float(np.abs(got_sc[valid] - exact[valid]).max())
            assert err <= TOL_SCORE, f"{scenario} bs={bs}: scores off by {err}"
            is_ivf = bool(probed)
            if is_ivf:  # the oracle over the rows each call's probe scanned
                assert all(r.startswith("ivf") for r in routes), routes
                masks = torch.cat([probed[a][None].expand(min(bs, nq - a), -1)
                                   for a in range(0, nq, bs)]) & adm
                rv, ri = oracle_masked(torch, chunks, qdev[:nq], masks)
            else:
                rv, ri = ov[:nq], oi[:nq]
            bad, hit, total = 0, 0, 0
            for i in range(nq):
                keep = ov[i, :10] >= (thr if thr is not None else -np.inf)
                want = set(oi[i, :10][keep].tolist())
                mine = set(got[i][valid[i]].tolist())
                hit += len(mine & want)
                total += len(want)
                near = thr is not None and bool(
                    (np.abs(rv[i, :11] - thr) <= TOL_SCORE).any())
                if rv[i, 9] - rv[i, 10] > TOL_GAP and not near:
                    rkeep = rv[i, :10] >= (thr if thr is not None else -np.inf)
                    bad += mine != set(ri[i, :10][rkeep].tolist())
            recall = hit / max(total, 1)
            assert bad == 0, (f"{scenario} bs={bs}: {bad} of {nq} id sets "
                              f"differ from the oracle outside the gap")
            if not is_ivf:
                assert recall >= PROFILER_RECALL, \
                    f"{scenario} bs={bs}: recall@10 {recall} < {PROFILER_RECALL}"
            cells.append({"db_size": n, "scenario": scenario, "batch_size": bs,
                          "routes": sorted(set(routes)),
                          "recall_at_10": recall, "ids_off": bad,
                          "checked": nq, "max_abs_err": err,
                          "oracle": ("restricted to the probed rows" if is_ivf
                                     else "every admitted row"),
                          "launches": launches})
            log(f"phase 14: n={n} ({gen}) {scenario} bs={bs}: route "
                f"{'/'.join(sorted(set(routes)))}; recall@10 {recall:.4f} "
                f"({'over every row; ids against the probed rows' if is_ivf else 'float64 oracle'}), "
                f"ids = oracle outside the gap on {nq - bad}/{nq}, max "
                f"|dscore| {err:.3g}; launches {launches}; card {card}")
    del db, unit, chunks
    torch.cuda.empty_cache()
    return cells


def phase_entry_points(torch, scan, card: str) -> dict:
    """(c) `graft_entry.entry()` on the card (one tensor-core K4 launch a
    call, held to the same step over K4's plain version and to the float64
    oracle, timed beside its bound and the library pair) and
    `dryrun_multichip(4)` over cuda:i % count (launches = shards x
    row-calls per kernel family)."""
    from picovdb_tpu_torch import graft_entry

    fn, (q, v, m) = graft_entry.entry()
    num_q, cap, dim = q.shape[0], v.shape[0], v.shape[1]
    before = scan.LAUNCHES["scan_topk_wgmma"]
    vals, idxs = fn(q, v, m)
    torch.cuda.synchronize()
    assert scan.LAUNCHES["scan_topk_wgmma"] == before + 1, "entry missed K4"

    def plain():
        pv, pi = scan.scan_topk_plain(q, v, None, m, 14, chunk=131_072)
        pv, pi = scan.rescore_exact(q, v, pv, pi)
        return pv[:, :10], pi[:, :10]

    pv, pi = plain()
    err_p = float((vals - pv).abs().max())
    assert err_p <= TOL_SCORE, f"entry vs its plain step: {err_p}"
    ov, oi = oracle_masked(torch, [(s, v[s:s + 131_072])
                                   for s in range(0, cap, 131_072)], q, None)
    got = idxs.cpu().numpy()
    gap = ov[:, 9] - ov[:, 10]
    bad = sum(set(got[i]) != set(oi[i, :10]) for i in range(num_q)
              if gap[i] > TOL_GAP)
    recall = float(np.mean([len(set(got[i]) & set(oi[i, :10])) / 10
                            for i in range(num_q)]))
    assert bad == 0 and recall >= 0.99, (bad, recall)
    exact = torch.einsum("qd,qkd->qk", q.double(), v[idxs.long()].double())
    err_o = float((vals.double() - exact).abs().max())
    assert err_o <= TOL_SCORE, f"entry vs the float64 oracle: {err_o}"
    with uncounted(scan):
        ms = cuda_ms(torch, lambda: fn(q, v, m))
        plain_ms = cuda_ms(torch, plain)
        lib_ms = cuda_ms(torch, lib_topk(torch, lambda: torch.matmul(q, v.T),
                                         ~m, 10))
    nbytes = cap * dim * 4 + num_q * dim * 4 + cap + num_q * 10 * 8
    rec = entry(err_p, ms, plain_ms, nbytes,
                *tc_ops(torch, num_q, cap, dim, torch.float32), lib_ms, LIB_K4)
    rec["bytes_bound_ms"] = nbytes / HBM_BYTES_PER_S * 1e3
    rec.update(recall_at_10=recall, oracle_err=err_o)
    log(f"phase 14: graft_entry.entry() at {num_q} x {cap} x {dim} float32, "
        f"top-10: one scan_topk_wgmma launch a call; = its plain step within "
        f"{err_p:.3g} and the float64 oracle within {err_o:.3g} (recall@10 "
        f"{recall:.4f}, ids outside the gap {num_q}/{num_q}); {ms:.4f} ms "
        f"(CUDA events, median of 10), bound {rec['bound_ms']:.4f} ms by "
        f"{rec['bound_by']} (the corpus read once: "
        f"{rec['bytes_bound_ms']:.4f} ms), {LIB_K4} {lib_ms:.4f} ms, plain "
        f"step {plain_ms:.4f} ms; card {card}")
    del fn, q, v, m, vals, idxs
    torch.cuda.empty_cache()

    before = dict(scan.LAUNCHES)
    out = graft_entry.dryrun_multichip(4)
    torch.cuda.synchronize()
    made = {k: scan.LAUNCHES[k] - before[k] for k in out["calls"]}
    assert made == out["calls"], (made, out["calls"])
    log(f"phase 14: graft_entry.dryrun_multichip(4) over "
        f"{[str(d) for d in graft_entry.dry_run_devices(4)]} (dp "
        f"{out['dp']} x {out['shards']} shards): the plain and kernel routes "
        f"agree, ShardedIVF = the oracle, int8 / int4 overlap "
        f"{out['overlap_i8']:.3f} / {out['overlap_i4']:.3f}; launches = "
        f"shards x row-calls: {made}; card {card}")
    return {"entry": rec, "dryrun_launches": made}


def phase_tools(torch, scan, device, card: str) -> dict:
    """Phase 14: (a) the four simple tools as subprocesses at the
    reference's sizes; (b) the query profiler (`run_suite`) at 100,000
    rows (--gen host) and 1,000,000 (--gen device), then every scenario x
    batch size held to the float64 oracle on a store built from the same
    seed; (c) the entry points. Launch counts are zeroed before (b) and
    read after (c). Returns them; prints one JSON line of the numbers."""
    from picovdb_tpu_torch.tools import query_profiler as qp

    t_phase = time.perf_counter()
    seed = SEED + 14  # the phase's own generator seeds the profiler
    with tempfile.TemporaryDirectory(prefix="picovdb_smoke_",
                                     dir=os.getcwd()) as work:
        scripts = phase_tools_scripts(torch, device, work, card)
    t_a = time.perf_counter() - t_phase
    scan.reset_launch_counts()  # count (b) and (c)'s launches only
    rows = []
    for n, gen in PROFILER_STORES:
        rows += qp.run_suite([n], DIM, PROFILER_CALLS, PROFILER_BS, 10,
                             seed=seed, gen=gen, pipeline=PROFILER_PIPELINE,
                             device=device)
        torch.cuda.empty_cache()
    for r in rows:
        log(f"phase 14: profiler n={r['db_size']} {r['scenario']} "
            f"bs={r['batch_size']}: route {r['strategy']}, k_eff "
            f"{r['k_eff']}, mean {r['mean_ms']:.3f} ms, p50 "
            + ("-" if r["p50_ms"] is None else f"{r['p50_ms']:.3f}")
            + " ms, p95 "
            + ("-" if r["p95_ms"] is None else f"{r['p95_ms']:.3f}")
            + f" ms, {r['ops_per_sec']:.1f} q/s (host clock); card {card}")
    cells = []
    for n, gen in PROFILER_STORES:
        cells += check_profiler_cells(torch, scan, qp, n, gen, seed, device,
                                      card)
    ep = phase_entry_points(torch, scan, card)
    counts = launch_counts(scan)
    for name in TOOLS_ROWS:
        assert counts[KERNELS[name][0]] > 0 or name.startswith(
            "fused_topk_i4"), f"{name} never launched in phase 14"
    took = time.perf_counter() - t_phase
    log(f"phase 14: launches (b) + (c) {counts}; {took:.1f} s, of which the "
        f"four tools {t_a:.1f} s; card {card}")
    print(json.dumps({"phase14": {
        "card": card, "tools": scripts, "profiler": rows,
        "profiler_checks": cells, "entry": ep["entry"],
        "dryrun_launches": ep["dryrun_launches"],
        "launches": {k: n for k, n in counts.items()
                     if k != "shapes" and n},
        "seconds": took}}), flush=True)
    return counts


def q64_latency_main(torch, n: int, dim: int) -> int:
    """`--q64-latency`: an n x dim int8 store with the host rescore, made
    from a generator of its own (SEED + 13), and `q64_latency` on 64 of its
    rows plus noise, through the public API alone (so that any checkout of
    the package can be timed by this script)."""
    from picovdb_tpu_torch import PicoVectorDB

    device = torch.device("cuda:0")
    g = np.random.default_rng(SEED + 13)
    corpus = g.standard_normal((n, dim), dtype=np.float32)
    tmp = tempfile.mkdtemp(prefix="picovdb_smoke_", dir=os.getcwd())
    db = PicoVectorDB(embedding_dim=dim, index="exact", device=device,
                      storage_file=os.path.join(tmp, "store_i8"),
                      storage_dtype="int8")
    db.upsert_columnar(corpus, ids=[f"v{i}" for i in range(n)],
                       metadata=[{"tag": i % 10} for i in range(n)],
                       copy=False)
    db.rebuild_index()
    near = corpus[g.integers(0, n, 64)]
    q64 = near + 0.01 * g.standard_normal(near.shape, dtype=np.float32)
    col, filt = q64_latency(torch, db, q64)
    del db
    shutil.rmtree(tmp)
    print(card_line())
    print(json.dumps({"q64_latency_ms": {"query_columnar": col,
                                         "query_filtered": filt},
                      "store": f"{n} x {dim} int8, host rescore"}))
    return 0


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card only",
              file=sys.stderr)
        return 2
    if sys.argv[1:] == ["--q64-latency"]:
        return q64_latency_main(torch, I8_N, DIM)
    if sys.argv[1:2] == ["--mp-rank"]:  # one rank of phase 12
        return mp_rank_main(torch, int(sys.argv[2]), int(sys.argv[3]),
                            sys.argv[4])
    mesh_only = sys.argv[1:] == ["--mesh"]
    mp_only = sys.argv[1:] == ["--multiprocess"]
    trace_only = sys.argv[1:] == ["--trace-mesh"]
    rag_only = sys.argv[1:] == ["--rag"]
    tools_only = sys.argv[1:] == ["--tools"]
    t_start = time.perf_counter()
    from picovdb_tpu_torch.ops import _build, scan

    device = torch.device("cuda:0")
    card = card_line()
    log(f"phase 1: card {card}")
    t0 = time.perf_counter()
    _build.library()
    log(f"phase 1: kernels built and loaded in {time.perf_counter() - t0:.2f} s"
        f" (nvcc {_build.build_seconds if _build.build_seconds else 0.0:.2f} s)")
    log(f"phase 1: ptxas: {ptxas_report(_build.build().parent / 'ptxas.log')}")

    if trace_only:
        return trace_mesh_main(torch, card)
    if mesh_only:  # phase 11 alone, for iterating on it
        counts = phase_mesh(torch, scan, device,
                            np.random.default_rng(SEED + 11), card)
        log(f"phase 11: launches {counts}")
        print(card)
        return 0
    if rag_only:  # phase 13 alone: the models and the device pipeline
        rec = {}
        counts = phase_rag(torch, scan, device, card, rec)
        log("phase 13: kernels at dim 384 " + json.dumps(
            {name: {**rec[name], "rag_launches": counts[KERNELS[name][0]]}
             for name in RAG_ROWS}))
        print(card)
        return 0
    if tools_only:  # phase 14 alone: the tools and the entry points
        counts = phase_tools(torch, scan, device, card)
        log("phase 14: launches of the kernels line's rows " + json.dumps(
            {name: counts[KERNELS[name][0]] for name in TOOLS_ROWS}))
        print(card)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0
    if mp_only:  # phase 12 alone: one rank a card on two or more cards
        out = os.path.join(os.getcwd(), "traces")
        os.makedirs(out, exist_ok=True)
        counts = phase_multiprocess(torch, scan, card, trace_dir=out)
        log(f"phase 12: launches summed over the ranks {counts}")
        print(card)
        return 0
    rng = np.random.default_rng(SEED)
    rec = phase_kernels(torch, scan, device, PHASE2_CAP, DIM, rng)
    phase_ivf_kernels(torch, scan, device, PHASE2_CAP, DIM, rng, rec)
    counts = {3: phase_main(torch, scan, device, MAIN_N, DIM, rng, card, rec)}
    torch.cuda.empty_cache()
    counts["3b"] = phase_narrow_stores(torch, scan, device, WMMA_N, DIM - 4,
                                       rng, rec)
    torch.cuda.empty_cache()
    counts[4] = phase_int8(torch, scan, device, I8_N, DIM, rng, card)
    torch.cuda.empty_cache()
    counts[5] = phase_int4(torch, scan, device, I4_N, DIM, rng, card)
    torch.cuda.empty_cache()
    phase_bf16(torch, scan, device, BF16_N, DIM, rng)
    torch.cuda.empty_cache()
    counts[7] = phase_ivf_f32(torch, scan, device, IVF_N, DIM, rng, card,
                             rec)
    torch.cuda.empty_cache()
    counts[8] = phase_ivf_int4(torch, scan, device, IVF_I4_N, DIM, rng,
                              card, rec)
    torch.cuda.empty_cache()
    phase_sidecar(torch, device, SIDECAR_N, DIM)
    torch.cuda.empty_cache()
    counts[9] = phase_tiers(torch, scan, device, TIERS_N, DIM, rng, card,
                           rec)["c"]
    torch.cuda.empty_cache()
    counts[10] = phase_probes(torch, scan, device, card)
    torch.cuda.empty_cache()
    before_s = time.perf_counter() - t_start
    counts[13] = phase_rag(torch, scan, device, card, rec)
    torch.cuda.empty_cache()
    rag_s = time.perf_counter() - t_start - before_s
    counts[11] = phase_mesh(torch, scan, device,
                            np.random.default_rng(SEED + 11), card)
    torch.cuda.empty_cache()
    t12 = time.perf_counter()
    counts[12] = phase_multiprocess(torch, scan, card)
    t14 = time.perf_counter()
    counts[14] = phase_tools(torch, scan, device, card)
    log(f"smoke wall time: {time.perf_counter() - t_start:.1f} s, of which "
        f"phases 1-10 {before_s:.1f} s, phase 13 {rag_s:.1f} s, phase 12 "
        f"{t14 - t12:.1f} s, phase 14 {time.perf_counter() - t14:.1f} s")

    kernels = [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": counts[phase][key], **rec[name],
         # phase 11's launches of the row's kernel (the mesh stores) and
         # phase 12's, every rank's (the stores across processes)
         **({"mesh_launches": counts[11].get(key, 0),
             "mp_launches": counts[12].get(key, 0)}
            if name in MESH_ROWS else {}),
         # phase 13's launches of K1-K4 (the encoder's stores)
         **({"rag_launches": counts[13][key]} if name in RAG_ROWS else {}),
         # phase 14's (the profiler's stores and the entry points)
         **({"tools_launches": counts[14][key]} if name in TOOLS_ROWS
            else {})}
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
