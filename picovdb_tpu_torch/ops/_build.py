"""Build and bind the hand-written CUDA kernels (`csrc/*.cu`).

`nvcc` compiles every source of `picovdb_tpu_torch/csrc/` for `sm_90a`
(one process per source, all started together) and links the objects
into one shared library with a plain C interface, which `ctypes` loads.
The library lands in a build directory keyed by a hash of the sources
(`<checkout>/build/kernels/<hash>/`, or `$PICOVDB_KERNEL_BUILD_DIR`), is
built at first use, and is reused while the sources are unchanged. A
failed build raises; nothing falls back.

Nothing here runs at import time: a machine without `nvcc` (the CPU test
runs) imports the package and never calls `library()`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]
LINK_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-shared"]

_lib = None
build_seconds = None  # wall time of the build this process ran, if any
source_seconds = {}  # each source's nvcc seconds in that build

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_SIGNATURES = {
    # q, v, mask, keys, Q, cap, dim, stream (K1: the wmma tile, the TMA +
    # wgmma mainloop, and the mainloop fed by cp.async or by the
    # realigning producer)
    "pv_segmax_scan": [_P, _P, _P, _P, _I, _L, _I, _P],
    "pv_segmax_scan_wgmma": [_P, _P, _P, _P, _I, _L, _I, _P],
    "pv_segmax_scan_cpasync": [_P, _P, _P, _P, _I, _L, _I, _P],
    "pv_segmax_scan_realign": [_P, _P, _P, _P, _I, _L, _I, _P],
    # q, v, vscale, mask, keys, Q, cap, dim, stream (K5: the mma.sync tile,
    # served by no dispatch, and the int8 mainloop fed by TMA, by cp.async
    # or by the realigning producer)
    "pv_segmax_scan_i8": [_P, _P, _P, _P, _P, _I, _L, _I, _P],
    "pv_segmax_scan_i8_wgmma": [_P, _P, _P, _P, _P, _I, _L, _I, _P],
    "pv_segmax_scan_i8_cpasync": [_P, _P, _P, _P, _P, _I, _L, _I, _P],
    "pv_segmax_scan_i8_realign": [_P, _P, _P, _P, _P, _I, _L, _I, _P],
    # q, v, mask, keys, Q, cap, dim, stream (K10: the mma.sync tile, served
    # by no dispatch, and the int8 mainloop fed by TMA, by cp.async or by
    # the realigning producer)
    "pv_segmax_scan_i8c": [_P, _P, _P, _P, _I, _L, _I, _P],
    "pv_segmax_scan_i8c_wgmma": [_P, _P, _P, _P, _I, _L, _I, _P],
    "pv_segmax_scan_i8c_cpasync": [_P, _P, _P, _P, _I, _L, _I, _P],
    "pv_segmax_scan_i8c_realign": [_P, _P, _P, _P, _I, _L, _I, _P],
    # keys, out_keys, out_cols, scratch (null where a row is one chunk), Q,
    # C, k, chunk, stream (K2's split-row warp select)
    "pv_topk_packed_keys": [_P, _P, _P, _P, _I, _L, _I, _L, _P],
    # kind (0 f32, 1 bf16, 2 int8: K3/K4; 3 packed int4: K6; 4 column-scaled
    # int8: K9), q, v, vscale, mask, partial, vals, idx, Q, cap, dim, k,
    # chunk, stream
    "pv_scan_topk": [_I, _P, _P, _P, _P, _P, _P, _P, _I, _L, _I, _I, _L, _P],
    # q, v, mask, partial, vals, idx, Q, cap, dim, k, chunk, stream (K9's
    # one-query sweep: Q <= 16, k <= 128, dim % 16 == 0; served at Q <=
    # scan.I8C_SWEEP_Q_MAX)
    "pv_sweep_topk_i8c": [_P, _P, _P, _P, _P, _P, _I, _L, _I, _I, _L, _P],
    # the same for K9's narrow kind over column-scaled int8 rows at any
    # width and base (Q <= 16, k <= 128, the phase copies within
    # scan.NARROW_SMEM_BYTES; served where scan.i8c_narrow_ready)
    "pv_sweep_topk_i8c_narrow": [_P, _P, _P, _P, _P, _P, _I, _L, _I, _I, _L,
                                 _P],
    # q, v, vscale, mask, partial, vals, idx, Q, cap, dim, k, chunk, stream
    # (K6's one-query sweep: Q <= 16, k <= 128, dim % 32 == 0; served at
    # Q <= scan.I4_SWEEP_Q_MAX)
    "pv_sweep_topk_i4": [_P, _P, _P, _P, _P, _P, _P, _I, _L, _I, _I, _L, _P],
    # the same for K3's one-query sweep over per-row-scaled int8 rows (Q <=
    # 16, k <= 384, dim % 16 == 0; served at Q <= scan.I8_SWEEP_Q_MAX)
    "pv_sweep_topk_i8": [_P, _P, _P, _P, _P, _P, _P, _I, _L, _I, _I, _L, _P],
    # the same for K3's narrow kind of the sweep over int8 rows at any
    # width and base (Q <= 16, k <= 384, the query block's phase copies
    # within scan.NARROW_SMEM_BYTES; served where scan.i8_narrow_ready)
    "pv_sweep_topk_i8_narrow": [_P, _P, _P, _P, _P, _P, _P, _I, _L, _I, _I,
                                _L, _P],
    # the same for K6's narrow kind of the sweep over packed int4 rows at
    # any even width and base (Q <= 16, k <= 128, both halves' phase
    # copies within scan.NARROW_SMEM_BYTES; served where
    # scan.i4_narrow_ready)
    "pv_sweep_topk_i4_narrow": [_P, _P, _P, _P, _P, _P, _P, _I, _L, _I, _I,
                                _L, _P],
    # kind (0 f32 rows, 1 bf16 rows; float32 queries), q, v, mask, partial,
    # vals, idx, Q, cap, dim, k, chunk, stream (K4's one-query sweep: Q <=
    # 16, k <= 128, rows of whole 16 bytes; served where
    # scan.topk_sweep_ready) and its narrow kind over rows at any width and
    # base (the phase copies within scan.NARROW_SMEM_BYTES; served where
    # scan.topk_narrow_ready)
    "pv_sweep_topk_f32": [_I, _P, _P, _P, _P, _P, _P, _I, _L, _I, _I, _L, _P],
    "pv_sweep_topk_f32_narrow": [_I, _P, _P, _P, _P, _P, _P, _I, _L, _I, _I,
                                 _L, _P],
    # piece (the rows' producer, scan.rows_piece: 0 TMA, 8 / 4 / 2 the
    # expanders' reads), q_perm (each half padded to whole 64-byte
    # stages), v, vscale, mask, partial, vals, idx, Q, cap, dim, k, stream
    # (K6's tensor-core scan: any Q, k <= 128, any even dim; served where
    # scan.i4_wgmma_ready)
    "pv_scan_topk_i4_wgmma": [_I, _P, _P, _P, _P, _P, _P, _P, _I, _L, _I, _I,
                              _P],
    # piece (the rows' producer, scan.rows_piece: 0 TMA, 8 / 4 cp.async, 2
    # the realigning producer), kind (0 f32, 1 bf16), query planes (rows of
    # dim rounded up to whole 16 bytes), v, mask, partial, vals, idx, Q,
    # cap, dim, k, stream (K4's tensor-core scan: k <= 128; served where
    # scan.topk_wgmma_ready)
    "pv_scan_topk_wgmma": [_I, _I, _P, _P, _P, _P, _P, _P, _I, _L, _I, _I,
                           _P],
    # piece, kind (0 f32, 1 bf16), q, v, mask, scratch, vals, idx, Q, cap,
    # dim, k, q_tile, range_rows, scratch bytes, stream (K4's wide kind: k
    # <= 1024, a 4-byte aligned mask, the rows in ranges of range_rows, a
    # multiple of 128, scan.topk_wide_plan; served at 128 < k,
    # scan.topk_wide_ready)
    "pv_scan_topk_wide": [_I, _I, _P, _P, _P, _P, _P, _P, _I, _L, _I, _I, _I,
                          _L, _L, _P],
    # piece, q_perm, v, vscale, mask, scratch, vals, idx, Q, cap, dim, k,
    # q_tile, range_rows, scratch bytes, stream (K6's wide kind: k <= 1024,
    # any even dim, a 4-byte aligned mask, K4's ranges; served at 128 < k,
    # scan.i4_wide_ready)
    "pv_scan_topk_i4_wide": [_I, _P, _P, _P, _P, _P, _P, _P, _I, _L, _I, _I,
                             _I, _L, _L, _P],
    # piece, q, v, vscale, mask, scratch, vals, idx, Q, cap, dim, k, q_tile,
    # scratch bytes, stream (K3's wide kind: k <= 1024, a 4-byte aligned
    # mask; the scratch's tile, then room for the queries padded to whole
    # 16 bytes; served where scan.i8_wide_ready)
    "pv_scan_topk_i8_wide": [_I, _P, _P, _P, _P, _P, _P, _P, _I, _L, _I, _I,
                             _I, _L, _P],
    # piece, q, v, vscale, mask, scratch (room for the queries padded to
    # whole 16 bytes, then the partials), vals, idx, Q, cap, dim, k, stream
    # (K3's tensor-core scan: k <= 384; served where scan.i8_wgmma_ready)
    "pv_scan_topk_i8_wgmma": [_I, _P, _P, _P, _P, _P, _P, _P, _I, _L, _I, _I,
                              _P],
    # piece, q, v, mask, scratch (the padded queries, then the partials),
    # vals, idx, Q, cap, dim, k, stream (K9's tensor-core scan: k <= 128;
    # served where scan.i8c_wgmma_ready)
    "pv_scan_topk_i8c_wgmma": [_I, _P, _P, _P, _P, _P, _P, _I, _L, _I, _I,
                               _P],
    # piece, q, v, mask, scratch, vals, idx, Q, cap, dim, k, q_tile,
    # scratch bytes, stream (K9's wide kind: k <= 1024, a 4-byte aligned
    # mask, the scratch as pv_scan_topk_i8_wide's; served where
    # scan.i8c_wide_ready)
    "pv_scan_topk_i8c_wide": [_I, _P, _P, _P, _P, _P, _P, _I, _L, _I, _I, _I,
                              _L, _P],
    # kind (0 f32, 1 bf16, 2 column-scaled int8), q, v, mask, hot, n_hot,
    # partial, vals, idx, Q, cap, dim, k, bn, grid_b, split, stream
    "pv_ivf_scan_topk": [_I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _L, _I, _I,
                         _L, _I, _I, _P],
    # piece, kind (0 f32, 1 bf16, 2 column-scaled int8), query planes
    # (f32: hi and lo; else q; rows of whole 16 bytes), v, mask, hot,
    # n_hot, partial, vals, idx, Q, cap, dim, k, bn, grid_b, stream (K7's
    # tensor-core scan: k <= 128, any width and base; served where
    # ivf.ivf_wgmma_ready)
    "pv_ivf_scan_topk_wgmma": [_I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _I,
                               _L, _I, _I, _I, _I, _P],
    # piece, kind (0 f32, 1 bf16, 2 column-scaled int8), q, v, mask, hot,
    # n_hot, scratch, vals, idx, Q, cap, dim, k, bn, grid_b, q_tile,
    # scratch bytes, stream (K7's wide kind: k <= 1024, any width and base;
    # served at 128 < k, ivf.ivf_wide_ready)
    "pv_ivf_scan_topk_wide": [_I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _L,
                              _I, _I, _I, _I, _I, _L, _P],
    # kind, q, v, mask, hot, n_hot, partial, vals, idx, Q, cap, dim, k, bn,
    # grid_b, ctas, stream (K7's one-query sweep: Q <= 16, k <= 128; and
    # its narrow kind over rows the 16-byte sweep cannot read,
    # ivf.ivf_narrow_ready)
    "pv_ivf_sweep_topk": [_I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _L, _I, _I,
                          _I, _I, _I, _P],
    "pv_ivf_sweep_topk_narrow": [_I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _L,
                                 _I, _I, _I, _I, _I, _P],
    # kind, q, v, mask, hot, n_hot, keys, Q, cap, dim, bn, grid_b, per_seg,
    # stream
    "pv_ivf_segmax": [_I, _P, _P, _P, _P, _P, _P, _I, _L, _I, _I, _I, _I, _P],
    # piece, kind, q (float32: its hi plane), q_lo (float32: the lo plane,
    # else null), v, mask, hot, n_hot, keys, Q, cap, dim, bn, grid_b,
    # per_seg, stream (K8's tensor-core segment scan, any width and base;
    # the planes' rows of whole 16 bytes)
    "pv_ivf_segmax_wgmma": [_I, _I, _P, _P, _P, _P, _P, _P, _P, _I, _L, _I,
                            _I, _I, _I, _P],
    # kind (0 bf16, 1 int8), q, v, out, Q, cap, dim, stream (P1)
    "pv_dot_rowmax": [_I, _P, _P, _P, _I, _L, _I, _P],
    # kind (0 bf16, 1 int8), q, v, out, Q, cap, dim, stream (P1 on the TMA +
    # wgmma mainloop)
    "pv_dot_rowmax_wgmma": [_I, _P, _P, _P, _I, _L, _I, _P],
}


def _sources() -> list:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _build_dir(digest: str) -> Path:
    root = os.getenv("PICOVDB_KERNEL_BUILD_DIR")
    base = (Path(root) if root
            else CSRC.parent.parent / "build" / "kernels")
    return base / digest


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def build() -> Path:
    """Compile the kernels if this source hash has no library yet; return
    the library's path. The compiler's `-Xptxas -v` report (registers,
    shared memory, spills per kernel) is kept beside it as `ptxas.log`."""
    global build_seconds
    srcs = _sources()
    h = hashlib.sha256()
    for p in srcs:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
    out_dir = _build_dir(h.hexdigest()[:16])
    lib = out_dir / "libpicovdb_kernels.so"
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    tag = f"{os.getpid()}.tmp"
    tmp = out_dir / f"libpicovdb_kernels.so.{tag}"
    nvcc = _nvcc()
    # one nvcc per source, all at once (each writing its report to a file,
    # so that each one's seconds are seen), then one link
    t0 = time.perf_counter()
    jobs = []
    for src in (p for p in srcs if p.suffix == ".cu"):
        obj = out_dir / f"{src.stem}.{os.getpid()}.o"  # nvcc goes by suffix
        rep = out_dir / f"{src.stem}.{os.getpid()}.txt"
        cmd = [nvcc, *NVCC_FLAGS, f"-I{CSRC}", "-c", "-o", str(obj), str(src)]
        with open(rep, "w") as fh:
            proc = subprocess.Popen(cmd, stdout=fh, stderr=subprocess.STDOUT)
        jobs.append((cmd, src, obj, rep, proc))
    source_seconds.clear()
    while len(source_seconds) < len(jobs):
        for _, src, _, _, proc in jobs:
            if src.name not in source_seconds and proc.poll() is not None:
                source_seconds[src.name] = time.perf_counter() - t0
        time.sleep(0.05)
    log, failed = [], []
    for cmd, _, _, rep, proc in jobs:
        out = rep.read_text()
        rep.unlink()
        log.append(out)
        if proc.returncode != 0:
            failed.append(" ".join(cmd) + "\n" + out[-4000:])
    objs = [obj for _, _, obj, _, _ in jobs]
    if not failed:
        cmd = [nvcc, *LINK_FLAGS, "-o", str(tmp), *map(str, objs)]
        proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
        log.append(proc.stdout)
        if proc.returncode != 0:
            failed.append(" ".join(cmd) + "\n" + proc.stdout[-4000:])
    build_seconds = time.perf_counter() - t0
    (out_dir / "ptxas.log").write_text("".join(log))
    for obj in objs:
        obj.unlink(missing_ok=True)
    if failed:
        tmp.unlink(missing_ok=True)
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    os.replace(tmp, lib)  # atomic: a concurrent builder races benignly
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library, building it at first use."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def check(err: int, what: str) -> None:
    """Raise if a launcher returned an error: a cudaError_t, or (negative)
    minus the CUresult of a refused TMA tensor-map encode."""
    if err < 0:
        raise RuntimeError(
            f"{what}: cuTensorMapEncodeTiled failed: CUresult {-err}")
    if err != 0:
        raise RuntimeError(f"{what} launch failed: cudaError_t {err}")
