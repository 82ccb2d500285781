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

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_SIGNATURES = {
    # q, v, mask, keys, Q, cap, dim, stream (K1: the wmma tile, and the
    # TMA + wgmma mainloop)
    "pv_segmax_scan": [_P, _P, _P, _P, _I, _L, _I, _P],
    "pv_segmax_scan_wgmma": [_P, _P, _P, _P, _I, _L, _I, _P],
    # q, v, vscale, mask, keys, Q, cap, dim, stream
    "pv_segmax_scan_i8": [_P, _P, _P, _P, _P, _I, _L, _I, _P],
    # q, v, mask, keys, Q, cap, dim, stream (K10)
    "pv_segmax_scan_i8c": [_P, _P, _P, _P, _I, _L, _I, _P],
    # keys, out_keys, out_cols, Q, C, k, stream
    "pv_topk_packed_keys": [_P, _P, _P, _I, _L, _I, _P],
    # kind (0 f32, 1 bf16, 2 int8: K3/K4; 3 packed int4: K6; 4 column-scaled
    # int8: K9), q, v, vscale, mask, partial, vals, idx, Q, cap, dim, k,
    # chunk, stream
    "pv_scan_topk": [_I, _P, _P, _P, _P, _P, _P, _P, _I, _L, _I, _I, _L, _P],
    # q, v, mask, partial, vals, idx, Q, cap, dim, k, chunk, stream (K9's
    # one-query sweep: Q <= 16, k <= 128, dim % 16 == 0)
    "pv_sweep_topk_i8c": [_P, _P, _P, _P, _P, _P, _I, _L, _I, _I, _L, _P],
    # kind (0 f32, 1 bf16, 2 column-scaled int8), q, v, mask, hot, n_hot,
    # partial, vals, idx, Q, cap, dim, k, bn, grid_b, split, stream
    "pv_ivf_scan_topk": [_I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _L, _I, _I,
                         _L, _I, _I, _P],
    # kind, q, v, mask, hot, n_hot, keys, Q, cap, dim, bn, grid_b, per_seg,
    # stream
    "pv_ivf_segmax": [_I, _P, _P, _P, _P, _P, _P, _I, _L, _I, _I, _I, _I, _P],
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
    # one nvcc per source, all at once, then one link
    t0 = time.perf_counter()
    jobs = []
    for src in (p for p in srcs if p.suffix == ".cu"):
        obj = out_dir / f"{src.stem}.{os.getpid()}.o"  # nvcc goes by suffix
        cmd = [nvcc, *NVCC_FLAGS, f"-I{CSRC}", "-c", "-o", str(obj), str(src)]
        jobs.append((cmd, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    log, failed = [], []
    for cmd, _, proc in jobs:
        out = proc.communicate()[0]
        log.append(out)
        if proc.returncode != 0:
            failed.append(" ".join(cmd) + "\n" + out[-4000:])
    objs = [obj for _, obj, _ in jobs]
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
