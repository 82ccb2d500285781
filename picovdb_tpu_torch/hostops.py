"""Loader for the native host-ops extension, with pure-Python fallback.

Compiles picovdb_tpu_torch/native/hostops.cpp on first use (plain CPython C API,
no pybind11) into a per-user cache directory and imports it. Environments
without a C++ toolchain — or with PICOVDB_NO_NATIVE set — silently use the
Python implementations in the engine instead.
"""

from __future__ import annotations

import importlib.util
import logging
import os
import subprocess
import sys
import sysconfig
from pathlib import Path

logger = logging.getLogger("picovdb_tpu_torch")

_ext = None
_tried = False


def _cache_dir() -> Path:
    root = os.environ.get("XDG_CACHE_HOME", os.path.expanduser("~/.cache"))
    d = Path(root) / "picovdb_tpu_torch" / f"py{sys.version_info[0]}{sys.version_info[1]}"
    d.mkdir(parents=True, exist_ok=True)
    return d


def _build(src: Path, out: Path) -> bool:
    # Compile to a per-process tmp name, then os.replace: compiling
    # straight to the cache path let a killed or concurrent build leave
    # a corrupt .so whose mtime beats the source — cached forever,
    # silently pinning the slow Python fallback (r5 review finding).
    cxx = os.environ.get("CXX", "g++")
    include = sysconfig.get_path("include")
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [
        cxx, "-O2", "-shared", "-fPIC", "-std=c++17",
        f"-I{include}", str(src), "-o", str(tmp),
    ]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
        if proc.returncode != 0:
            logger.debug("hostops build failed:\n%s", proc.stderr[-2000:])
            return False
        os.replace(tmp, out)  # atomic: concurrent builders race benignly
        return True
    except (OSError, subprocess.TimeoutExpired) as e:
        logger.debug("hostops build failed to launch: %s", e)
        return False
    finally:
        if tmp.exists():
            try:
                tmp.unlink()
            except OSError:
                pass


def get() -> object | None:
    """The native module, or None when unavailable."""
    global _ext, _tried
    if _ext is not None or _tried:
        return _ext
    _tried = True
    if os.environ.get("PICOVDB_NO_NATIVE"):
        return None
    src = Path(__file__).parent / "native" / "hostops.cpp"
    if not src.exists():  # pragma: no cover - source tree only
        return None
    suffix = sysconfig.get_config_var("EXT_SUFFIX") or ".so"
    out = _cache_dir() / f"_hostops{suffix}"
    if not out.exists() or out.stat().st_mtime < src.stat().st_mtime:
        if not _build(src, out):
            return None
    try:
        spec = importlib.util.spec_from_file_location("_hostops", out)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)  # type: ignore[union-attr]
        _ext = mod
        logger.debug("native hostops loaded from %s", out)
    except Exception:  # pragma: no cover - corrupt cache etc.
        logger.debug("hostops import failed", exc_info=True)
        _ext = None
    return _ext
