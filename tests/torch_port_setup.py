"""Set-up shared by the PyTorch port's test modules (tests/test_torch_*.py).

The suite runs in several worker processes on one machine. The JAX
package's sharded tests rendezvous eight virtual CPU devices and abort when
those threads wait 40 s for one another; PyTorch's default intra-op pool
(one spinning thread per core in every worker that runs torch ops) starved
them (tests/test_sharded.py::test_sharded_build_cache_is_bounded). Every
port test module calls `cap_torch_threads()` when it is imported, so any
selection of files that brings torch into a worker also caps its pool.

The port's stores and indexes live on the card unless the caller names
another device, and raise where there is none; the CPU tests name it
(`device="cpu"`, or `cpu_kw(pkg)` where one loop builds both packages).
"""

import types

import torch

TORCH_THREADS = 2  # per worker process: leaves the JAX rendezvous room


def cap_torch_threads() -> None:
    torch.set_num_threads(TORCH_THREADS)


def cpu_kw(pkg) -> dict:
    """`device="cpu"` for a picovdb_tpu_torch store or index (module or
    class); nothing for picovdb_tpu, which JAX_PLATFORMS=cpu keeps on the
    host already."""
    mod = pkg.__name__ if isinstance(pkg, types.ModuleType) else pkg.__module__
    return {"device": "cpu"} if mod.startswith("picovdb_tpu_torch") else {}
