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

import numpy as np
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


# numpy stand-ins for the tensor cores' float32 arithmetic, shared by the
# emulations of K8's and K4's tensor-core scans


def tf32_hi(x):
    """x (float32) with its low 13 mantissa bits cleared: the TF32 part."""
    return (x.view(np.uint32) & np.uint32(0xFFFFE000)).view(np.float32)


def toward_zero(x):
    """float64 -> float32 rounded toward zero (how the tensor cores add a
    wgmma's products into a float32 accumulator)."""
    f = x.astype(np.float32)
    over = np.abs(f.astype(np.float64)) > np.abs(x)
    f[over] = np.nextafter(f[over], np.float32(0))
    return f


def clustered_unit(rng, n, dim, centres=16, sigma=0.03):
    """n unit rows around `centres` random unit centres: neighbours score
    near 1, where a float32 key's ulp is largest."""
    c = rng.standard_normal((centres, dim)).astype(np.float32)
    c /= np.linalg.norm(c, axis=1, keepdims=True)
    x = c[rng.integers(0, centres, n)] + sigma * rng.standard_normal(
        (n, dim)).astype(np.float32)
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)


# The TMA box the wgmma mainloop's producers must reproduce, shared by the
# emulations of K1's cp.async and realigning producers


def tma_box(mat, row0, k, rows_total, nrows):
    """The box TMA writes from a (rows, row bytes) uint8 matrix it can
    read: 128 bytes x nrows from (row row0, byte 128 k), out-of-bounds
    bytes zero, 128B-swizzled (Swizzle<3, 4, 3>: the address's bits 4-6
    XORed with its bits 7-9)."""
    logical = np.zeros((nrows, 128), dtype=np.uint8)
    for r in range(nrows):
        if row0 + r < rows_total:
            tail = mat[row0 + r, 128 * k:128 * k + 128]
            logical[r, :tail.size] = tail
    addr = np.arange(nrows * 128)
    out = np.zeros(nrows * 128, dtype=np.uint8)
    out[addr ^ (((addr >> 7) & 7) << 4)] = logical.reshape(-1)
    return out


def bf16_bytes(rng, rows, dim):
    """A (rows, dim) standard normal matrix as bf16, viewed as its bytes."""
    x = torch.from_numpy(rng.standard_normal((rows, dim)).astype(np.float32))
    return x.to(torch.bfloat16).view(torch.uint8).numpy().reshape(rows, 2 * dim)


# The on-device RAG pipeline's check that no vector reaches the host


def record_host_copies(monkeypatch, width: int) -> list:
    """Patches torch.Tensor so that every host copy of a tensor whose last
    dimension is `width` (an embedding's; ids, scores and tokens have other
    widths) is recorded as (method, shape): `.cpu()`, `.numpy()`,
    `.tolist()`, `__array__`, and a `.to()` from another device to the
    CPU. Module parameters are not recorded. Returns the list it fills."""
    seen = []

    def wrap(name):
        orig = getattr(torch.Tensor, name)

        def rec(self, *args, **kwargs):
            if (self.ndim and self.shape[-1] == width
                    and not isinstance(self, torch.nn.Parameter)):
                targets = (*args, kwargs.get("device"))
                if name != "to" or (self.device.type != "cpu" and any(
                        str(t).startswith("cpu") for t in targets
                        if isinstance(t, (str, torch.device)))):
                    seen.append((name, tuple(self.shape)))
            return orig(self, *args, **kwargs)

        monkeypatch.setattr(torch.Tensor, name, rec)

    for name in ("cpu", "numpy", "tolist", "__array__", "to"):
        wrap(name)
    return seen
