"""picovdb_tpu_torch — the picovdb_tpu vector database on PyTorch and CUDA.

The same capability surface as picovdb_tpu (its `PicoVectorDB` API, record
keys, knobs and on-disk format), with the L2-normalized float32 corpus
resident on one CUDA device and queried through hand-written Hopper
kernels (`csrc/`). This package imports neither JAX nor picovdb_tpu; the
JAX package stays the reference it is tested against.
"""

from .constants import K_ID, K_METRICS, K_VECTOR, Float  # noqa: F401
from .engine import PicoVectorDB  # noqa: F401
from .locking import RWLock  # noqa: F401

# Back-compat flag of the reference: whether the faiss wheel is importable.
try:  # pragma: no cover - environment-dependent
    import faiss  # type: ignore  # noqa: F401

    _HAS_FAISS = True
except ImportError:  # pragma: no cover
    _HAS_FAISS = False

HAS_ANN = True

__version__ = "0.1.0"

__all__ = [
    "PicoVectorDB",
    "K_ID",
    "K_VECTOR",
    "K_METRICS",
    "Float",
    "RWLock",
    "_HAS_FAISS",
    "HAS_ANN",
    "__version__",
]
