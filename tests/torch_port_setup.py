"""Set-up shared by the PyTorch port's test modules (tests/test_torch_*.py).

The suite runs in several worker processes on one machine. The JAX
package's sharded tests rendezvous eight virtual CPU devices and abort when
those threads wait 40 s for one another; PyTorch's default intra-op pool
(one spinning thread per core in every worker that runs torch ops) starved
them (tests/test_sharded.py::test_sharded_build_cache_is_bounded). Every
port test module calls `cap_torch_threads()` when it is imported, so any
selection of files that brings torch into a worker also caps its pool.
"""

import torch

TORCH_THREADS = 2  # per worker process: leaves the JAX rendezvous room


def cap_torch_threads() -> None:
    torch.set_num_threads(TORCH_THREADS)
