"""Multi-device stores in one process: device meshes, the row-sharded
exact scan and its cross-device top-k merge.

Counterpart of picovdb_tpu/parallel (its single-process part): the corpus
rows are split over the devices of a `Mesh`, each shard's masked top-k runs
on its own device through the port's kernels (K4 / K3 / K6, or the plain
exact scan), and the (k x shards) candidates merge exactly on the mesh's
first device. The sharded IVF tier is `ivf_mesh.ShardedIVF`.
"""

from .mesh import Mesh, default_mesh, make_mesh  # noqa: F401
from .sharded_query import make_sharded_topk  # noqa: F401
