"""Multi-device stores: device meshes, the row-sharded exact scan and its
cross-device top-k merge, in one process or across processes.

Counterpart of picovdb_tpu/parallel: the corpus rows are split over the
devices of a `Mesh`, each shard's masked top-k runs on its own device
through the port's kernels (K4 / K3 / K6, or the plain exact scan), and
the (k x shards) candidates merge exactly on the mesh's first device;
across processes (`multihost.pod_mesh`, one rank a card) each rank's
merged slab then meets the others' through one all_gather. The sharded
IVF tier is `ivf_mesh.ShardedIVF`.
"""

from .mesh import Mesh, default_mesh, make_mesh  # noqa: F401
from .multihost import init_distributed, load_host_shard, pod_mesh  # noqa: F401
from .sharded_query import make_sharded_topk  # noqa: F401
