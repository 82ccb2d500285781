"""Module-level constants and record schema.

Counterpart of the reference's module constants
(reference: picovdb/pico_vdb.py:26-35). The HNSW_* knobs exist for API
compatibility: the reference tunes a FAISS HNSW graph with them, while this
framework maps them onto the exact fused-scan / IVF tiers (see
`picovdb_tpu_torch.engine` for the mapping).
"""

import numpy as np

# Canonical storage dtype for vectors on host and device.
Float = np.float32

# Record keys (reference: picovdb/pico_vdb.py:31-33).
K_ID = "_id_"
K_VECTOR = "_vector_"
K_METRICS = "_metrics_"

# Compatibility knobs mirroring the reference's HNSW defaults
# (reference: picovdb/pico_vdb.py:27-29). In this framework they are accepted
# and mapped: `hnsw_ef_search`-style knobs scale the IVF `nprobe` when the
# ANN tier is active, and are ignored by the exact tier.
HNSW_M = 32
HNSW_EFC = 40
HNSW_EFS = 32

# Extra candidates fetched under filters (reference: picovdb/pico_vdb.py:30).
ADAPTIVE_BUFFER = 32

# Default fraction threshold choosing argsort vs argpartition in the
# reference (picovdb/pico_vdb.py:160-164). Kept as an accepted knob: the
# fused device kernel has no such choice, but the value is still resolved and
# exposed for introspection parity.
ARGSORT_THRESHOLD = 0.2

# Device-side padding granularity for the corpus row dimension. The corpus
# capacity is padded up to a multiple of this so jit caches stay small while
# MXU tiles stay aligned.
ROW_PAD = 8192

# Minimum padded query-batch size (sublane alignment for f32 is 8).
MIN_QUERY_PAD = 8

# Environment variable names (reference: picovdb/pico_vdb.py:152-164,180-187).
ENV_ADAPTIVE_BUFFER = "PICOVDB_ADAPTIVE_BUFFER"
ENV_ARGSORT_THRESHOLD = "PICOVDB_ARGSORT_THRESHOLD"
ENV_FAISS_THREADS = "PICOVDB_FAISS_THREADS"  # accepted & ignored (no OpenMP here)
# Device-tier env knobs (same kwarg -> env -> constant precedence).
ENV_USE_PALLAS = "PICOVDB_USE_PALLAS"
ENV_WRITER_PRIORITY = "PICOVDB_WRITER_PRIORITY"
ENV_COMPUTE_DTYPE = "PICOVDB_COMPUTE_DTYPE"

# Host-f32 exact rescore for lossy storage dtypes (bfloat16 / int8): the
# device selects top-(k + RESCORE_GUARD) candidates, the host re-ranks them
# against the authentic float32 rows. "auto" applies it on lossy-storage
# stores for batches up to RESCORE_MAX_Q queries.
ENV_RESCORE = "PICOVDB_RESCORE"
ENV_RESCORE_GUARD = "PICOVDB_RESCORE_GUARD"
ENV_RESCORE_MAX_Q = "PICOVDB_RESCORE_MAX_Q"
# Guard 128 measured recall@10 = 1.0000 vs the f64 oracle on every corpus
# tried, including near-duplicate clusters at dim 64 where guard 32 loses
# candidates to selection noise (tests/test_rescore.py).
RESCORE_GUARD = 128
RESCORE_MAX_Q = 128

# Compact host->device query wire for the batch serving lanes: large host
# numpy batches are encoded to a narrower dtype before upload (the upload
# is bandwidth-bound — 128 MB of f32 queries per 32k-query batch dominates
# the e2e wall on slow interconnects; measured 1.5-1.7x e2e QPS,
# bench/results/wire_ab_r4.json). "auto" = int16 per-row fixed point for
# batches of at least QUERY_WIRE_MIN_Q host queries; "float32" disables.
# int16 over float16 at the same 2 B/component: all 15 magnitude bits go
# to the row's used range (no scale column travels — the device-side L2
# normalization divides the per-row scale back out), ~9x less rounding
# noise, and measured recall@10 stays 1.0000 where f16 drops the odd
# boundary tie (0.9984 at 100k x 1024). "int8" (opt-in) quarters the
# wire for extreme links at ~0.98 recall.
ENV_QUERY_WIRE = "PICOVDB_QUERY_WIRE"
QUERY_WIRE = "auto"
QUERY_WIRE_MIN_Q = 256
