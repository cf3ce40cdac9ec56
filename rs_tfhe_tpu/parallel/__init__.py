"""Multi-chip parallelism: device meshes, sharded gates, TP bootstrap.

The device-mesh replacement for the reference's "Railgun" CPU thread-pool
abstraction (rs-tfhe parallel/mod.rs:42-76).
"""

from .mesh import (  # noqa: F401
    BATCH_AXIS,
    MODEL_AXIS,
    batch_spec,
    make_mesh,
    pad_to_multiple,
    replicate,
    shard_batch,
)
from .sharded import (  # noqa: F401
    data_parallel_gate,
    data_parallel_lut_bootstrap,
    data_parallel_mux,
    tensor_parallel_bootstrap,
    tensor_parallel_lut_bootstrap,
    tensor_parallel_gate,
)
