"""Data parallelism over torch.distributed, the port of
`tapnet_tpu/parallel/` (mesh, distributed runtime, scaling harness).

Env batches are sharded over a data axis of ranks, one process per device,
feeding a sharded learner: each rank samples and rolls out its rows of the
global batch, and one all-reduce of the flat gradient buffer a step keeps
the ranks' parameters identical (`train/reinforce.py`). `tp.py` is the
tensor-parallel rule over a ("data", "model") device mesh, expressible and
checked; DP stays the performance path.
"""

from tapnet_torch.parallel.mesh import (DataMesh, cpu_mesh,  # noqa: F401
                                        data_mesh, replicate,
                                        shard_leading_axis)
from tapnet_torch.parallel.distributed import (  # noqa: F401
    broadcast_from_main, initialize_distributed)
from tapnet_torch.parallel.tp import (data_model_mesh,  # noqa: F401
                                      shard_params_tp, tp_sharding_tree)
