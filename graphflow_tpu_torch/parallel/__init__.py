"""Scale-out across ranks (counterpart of ``graphflow_tpu/parallel``):
process groups named like a mesh and a launcher of ranks (``mesh.py``),
data-parallel training (``data_parallel.py``) and vertex-partitioned SMP2D
with the per-pair halo exchange (``partition.py``)."""

from graphflow_tpu_torch.parallel.mesh import (
    Mesh, data_sharding, init_distributed, make_hybrid_mesh, make_mesh,
    placement, replicated, run_ranks)
from graphflow_tpu_torch.parallel.data_parallel import (
    make_dp_train_step, replicate, shard_batch)
from graphflow_tpu_torch.parallel.partition import (
    PartitionPlan, make_partitioned_forward, make_partitioned_train_step,
    plan_partition, plan_partition_batch, shard_inputs)
