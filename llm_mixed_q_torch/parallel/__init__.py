from .distributed import global_batch, initialize, make_hybrid_mesh, process_allgather_scalar
from .mesh import batch_spec, make_mesh, shard
from .sharding import param_specs, shard_params
