from .mesh import (DataMesh, all_reduce_mean_, all_reduce_sum_, barrier, make_mesh,
                   shard_env_state, shard_params)
