"""The (data, model) mesh on torch.distributed, the partitioning rules and
multi-process start-up (PyTorch port of videoglamm_tpu/parallel/)."""
from .distributed import (global_device_mesh, initialize_distributed,
                          is_main_process)
from .mesh import DATA_AXIS, MODEL_AXIS, Mesh, create_mesh, local_mesh
from .partitioning import (Sharding, full_state_dict, param_partition_spec,
                           shard_params, with_sharding)
