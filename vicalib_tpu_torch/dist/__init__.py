from .mesh import SHARD_AXIS, make_mesh, pad_to_multiple  # noqa: F401
from .multihost import (global_mesh, global_replicated,  # noqa: F401
                        global_shard, initialize, is_primary)
from .sharded import (ShardedLMStep, shard_problem,  # noqa: F401
                      shard_problem_arrays)
