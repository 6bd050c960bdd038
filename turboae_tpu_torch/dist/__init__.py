from .mesh import (Mesh, active, initialize_distributed, launch_env, make_mesh,  # noqa: F401
                   shard_rows)
