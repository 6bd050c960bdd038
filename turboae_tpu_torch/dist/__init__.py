from .mesh import (Mesh, active, along, initialize_distributed, launch_env,  # noqa: F401
                   make_mesh, shard_rows)
