"""Multi-device execution (counterpart of imagine360_tpu/parallel)."""
from .mesh import (activate_mesh, current_mesh, make_mesh, shard_batch,  # noqa: F401
                   shard_frames, shard_pano, shard_views)
