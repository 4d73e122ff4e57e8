"""Multi-device parallelism: the data mesh and pose / ray batch sharding
(port of dream2real_tpu/parallel).

The candidate-pose batch (10k-2.2M poses a task) and the training ray batch
split into contiguous shards over a 1-D mesh of devices driven by one
process (``mesh.py``); parameters and the occupancy grid are replicated on
each distinct device, and the results gather on the first.
"""

from dream2real_tpu_torch.parallel.mesh import (  # noqa: F401
    data_mesh,
    pose_sharding,
    replicated,
)
