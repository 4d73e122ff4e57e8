"""On-device physics (port of dream2real_tpu/physics): dense TSDF fusion and
the batched pose-validity check, with the host-side mesh, Poisson and oracle
tools beside them."""

from dream2real_tpu_torch.physics.collision import make_unsupcol_check  # noqa: F401
from dream2real_tpu_torch.physics.tsdf import TSDFGrid, fuse_tsdf  # noqa: F401
