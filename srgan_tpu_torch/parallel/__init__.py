"""Data parallelism over ranks (``mesh``), tensor parallelism on a data ×
model grid of ranks (``tp``) and the launcher that spawns them
(``launch``); the counterpart of ``srgan_tpu.parallel``'s 1-D and 2-D
meshes."""

from srgan_tpu_torch.parallel.mesh import (DataParallel, data_axis_size,
                                           make_mesh, rank_devices)

__all__ = ["DataParallel", "data_axis_size", "make_mesh", "rank_devices"]
