"""Data parallelism over ranks (``mesh``) and the launcher that spawns
them (``launch``); the counterpart of ``srgan_tpu.parallel``'s
data-parallel mesh. The tensor-parallel mesh (``srgan_tpu.parallel.tp``)
is not ported."""

from srgan_tpu_torch.parallel.mesh import (DataParallel, data_axis_size,
                                           make_mesh, rank_devices)

__all__ = ["DataParallel", "data_axis_size", "make_mesh", "rank_devices"]
