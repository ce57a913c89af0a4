"""Device mesh construction — the replacement for the reference's
ImplicitGlobalGrid Cartesian communicator (init_global_grid,
part1_kernel_programming.jl:100-101).

The reference builds a 3D MPI rank grid; here a ``jax.sharding.Mesh`` over
the devices plays that role, with halo exchange via ``ppermute``
(fpr_tpu.parallel.halo) replacing ``update_halo!`` and ``psum`` replacing
``MPI.Allreduce`` (part1_utils.jl:36-40).
"""

from __future__ import annotations

import numpy as np

import jax
from jax.sharding import Mesh


def make_mesh(shape=None, axis_names=None, devices=None) -> Mesh:
    """Create a Cartesian device mesh.

    shape: device-grid shape, e.g. (4,) or (2, 2, 2).  Defaults to all
    devices on a single 'z' axis (1D decomposition).
    axis_names: defaults to the last len(shape) of ('z', 'y', 'x').
    """
    devices = list(jax.devices()) if devices is None else list(devices)
    if shape is None:
        shape = (len(devices),)
    need = int(np.prod(shape))
    if need > len(devices):
        raise ValueError(f"mesh shape {shape} needs {need} devices, have {len(devices)}")
    devices = devices[:need]
    if axis_names is None:
        # leading axes first: 1D mesh -> ('z',), 2D -> ('z', 'y')
        axis_names = ("z", "y", "x")[: len(shape)]
    dev_array = np.asarray(devices).reshape(shape)
    return Mesh(dev_array, axis_names)
