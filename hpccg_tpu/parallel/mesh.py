"""Mesh construction: hosts x chips -> the row-partition axis.

The reference's distributed model is a 1-D block row partition with z-stacked
domains (generate_matrix.cpp:225-229, README.md:53-63). Two mappings:

- :func:`make_mesh`: a 1-D 'z' mesh. Devices are ordered host-major
  *explicitly* (sorted by (process_index, device id), not by trusting the
  jax.devices() enumeration convention), so consecutive z-shards land on the
  same host and only host-boundary halos cross the network between hosts.
- :func:`make_mesh2d`: a 2-D ('host', 'z') mesh with the host tier as its
  own named axis. Vectors shard over the *flattened* ('host', 'z') product
  (row order = host-major, identical layout to the 1-D mesh), but the mesh
  topology is explicit: the within-host pairs of a halo ppermute stay on
  the host's GPU interconnect (NVLink) and exactly hosts-1 boundary pairs
  cross hosts — asserted by tests/test_mesh2d.py's jaxpr/perm inspection.
  Within one host every GPU reaches every other at the same NVLink rate, so
  the mesh shape there follows the algorithm alone.

Every solver in hpccg_tpu.parallel accepts ``axis`` as a single name ('z')
or the tuple ('host', 'z'); psum/ppermute/axis_size all take the tuple as
one flattened logical axis.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import jax
import numpy as np
from jax.sharding import Mesh


Z_AXIS = "z"
HOST_AXIS = "host"
Axis = Union[str, Tuple[str, ...]]


def _host_major(devices: Sequence[jax.Device]) -> list:
    """Sort devices host-major, explicitly: (process_index, id)."""
    return sorted(devices, key=lambda d: (d.process_index, d.id))


def make_mesh(
    n_devices: Optional[int] = None,
    *,
    axis: str = Z_AXIS,
    devices: Optional[Sequence[jax.Device]] = None,
) -> Mesh:
    """1-D mesh over the first n_devices devices in host-major order."""
    if devices is None:
        devices = _host_major(jax.devices())
    if n_devices is not None:
        if n_devices > len(devices):
            raise ValueError(
                f"requested {n_devices} devices, only {len(devices)} available"
            )
        devices = devices[:n_devices]
    return Mesh(np.asarray(devices), (axis,))


def make_mesh2d(
    hosts: Optional[int] = None,
    chips_per_host: Optional[int] = None,
    *,
    axes: Tuple[str, str] = (HOST_AXIS, Z_AXIS),
    devices: Optional[Sequence[jax.Device]] = None,
) -> Mesh:
    """2-D (host, z) mesh with devices grouped by host explicitly.

    With no arguments, groups all devices by their actual process_index
    (real multi-host runs); pass hosts/chips_per_host to impose a shape
    (virtual CPU meshes, or a subdivided slice). Every host must contribute
    the same device count — ragged hosts are rejected, not silently
    rearranged.
    """
    if devices is None:
        devices = _host_major(jax.devices())
    devices = list(devices)
    if hosts is None or chips_per_host is None:
        procs = sorted({d.process_index for d in devices})
        per = [sum(1 for d in devices if d.process_index == p) for p in procs]
        if len(set(per)) != 1:
            raise ValueError(
                f"ragged hosts (chips per host: {per}); pass hosts/"
                "chips_per_host explicitly to subdivide"
            )
        hosts, chips_per_host = len(procs), per[0]
    if hosts * chips_per_host > len(devices):
        raise ValueError(
            f"requested {hosts}x{chips_per_host} devices, only "
            f"{len(devices)} available"
        )
    grid = np.asarray(devices[: hosts * chips_per_host]).reshape(
        hosts, chips_per_host
    )
    return Mesh(grid, axes)


def row_axis(mesh: Mesh) -> Axis:
    """The row-partition axis spec for a mesh built here: the full axis
    tuple for a 2-D (host, z) mesh, the single name for a 1-D mesh."""
    names = tuple(mesh.axis_names)
    return names if len(names) > 1 else names[0]


def axis_size(mesh: Mesh, axis: Axis) -> int:
    """Devices along ``axis`` (product for a tuple axis)."""
    if isinstance(axis, tuple):
        n = 1
        for a in axis:
            n *= mesh.shape[a]
        return n
    return mesh.shape[axis]
