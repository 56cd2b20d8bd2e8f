"""Device meshes for distributed tensor contractions.

This layer plays the role CTF (C++/MPI block-cyclic tensors) played in the
reference: the big integral/amplitude tensors are sharded over *virtual
orbital* axes on a ``jax.sharding.Mesh``, contractions are ordinary einsums
under jit, and XLA GSPMD inserts the all-gather / reduce-scatter collectives
(NCCL over NVLink between GPUs).  Axes:

* ``"a"`` (and optionally ``"b"``): tensor parallelism over the first (and
  second) virtual orbital axes — V_abcd, V_abij, T_abij row-sharded; the
  particle-particle ladder runs as a local matmul per shard with an
  all-gather of the (much smaller) T2 operand.
* quadrature/twist parallelism (FEAST nodes, twist averaging) maps over the
  same devices via vmap/devices-leading axes — see
  :func:`pymes_jax.parallel.sharding.shard_over_nodes`.
"""

import numpy as np

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(n_devices=None, axis_names=("a",), shape=None, devices=None):
    """Build a Mesh over the first ``n_devices`` devices.

    1D over "a" by default; pass ``axis_names=("a","b")`` and a ``shape``
    for 2D virtual-by-virtual sharding.
    """
    if devices is None:
        devices = jax.devices()
    if n_devices is None:
        n_devices = len(devices)
    devices = np.asarray(devices[:n_devices])
    if shape is None:
        if len(axis_names) == 1:
            shape = (n_devices,)
        else:
            # near-square 2D factorisation
            f = int(np.floor(np.sqrt(n_devices)))
            while n_devices % f:
                f -= 1
            shape = (f, n_devices // f)
    return Mesh(devices.reshape(shape), axis_names)


def largest_dividing_mesh(dim, max_devices):
    """Largest device count ≤ max_devices that divides ``dim`` (GSPMD
    requires sharded axes divisible by the mesh axis; production runs pad
    nv to a multiple of the mesh instead)."""
    for d in range(min(dim, max_devices), 0, -1):
        if dim % d == 0:
            return d
    return 1


def vblock_pspec(name, mesh_axes=("a",)):
    """PartitionSpec sharding the leading virtual axes of a named V block.

    Block names use i..l for occupied, a..d for virtual slots.  The first
    virtual slot shards over mesh axis "a"; with a 2D mesh the second
    virtual slot shards over "b".  Occupied axes are tiny (replicated).
    """
    spec = []
    virt_axes = [ax for ax in mesh_axes]
    for c in name:
        if c in "abcd" and virt_axes:
            spec.append(virt_axes.pop(0))
        else:
            spec.append(None)
    return P(*spec)


def shard_blocks(mesh, dict_t_V, mesh_axes=None):
    """device_put every V block with its virtual-axis sharding."""
    if mesh_axes is None:
        mesh_axes = mesh.axis_names
    out = {}
    for name, arr in dict_t_V.items():
        sh = NamedSharding(mesh, vblock_pspec(name, mesh_axes))
        out[name] = jax.device_put(arr, sh)
    return out


def shard_amplitudes(mesh, T1, T2, mesh_axes=None):
    """Shard T1 (a, i) and T2 (a, b, i, j) over the virtual mesh axes."""
    if mesh_axes is None:
        mesh_axes = mesh.axis_names
    t1_spec = P(mesh_axes[0], None)
    if len(mesh_axes) > 1:
        t2_spec = P(mesh_axes[0], mesh_axes[1], None, None)
    else:
        t2_spec = P(mesh_axes[0], None, None, None)
    return (jax.device_put(T1, NamedSharding(mesh, t1_spec)),
            jax.device_put(T2, NamedSharding(mesh, t2_spec)))


def replicated(mesh, x):
    return jax.device_put(x, NamedSharding(mesh, P()))
