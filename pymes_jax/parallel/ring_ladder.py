"""Ring-accumulated particle-particle ladder over a device mesh.

The dense ladder ``R_abij = Σ_cd V_abcd T_cdij`` with V row-sharded on the
output axis *a* and T2 sharded on the contraction axis *c*: instead of
all-gathering T2 onto every device, each device contracts the T-shard it
currently holds with the matching c-slice of its local V block and passes
the shard to its ring neighbour (``lax.ppermute``) — P steps see all
shards, communication overlaps compute, peak memory stays at one T-shard.

This is the CC analogue of ring attention over the virtual-orbital axis
(SURVEY §5.7) and the explicit-collective counterpart of the GSPMD path
used by the solvers.  :func:`ring_ladder_inside` is the jit-composable
form used *inside* the solver while_loop (``ccd_solve_jit(...,
ring_mesh=...)``), replacing CTF's distributed contraction of the same
term (``pymes/solver/ccd.py:187``); exactness vs the dense contraction is
tested on the virtual CPU mesh (``tests/test_parallel.py``).
"""

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P


def _ring_kernel(V_loc, T_loc, *, axis, n_dev, csz):
    me = jax.lax.axis_index(axis)
    perm = [(i, (i + 1) % n_dev) for i in range(n_dev)]

    def step(k, carry):
        T_held, R = carry
        # the shard currently held started on device (me - k) mod P
        src = (me - k) % n_dev
        V_slice = jax.lax.dynamic_slice_in_dim(V_loc, src * csz, csz,
                                               axis=2)
        R = R + jnp.einsum("abcd,cdij->abij", V_slice, T_held)
        T_held = jax.lax.ppermute(T_held, axis, perm)
        return T_held, R

    R0 = jax.lax.pcast(
        jnp.zeros(V_loc.shape[:1] + T_loc.shape[1:], T_loc.dtype), axis,
        to="varying")
    _, R = jax.lax.fori_loop(0, n_dev, step, (T_loc, R0))
    return R


def ring_ladder_inside(V_abcd, T_cdij, mesh, axis="a"):
    """Jit-composable ring ladder: both operands sharded on axis 0 over
    ``mesh[axis]`` (GSPMD rechunks if they are not); result sharded like V.
    Safe to call inside a jitted ``lax.while_loop`` body.
    """
    n_dev = mesh.shape[axis]
    nv = T_cdij.shape[0]
    if nv % n_dev:
        raise ValueError(f"nv={nv} must divide the mesh axis ({n_dev})")
    csz = nv // n_dev
    kernel = partial(_ring_kernel, axis=axis, n_dev=n_dev, csz=csz)
    return jax.shard_map(kernel, mesh=mesh, in_specs=(P(axis), P(axis)),
                         out_specs=P(axis))(V_abcd, T_cdij)


def ring_ladder(V_abcd, T_cdij, mesh, axis="a"):
    """Standalone form: device_put the operands, then ring-contract."""
    V_sh = jax.device_put(V_abcd, NamedSharding(mesh, P(axis)))
    T_sh = jax.device_put(T_cdij, NamedSharding(mesh, P(axis)))
    return ring_ladder_inside(V_sh, T_sh, mesh, axis)


def _ring_kernel_ij(V_loc, T_loc, *, axis, n_dev, csz, n_slices):
    """Occupied-leading ring step: ``R_ijab = Σ_cd V_abcd T_ijcd`` with
    V row-sharded on a and T sharded on its c axis (axis 2).  Per step the
    held T shard contracts as ONE (no², csz·nv)×(csz·nv, a_loc·nv) matmul
    — optionally as Ozaki slice products (``n_slices``), re-slicing the V
    K-panel per step (the panel is the step's working set anyway)."""
    me = jax.lax.axis_index(axis)
    perm = [(i, (i + 1) % n_dev) for i in range(n_dev)]
    a_loc, nv = V_loc.shape[0], V_loc.shape[1]
    no2 = T_loc.shape[0] * T_loc.shape[1]

    def step(k, carry):
        T_held, R = carry
        src = (me - k) % n_dev
        V_slice = jax.lax.dynamic_slice_in_dim(V_loc, src * csz, csz,
                                               axis=2)
        # (a_loc, b, csz, d) -> (csz*d, a_loc*b); T_held (i,j,csz,d)
        Vf = jnp.transpose(V_slice, (2, 3, 0, 1)).reshape(
            csz * nv, a_loc * nv)
        Tf = T_held.reshape(no2, csz * nv)
        if n_slices:
            from pymes_jax.ops import ozaki
            st, et = ozaki.slice_rows(Tf, n_slices)
            sv, ev = ozaki.slice_cols(Vf, n_slices)
            C = ozaki.matmul_presliced(st, et, sv, ev,
                                       t_cutoff=2 * n_slices - 2)
        else:
            C = Tf @ Vf
        R = R + C.reshape(T_loc.shape[0], T_loc.shape[1], a_loc, nv)
        T_held = jax.lax.ppermute(T_held, axis, perm)
        return T_held, R

    R0 = jax.lax.pcast(
        jnp.zeros(T_loc.shape[:2] + (a_loc, nv), T_loc.dtype), axis,
        to="varying")
    _, R = jax.lax.fori_loop(0, n_dev, step, (T_loc, R0))
    return R


def ring_ladder_inside_ij(V_abcd, T_ijcd, mesh, axis="a", n_slices=None):
    """Occupied-leading jit-composable ring ladder: V sharded on axis 0,
    T on axis 2 (both over ``mesh[axis]``); result ``R_ijab`` sharded on
    its a axis (axis 2).  ``n_slices`` routes the per-shard matmul onto
    Ozaki slice products — the distributed × fast-path composition
    (VERDICT r2 task 3)."""
    n_dev = mesh.shape[axis]
    nv = T_ijcd.shape[2]
    if nv % n_dev:
        raise ValueError(f"nv={nv} must divide the mesh axis ({n_dev})")
    csz = nv // n_dev
    kernel = partial(_ring_kernel_ij, axis=axis, n_dev=n_dev, csz=csz,
                     n_slices=n_slices)
    return jax.shard_map(kernel, mesh=mesh,
                         in_specs=(P(axis), P(None, None, axis)),
                         out_specs=P(None, None, axis))(V_abcd, T_ijcd)
