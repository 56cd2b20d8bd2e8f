"""MP2 — second-order Møller-Plesset perturbation theory.

Parity with ``pymes/solver/mp2.py:9``: non-Hermitian-safe (``V_ijab`` and
``V_abij`` are independent inputs — in transcorrelated Hamiltonians they are
not conjugates).  The doubles amplitudes double as the standard initial guess
for the CC solvers.

The broken CTF-era ``solve_sp`` of the reference is replaced by
:func:`solve_blocked`, a memory-bounded variant that streams over chunks of
the first virtual axis with ``lax.map`` (the reference's virtual-index
partitioning, ``mp2.py:78-99``, done the XLA way).
"""

from functools import partial

import jax
import jax.numpy as jnp


@jax.jit
def _mp2_impl(t_epsilon_i, t_epsilon_a, t_V_ijab, t_V_abij, level_shift):
    t_D_abij = (t_epsilon_i[None, None, :, None]
                + t_epsilon_i[None, None, None, :]
                - t_epsilon_a[:, None, None, None]
                - t_epsilon_a[None, :, None, None])
    t_T_abij = t_V_abij / (t_D_abij + level_shift)
    e_dir = 2.0 * jnp.einsum("abij,ijab->", t_T_abij, t_V_ijab)
    e_exc = -1.0 * jnp.einsum("abij,jiab->", t_T_abij, t_V_ijab)
    return e_dir + e_exc, t_T_abij


def solve(t_epsilon_i, t_epsilon_a, t_V_ijab, t_V_abij, level_shift=0.0,
          **kwargs):
    """MP2 energy and amplitudes: T_abij = V_abij / D_abij.

    Returns ``[e_mp2, T_abij]`` like the reference.
    """
    e, t = _mp2_impl(jnp.asarray(t_epsilon_i), jnp.asarray(t_epsilon_a),
                     jnp.asarray(t_V_ijab), jnp.asarray(t_V_abij),
                     level_shift)
    return [e, t]


@partial(jax.jit, static_argnames=("nv_part_size",))
def _mp2_blocked_impl(eps_i, eps_a, V_ijab, V_abij, level_shift,
                      nv_part_size):
    nv = eps_a.shape[0]
    n_chunks = -(-nv // nv_part_size)
    pad = n_chunks * nv_part_size - nv
    # pad virtual axis so every chunk is full-size (static shapes for XLA)
    V_abij_p = jnp.pad(V_abij, ((0, pad), (0, 0), (0, 0), (0, 0)))
    V_ijab_p = jnp.pad(V_ijab, ((0, 0), (0, 0), (0, pad), (0, 0)))
    eps_a_p = jnp.pad(eps_a, (0, pad), constant_values=1.0)
    mask = (jnp.arange(n_chunks * nv_part_size) < nv).astype(V_abij.dtype)

    def chunk_energy(c):
        sl = c * nv_part_size
        Vab = jax.lax.dynamic_slice_in_dim(V_abij_p, sl, nv_part_size, 0)
        Vij = jax.lax.dynamic_slice_in_dim(V_ijab_p, sl, nv_part_size, 2)
        ea = jax.lax.dynamic_slice_in_dim(eps_a_p, sl, nv_part_size, 0)
        msk = jax.lax.dynamic_slice_in_dim(mask, sl, nv_part_size, 0)
        D = (eps_i[None, None, :, None] + eps_i[None, None, None, :]
             - ea[:, None, None, None] - eps_a[None, :, None, None])
        T = Vab / (D + level_shift) * msk[:, None, None, None]
        e_dir = 2.0 * jnp.einsum("abij,ijab->", T, Vij)
        e_exc = -1.0 * jnp.einsum("abij,jiab->", T, Vij)
        return e_dir + e_exc

    energies = jax.lax.map(chunk_energy, jnp.arange(n_chunks))
    return jnp.sum(energies)


def solve_blocked(t_epsilon_i, t_epsilon_a, t_V_ijab, t_V_abij,
                  level_shift=0.0, nv_part_size=None, **kwargs):
    """Memory-bounded MP2 energy, streaming chunks of the first virtual axis.

    Device-side replacement for the reference's partitioned ``solve_sp``
    (``pymes/solver/mp2.py:24``, broken in the snapshot); returns the energy
    only (amplitudes are never materialised whole).
    """
    eps_i, eps_a = jnp.asarray(t_epsilon_i), jnp.asarray(t_epsilon_a)
    if nv_part_size is None:
        nv_part_size = int(eps_a.shape[0])
    e = _mp2_blocked_impl(eps_i, eps_a, jnp.asarray(t_V_ijab),
                          jnp.asarray(t_V_abij), level_shift,
                          int(nv_part_size))
    return e
