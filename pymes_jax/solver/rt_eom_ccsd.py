"""Real-time EOM-CCSD dynamics via the Cauchy-integral (CIF) propagator.

Capability parity with the reference (``pymes/solver/rt_eom_ccsd.py:13``):
one time step propagates the linear-ansatz coefficients with
``exp(−iH̄dt)·u = ∮ e^Z (Z − iH̄dt)⁻¹ u dZ`` evaluated by Gauss-Legendre
quadrature on the circle ``Z_e = (i·e_c + e_r e^{iθ_e})·dt``; each node is a
shifted linear solve with matvec ``Z x − i·dt·H̄x`` and right-hand side
``e^{Z_e} u`` (the ``phase``), then the quadrature sum is normalised.

Implementation shares the on-device GMRES machinery of
:mod:`pymes_jax.solver.feast_eom_ccsd`.
"""

import time

import jax.numpy as jnp
import numpy as np

from pymes_jax.log import print_logging_info, print_title
from pymes_jax.solver.eom_ccsd import get_diag_doubles, get_diag_singles
from pymes_jax.solver.feast_eom_ccsd import (FEAST_EOM_CCSD,
                                             get_gauss_legendre_quadrature,
                                             normalize_amps)


class RT_EOM_CCSD(FEAST_EOM_CCSD):
    """One CIF real-time propagation step per ``solve`` call
    (reference API: ``rt_eom_ccsd.py:28``)."""

    def __init__(self, no, e_c=0.0, e_r=1.0, dt=0.1, tol=1e-12,
                 max_iter=100, n_quad=8, **kwargs):
        super().__init__(no, e_c=e_c, e_r=e_r, max_iter=max_iter, tol=tol,
                         n_quad=n_quad, **kwargs)
        self.dt = dt
        self.u_singles = None
        self.u_doubles = None

    def solve(self, t_fock_dressed_pq, dict_t_V_dressed, t_T_abij, dt=0.1,
              u_singles=None, u_doubles=None):
        """Propagate (u1, u2) by one step dt; returns the normalised new
        coefficients (complex)."""
        print_title("RT-EOM-CCSD Solver")
        time_init = time.time()
        no = self.no
        if u_singles is None or u_doubles is None:
            raise RuntimeError("No initial state specified!")
        self._reset_op_cache(t_fock_dressed_pq, dict_t_V_dressed, t_T_abij)
        f = jnp.asarray(t_fock_dressed_pq)
        T2 = jnp.asarray(t_T_abij)
        diag_ai = np.asarray(get_diag_singles(f, dict_t_V_dressed, T2))
        diag_abij = np.asarray(get_diag_doubles(f, dict_t_V_dressed, T2))
        diag_vec = np.concatenate([diag_ai.ravel(), diag_abij.ravel()])
        nv = diag_ai.shape[0]
        n1 = nv * no

        x, w = get_gauss_legendre_quadrature(self.n_quad)
        theta = -np.pi * x
        z = (self.e_c * 1j + self.e_r * np.exp(1j * theta)) * dt

        b = np.concatenate([np.ravel(u_singles), np.ravel(u_doubles)])
        # +w/2: the θ = −πx parametrisation walks the contour clockwise;
        # the positive-orientation residue sum makes one step exactly
        # e^{+iH̄dt}·u (the reference's −w/2 leaves a global −1 per step
        # that its per-step normalisation hides)
        node_w = w / 2 * (self.e_r * dt * np.exp(1j * theta))
        if type(self)._solve_node is not FEAST_EOM_CCSD._solve_node:
            # subclassed per-node solver (model-Hamiltonian tests)
            Q = np.zeros(b.shape, dtype=complex)
            for e_i in range(len(z)):
                Qe = self._solve_node(f, dict_t_V_dressed, T2, b, z[e_i],
                                      diag_vec, nv, is_rt=True, dt=dt,
                                      phase=np.exp(z[e_i]))
                Q += node_w[e_i] * Qe
        else:
            # all contour nodes through the shared node engine (default:
            # f32 scan-over-nodes Krylov + f64 refinement; the per-node
            # rhs phases e^{z_e} fold into the broadcast rhs)
            Qe_all, _ = self._solve_nodes_engine(
                f, dict_t_V_dressed, T2, b.astype(complex), z, diag_vec,
                nv, is_rt=True, dt=dt, phases=np.exp(z))
            Q = (node_w[:, None] * Qe_all).sum(axis=0)

        q1 = Q[:n1].reshape(nv, no)
        q2 = Q[n1:].reshape(nv, nv, no, no)
        q1, q2 = normalize_amps(q1, q2)
        self.u_singles = [q1]
        self.u_doubles = [q2]
        print_logging_info(
            f"RT-EOM-CCSD finished in {time.time() - time_init:.2f} "
            "seconds.", level=0)
        return q1, q2
