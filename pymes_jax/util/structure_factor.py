"""Static structure factor / pair-correlation diagnostics from CC
amplitudes.

Capability parity with ``pymes/util/structure_factor.py`` (whose
``calcRealSpaceStructureFactor`` still calls CTF and cannot run in the
reference snapshot): given the plane-wave basis, the converged doubles
amplitudes and the occupied set, compute

* the momentum-space transition structure factor
  ``S(q) = Σ_{ai,bj: k_a−k_i = q} (2 T_abij − T_abji + pair terms)``-style
  pair-density contractions, and
* its Fourier transform, the real-space pair-correlation correction g(r).

Implemented with dense vectorized gathers over the momentum-transfer map
(jnp-compatible; numpy in, numpy out).
"""

import numpy as np

from pymes_jax.log import print_logging_info


def transition_structure_factor(ueg_model, t_T_abij, t_T_ai=None):
    """S(q) on the discrete momentum-transfer grid.

    For each (a, i) pair the transfer is q = k_a − k_i; the spin-adapted
    pair density Σ (2T_abij − T_abji) is accumulated per distinct q
    (plus the T1⊗T1 disconnected part when ``t_T_ai`` is given).

    Returns (q_vecs, S_q): unique transfer vectors (n_q, 3) in physical
    units and the corresponding structure-factor values.
    """
    no = t_T_abij.shape[-1]
    nv = t_T_abij.shape[0]
    k_int = ueg_model.basis.k_int
    kp = ueg_model.basis.kp

    T = np.asarray(t_T_abij)
    T_eff = T if t_T_ai is None else (
        T + np.einsum("ai,bj->abij", np.asarray(t_T_ai),
                      np.asarray(t_T_ai)))
    # spin-adapted pair weight per (a, i)
    w_ai = 2.0 * np.einsum("abij->ai", T_eff) \
        - np.einsum("abji->ai", T_eff)

    d_int = k_int[no:, None, :] - k_int[None, :no, :]        # (a, i, 3)
    flat = d_int.reshape(-1, 3)
    uniq, inverse = np.unique(flat, axis=0, return_inverse=True)
    S_q = np.zeros(len(uniq))
    np.add.at(S_q, inverse, w_ai.reshape(-1))
    q_vecs = uniq * 2.0 * np.pi / ueg_model.L
    return q_vecs, S_q


def calcRealSpaceStructureFactor(r_grid, ueg_model, t_T_abij, t_T_ai=None):
    """Pair-correlation correction g(r) on a radial grid: the spherically
    averaged Fourier transform Σ_q S(q)·sinc(|q| r) (reference-name API,
    ``structure_factor.py:23``)."""
    q_vecs, S_q = transition_structure_factor(ueg_model, t_T_abij, t_T_ai)
    q_norm = np.linalg.norm(q_vecs, axis=1)
    r = np.asarray(r_grid, dtype=float)
    qr = np.outer(r, q_norm)
    # spherical average of e^{iq·r}: sinc(qr) = sin(qr)/(qr), sinc(0)=1
    sinc = np.where(qr > 1e-12, np.sin(qr) / np.where(qr > 1e-12, qr, 1.0),
                    1.0)
    g_r = sinc @ S_q / ueg_model.Omega
    print_logging_info("Computed g(r) on %d radial points from %d transfer "
                       "vectors" % (len(r), len(q_norm)), level=2)
    return g_r


def calcReciprocalSpaceStructureFactor(ueg_model, t_T_abij, t_T_ai=None):
    """Reference-name wrapper returning (|q|, S(q)) sorted by |q|."""
    q_vecs, S_q = transition_structure_factor(ueg_model, t_T_abij, t_T_ai)
    q_norm = np.linalg.norm(q_vecs, axis=1)
    order = np.argsort(q_norm)
    return q_norm[order], S_q[order]
