"""Contractions of the transcorrelated 3-body tensor L.

Produces the effective 2-body integrals (single contraction), 1-body energy
corrections (double contraction) and the scalar energy shift (triple
contraction) from the 6-index L tensor, with the same diagram factors as the
reference (``pymes/integral/contraction.py:17,40,68``).  The 3-body operator
is ``−L^{opq}_{rst}`` and the tensor uses the chemists' *pair-interleaved*
storage layout of :mod:`pymes_jax.util.tcdump`: axes (o, r, p, s, q, t) with
electron pairs (o,r), (p,s), (q,t).

Each contraction is a handful of dense einsums over occupied slots — XLA
turns these traces into gathers + matmuls on device; inputs may be numpy or
jax arrays.

Every contraction also accepts a :class:`pymes_jax.util.tcdump.SparseL`
nonzero list and then runs as masked scatter-adds over the records —
**never materializing the nb⁶ tensor** (nb=50 dense would be 125 GB; the
reference's machinery for this lived in CTF sparse tensors,
``pymes/integral/contraction.py:98-283``, ``tcdump.py:112-139``).  The
dense tensor remains the cross-checked debug path
(``tests/test_contraction_sparse.py``).
"""

import numpy as np

from pymes_jax.log import print_logging_info
from pymes_jax.util.tcdump import SparseL


def _sparse_single(no, sL):
    """Single contraction from the nonzero list: for each einsum pattern,
    select the records whose contracted axes coincide (and are occupied)
    and scatter-add into the dense nb⁴ output (which is needed dense
    downstream anyway)."""
    a0, a1, a2, a3, a4, a5 = sL.idx.T
    v = sL.vals
    D = np.zeros((sL.nb,) * 4, dtype=v.dtype)
    # exchange: einsum("pqriis->prqs", L[:, :, :, :no, :no, :]) and its
    # electron-swapped partner, each with factor −3·2/2 = −3
    m = (a3 == a4) & (a3 < no)
    np.add.at(D, (a0[m], a2[m], a1[m], a5[m]), -3.0 * v[m])
    np.add.at(D, (a2[m], a0[m], a5[m], a1[m]), -3.0 * v[m])
    # direct (RPA): einsum("pqrsii->prqs", L[:, :, :, :, :no, :no]), +6
    m = (a4 == a5) & (a4 < no)
    np.add.at(D, (a0[m], a2[m], a1[m], a3[m]), 6.0 * v[m])
    return -D / 3.0


def _sparse_double(no, sL):
    a0, a1, a2, a3, a4, a5 = sL.idx.T
    v = sL.vals
    S = np.zeros((sL.nb,) * 2, dtype=v.dtype)
    m = (a0 == a1) & (a0 < no) & (a2 == a3) & (a2 < no)  # iijjpq
    np.add.at(S, (a4[m], a5[m]), 12.0 * v[m])
    m = (a0 == a1) & (a0 < no) & (a3 == a4) & (a3 < no)  # iipjjq
    np.add.at(S, (a2[m], a5[m]), -12.0 * v[m])
    m = (a1 == a4) & (a1 < no) & (a2 == a5) & (a2 < no)  # pijqij
    np.add.at(S, (a0[m], a3[m]), 6.0 * v[m])
    m = (a0 == a3) & (a0 < no) & (a1 == a2) & (a1 < no)  # ijjipq
    np.add.at(S, (a4[m], a5[m]), -6.0 * v[m])
    return -S / 6.0


def _sparse_triple(no, sL):
    a0, a1, a2, a3, a4, a5 = sL.idx.T
    v = sL.vals
    occ = (sL.idx < no).all(axis=1)
    t = 8.0 * v[occ & (a0 == a1) & (a2 == a3) & (a4 == a5)].sum()  # iijjkk
    t += -12.0 * v[occ & (a0 == a3) & (a1 == a2) & (a4 == a5)].sum()  # ijjikk
    t += 4.0 * v[occ & (a1 == a2) & (a3 == a4) & (a5 == a0)].sum()  # ijjkki
    return -t / 6.0


def get_single_contraction(no, t_L_orpsqt):
    """Effective 2-body integrals D_pqrs from one occupied contraction.

    Diagram factors (hole lines, loops, equivalent diagrams, spin) follow
    ``contraction.py:30-37``; the result is symmetrised over the two
    electrons and carries the overall −1/3 of the −L/3 convention.
    """
    if isinstance(t_L_orpsqt, SparseL):
        return _sparse_single(no, t_L_orpsqt)
    nb = t_L_orpsqt.shape[0]
    xp = np
    t_D_pqrs = xp.zeros([nb, nb, nb, nb], dtype=t_L_orpsqt.dtype)
    # exchange-type: 1 hole line, 0 loops, sign −1, 3·2 equivalent diagrams
    t_D_pqrs += -3.0 * 2.0 * np.einsum(
        "pqriis->prqs", t_L_orpsqt[:, :, :, :no, :no, :])
    t_D_pqrs += -3.0 * 2.0 * np.einsum(
        "rspiiq->prqs", t_L_orpsqt[:, :, :, :no, :no, :])
    t_D_pqrs /= 2.0
    # direct (RPA)-type: 1 hole line, 1 loop, sign +1, 3 diagrams, spin 2
    t_D_pqrs += 2.0 * 3.0 * np.einsum(
        "pqrsii->prqs", t_L_orpsqt[:, :, :, :, :no, :no])
    return -t_D_pqrs / 3.0


def get_double_contraction(no, t_L_orpsqt):
    """1-body corrections S_pq from two occupied contractions
    (``contraction.py:40``)."""
    if isinstance(t_L_orpsqt, SparseL):
        return _sparse_double(no, t_L_orpsqt)
    t_S_pq = 2.0 ** 2 * 3.0 * np.einsum(
        "iijjpq->pq", t_L_orpsqt[:no, :no, :no, :no, :, :])
    t_S_pq += -(2.0 ** 1) * 3.0 * 2.0 * np.einsum(
        "iipjjq->pq", t_L_orpsqt[:no, :no, :, :no, :no, :])
    t_S_pq += 3.0 * 2.0 * np.einsum(
        "pijqij->pq", t_L_orpsqt[:, :no, :no, :, :no, :no])
    t_S_pq += -1.0 * 3.0 * 2.0 * np.einsum(
        "ijjipq->pq", t_L_orpsqt[:no, :no, :no, :no, :, :])
    return -t_S_pq / 6.0


def get_triple_contraction(no, t_L_orpsqt):
    """Scalar energy shift T_0 from three occupied contractions
    (``contraction.py:68``)."""
    print_logging_info("Triple contraction")
    if isinstance(t_L_orpsqt, SparseL):
        return _sparse_triple(no, t_L_orpsqt)
    L_occ = t_L_orpsqt[:no, :no, :no, :no, :no, :no]
    t_T_0 = 2.0 ** 3 * np.einsum("iijjkk->", L_occ)
    t_T_0 += -(2 ** 2) * 3.0 * np.einsum("ijjikk->", L_occ)
    t_T_0 += 2.0 * 2.0 * np.einsum("ijjkki->", L_occ)
    return -t_T_0 / 6.0
