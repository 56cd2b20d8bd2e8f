"""Sparse (nonzero-list) 3-body contraction pipeline (VERDICT r1 task 3).

The contractions must run straight off the TCDUMP record list — never
materializing the nb⁶ tensor — and agree with the dense debug path on the
shipped ab-initio dumps, including one nb=40 case whose dense tensor
(40⁶ × 8 B = 33 GB) could not exist.
"""

import os

import numpy as np
import pytest

from pymes_jax.integral import contraction
from pymes_jax.mean_field import hf
from pymes_jax.solver import ccsd
from pymes_jax.util import fcidump, tcdump

DATA = os.path.join(os.path.dirname(__file__), "data")


@pytest.mark.parametrize("dump", ["TCDUMP.LiH_FNO", "TCDUMP.H2.tc"])
def test_sparse_contractions_match_dense(dump):
    path = os.path.join(DATA, dump)
    L = tcdump.read(path)
    sL = tcdump.read_sparse(path)
    no = 2 if "LiH" in dump else 1

    # the expanded nonzero list IS the dense tensor
    np.testing.assert_array_equal(tcdump.sparse_to_dense(sL), L)

    for f in (contraction.get_single_contraction,
              contraction.get_double_contraction,
              contraction.get_triple_contraction):
        dense = np.asarray(f(no, L))
        sparse = np.asarray(f(no, sL))
        scale = max(np.abs(dense).max(), 1e-300)
        assert np.abs(sparse - dense).max() <= 1e-13 * scale, f.__name__


def test_tc_ccsd_through_sparse_path():
    """Full TC-CCSD with the 3-body corrections computed from the nonzero
    list must reproduce the dense-path energies (tests/test_tc_ccsd.py)."""
    n_elec, nb, e_core, e_orb, h_pq, V_pqrs = fcidump.read(
        os.path.join(DATA, "FCIDUMP.LiH.tc"), is_tc=True)
    no = n_elec // 2
    sL = tcdump.read_sparse(os.path.join(DATA, "TCDUMP.LiH_FNO"))

    hf_e = float(hf.calc_hf_e(no, e_core, h_pq, V_pqrs)) \
        + contraction.get_triple_contraction(no, sL)
    fock = np.array(hf.construct_hf_matrix(no, h_pq, V_pqrs))
    fock += np.asarray(contraction.get_double_contraction(no, sL))
    V = V_pqrs + np.asarray(contraction.get_single_contraction(no, sL))
    e = ccsd.CCSD(no).solve(fock, V, delta_e=1e-11)["ccsd e"]
    assert abs(hf_e - (-8.044059106879612)) < 1e-8
    assert abs(e - (-0.010563160683828635)) < 1e-7


def test_sparse_contraction_nb40_oom_dense():
    """nb=40 (dense L = 33 GB, impossible on this host): embed a random
    6-fold-symmetric orbit set in the first 12 orbitals, contract through
    the sparse path at nb=40, and check against the nb=12 dense tensor."""
    rng = np.random.default_rng(0)
    nb_small, nb_big, no, n_rec = 12, 40, 4, 300
    idx = rng.integers(0, nb_small, size=(n_rec, 6))
    vals = rng.standard_normal(n_rec)

    rows, v = tcdump._expand_6_fold(idx, vals)
    big = tcdump.SparseL(idx=rows, vals=v, nb=nb_big)
    small_dense = tcdump.sparse_to_dense(
        tcdump.SparseL(idx=rows, vals=v, nb=nb_small))

    for f in (contraction.get_single_contraction,
              contraction.get_double_contraction,
              contraction.get_triple_contraction):
        got = np.asarray(f(no, big))
        want = np.asarray(f(no, small_dense))
        if got.ndim:
            sl = tuple(slice(None, nb_small) for _ in range(got.ndim))
            assert np.abs(got[sl] - want).max() < 1e-12
            outside = got.copy()
            outside[sl] = 0.0
            assert np.abs(outside).max() == 0.0
        else:
            assert abs(got - want) < 1e-12
