"""Golden-value integration tests: HF/CCD/CCSD on the LiH/3-21G FCIDUMP.

Oracles from the reference test suite (``pymes/test/test_ccsd/test_ccsd.py:9``):
HF −7.92958534362757, CCD −0.01830250126018896, CCSD −0.01908832712812761.
"""

import os

import numpy as np
import pytest

from pymes_jax.mean_field import hf
from pymes_jax.solver import ccd, ccsd
from pymes_jax.util import fcidump

FCIDUMP_LIH = os.path.join(os.path.dirname(__file__), "data",
                           "FCIDUMP.LiH.321g")

REF = {
    "hf_e": -7.92958534362757,
    "ccsd_e": -0.01908832712812761,
    "ccd_e": -0.01830250126018896,
}


@pytest.fixture(scope="module")
def lih():
    n_elec, nb, e_core, e_orb, h_pq, V_pqrs = fcidump.read(FCIDUMP_LIH)
    no = n_elec // 2
    fock = hf.construct_hf_matrix(no, h_pq, V_pqrs)
    return dict(no=no, e_core=e_core, h_pq=h_pq, V_pqrs=V_pqrs, fock=fock)


def test_hf_energy(lih):
    hf_e = hf.calc_hf_e(lih["no"], lih["e_core"], lih["h_pq"], lih["V_pqrs"])
    assert np.isclose(float(hf_e), REF["hf_e"])


def test_ccd_energy(lih):
    solver = ccd.CCD(lih["no"])
    res = solver.solve(lih["fock"], lih["V_pqrs"])
    assert np.isclose(res["ccd e"], REF["ccd_e"])


def test_ccsd_energy(lih):
    solver = ccsd.CCSD(lih["no"])
    solver.delta_e = 1e-11
    res = solver.solve(lih["fock"], lih["V_pqrs"])
    assert np.isclose(res["ccsd e"], REF["ccsd_e"])


def test_dcsd_runs(lih):
    solver = ccsd.CCSD(lih["no"], is_dcsd=True)
    res = solver.solve(lih["fock"], lih["V_pqrs"])
    # DCSD should land close to (but distinct from) CCSD
    assert abs(res["ccsd e"] - REF["ccsd_e"]) < 5e-3
    assert res["ccsd e"] != pytest.approx(REF["ccsd_e"], abs=1e-9)
