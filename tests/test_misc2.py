"""Mixed-precision schedule, UEG calcGamma (CC4S vertex), ftod dump."""

import os

import numpy as np

from pymes_jax.mean_field import hf
from pymes_jax.models import ueg
from pymes_jax.solver import ccd
from pymes_jax.util import fcidump

DATA = os.path.join(os.path.dirname(__file__), "data")


def test_mixed_precision_ccd_matches_f64():
    n_elec, nb, e_core, e_orb, h_pq, V_pqrs = fcidump.read(
        os.path.join(DATA, "FCIDUMP.LiH.321g"))
    no = n_elec // 2
    fock = hf.construct_hf_matrix(no, h_pq, V_pqrs)
    e64 = ccd.CCD(no).solve(fock, V_pqrs)["ccd e"]
    e_mixed = ccd.CCD(no).solve(fock, V_pqrs, mixed_precision=True)["ccd e"]
    assert abs(e_mixed - e64) < 1e-8


def test_ccsd_blocks_dict_input():
    """CCSD accepts the pre-partitioned block dict (the memory-lean upload
    path for molecules: only the 16 blocks ever reach the device)."""
    from pymes_jax.integral.partition import part_2_body_int
    from pymes_jax.solver import ccsd as ccsd_mod

    n_elec, nb, e_core, e_orb, h_pq, V_pqrs = fcidump.read(
        os.path.join(DATA, "FCIDUMP.LiH.321g"))
    no = n_elec // 2
    fock = hf.construct_hf_matrix(no, h_pq, V_pqrs)
    e_full = ccsd_mod.CCSD(no).solve(fock, V_pqrs)["ccsd e"]
    e_dict = ccsd_mod.CCSD(no).solve(fock,
                                     part_2_body_int(no, V_pqrs))["ccsd e"]
    assert abs(e_full - e_dict) < 1e-12


def test_calc_gamma_ftod():
    """The CC4S density-fitting vertex Γ^p_q(G) = sqrt(4π/G²/Ω) at the
    momentum transfer G = k_p − k_q (fixes the reference's attribute bug
    at ``ueg.py:1000``)."""
    u = ueg.UEG(2, 1, 1, 1.0)
    u.init_single_basis(1)
    nP = u.n_spatial
    overlap = u.basis_fns  # use the same basis as the overlap set
    gamma = u.calcGamma(overlap, nP)
    assert gamma.shape == (nP, nP, nP)
    # diagonal p=q pairs match G=0 → excluded (zero)
    g0 = u.basis.lookup(np.zeros((1, 3), dtype=int))[0]
    assert np.all(gamma[np.arange(nP), np.arange(nP), g0] == 0.0)
    # a nonzero element: find p,q with k_p − k_q in the basis and != 0
    k = u.basis.k_int
    found = False
    for p in range(nP):
        for q in range(nP):
            g = u.basis.lookup((k[p] - k[q]).reshape(1, 3))[0]
            if g >= 0 and not np.array_equal(k[p], k[q]):
                G2 = u.basis.kp[g] @ u.basis.kp[g]
                want = np.sqrt(4 * np.pi / G2 / u.Omega)
                assert np.isclose(gamma[p, q, g], want)
                found = True
                break
        if found:
            break
    assert found

    from pymes_jax.util import cc4s_interface
    import tempfile

    with tempfile.TemporaryDirectory() as d:
        os.chdir(d)
        cc4s_interface.dump_ftod(gamma, "FTOD")
        name, dims, data = cc4s_interface.read_cc4s_tensor("FTOD.dat")
        assert dims == list(gamma.shape)
        assert np.allclose(data.reshape(gamma.shape), gamma)


def test_reference_import_alias():
    """Reference-style import path works: pymes_jax.model.ueg."""
    from pymes_jax.model import ueg as ueg_alias
    from pymes_jax.models import ueg as ueg_real
    assert ueg_alias.UEG is ueg_real.UEG
