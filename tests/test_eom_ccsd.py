"""EOM-CCSD tests: pure-solver Davidson unit test against exact
diagonalisation, and the LiH/3-21G golden excitation energies
(``pymes/test/test_eom_ccsd/test_eom_ccsd.py:8-9``)."""

import os

import numpy as np
import pytest

from pymes_jax.integral.partition import part_2_body_int
from pymes_jax.mean_field import hf
from pymes_jax.solver import ccsd, eom_ccsd
from pymes_jax.util import fcidump

DATA = os.path.join(os.path.dirname(__file__), "data")


class _MatrixEOM(eom_ccsd.EOM_CCSD):
    """EOM solver with the sigma build replaced by a dense fake Hamiltonian
    acting on the packed (u1, u2) vector (reference's fake-Ham harness,
    ``eom_ccsd.py:387-416``)."""

    def __init__(self, no, n_excit, ham):
        super().__init__(no, n_excit=n_excit)
        self.ham = ham

    def _batched_sigma(self, f, dict_t_V, U1, U2, T2):
        m, nv = U1.shape[0], U1.shape[1]
        no = self.no
        out1, out2 = [], []
        for i in range(m):
            u = np.concatenate([np.ravel(U1[i]), np.ravel(U2[i])])
            w = self.ham @ u
            out1.append(w[: nv * no].reshape(nv, no))
            out2.append(w[nv * no:].reshape(nv, nv, no, no))
        return np.stack(out1), np.stack(out2)

    # honest fake-backend diagonals for the per-component preconditioner
    def get_diag_singles(self, f, dict_t_V, T2):
        nv, no = T2.shape[0], self.no
        return self.ham.diagonal()[: nv * no].reshape(nv, no)

    def get_diag_doubles(self, f, dict_t_V, T2):
        nv, no = T2.shape[0], self.no
        return self.ham.diagonal()[nv * no:].reshape(nv, nv, no, no)


def test_davidson_fake_hamiltonian():
    rng = np.random.default_rng(7)
    no, nv, n_excit = 1, 5, 3
    dim = nv * no + nv * nv * no * no
    ham = np.diag(np.arange(dim) * 0.3)
    ham += rng.random((dim, dim)) - 0.5
    ham = (ham + ham.T) / 2

    e_target = np.sort(np.linalg.eigvals(ham).real)[:n_excit]

    # fock whose gaps reproduce the singles diagonal (preconditioner)
    fock = np.diag(np.concatenate([[0.0], ham.diagonal()[: nv]]))
    solver = _MatrixEOM(no, n_excit, ham)
    solver.max_iter = 1000
    dict_V = part_2_body_int(no, np.zeros((no + nv,) * 4))
    e = solver.solve(fock, dict_V, np.zeros((nv, nv, no, no)))
    assert np.allclose(np.sort(e), e_target, atol=1e-6)


def test_davidson_root_tracking_mom():
    """Maximum-overlap (MOM) root tracking: on a spectrum with a low
    'intruder' state nearly disconnected from the guess space,
    lowest-real selection converges to the intruder while
    ``root_tracking="guess"`` follows the guess-connected states
    adiabatically (the UEG H̄ at nP≥123 has exactly this structure —
    near-degenerate pairs at ≈−0.6 far below the physical excitations
    at ≈5.25)."""
    rng = np.random.default_rng(3)
    no, nv, n_excit = 1, 4, 2
    dim = nv * no + (nv * no) ** 2
    diag = np.concatenate([[1.0, 1.1, 1.2, 1.3],
                           2.0 + 0.1 * np.arange(16)])
    ham = np.diag(diag)
    coup = (rng.random((dim, dim)) - 0.5) * 0.04
    ham = ham + (coup + coup.T) / 2
    ham[7, 7] = -0.5  # intruder, weakly coupled to the guess coords

    ev_all, vec_all = np.linalg.eigh(ham)
    low2 = ev_all[:n_excit]
    # guess coords are 0 and 1 (lowest eps_a - eps_i gaps)
    ovl = np.abs(vec_all[0]) ** 2 + np.abs(vec_all[1]) ** 2
    expected_mom = np.sort(ev_all[np.argsort(-ovl)[:n_excit]])
    assert low2[0] < -0.4 and expected_mom[0] > 0.9  # scenario is real

    fock = np.diag(np.concatenate([[0.0], diag[:nv]]))
    dict_V = part_2_body_int(no, np.zeros((no + nv,) * 4))
    T2 = np.zeros((nv, nv, no, no))

    tracked = _MatrixEOM(no, n_excit, ham)
    tracked.max_iter = 1000
    tracked.max_dim = 12          # N >= max_dim + n_excit: fixed path
    tracked.root_tracking = "guess"
    e_tracked = np.sort(tracked.solve(fock, dict_V, T2))
    assert np.allclose(e_tracked, expected_mom, atol=1e-6)

    plain = _MatrixEOM(no, n_excit, ham)
    plain.max_iter = 1000
    plain.max_dim = 12
    e_plain = np.sort(plain.solve(fock, dict_V, T2))
    assert np.allclose(e_plain, low2, atol=1e-6)


def test_eom_mp2():
    """EOM with MP2 amplitudes (undressed H, T2 = MP2): the reference
    documents this usage (``eom_ccsd.py:56-57``); excitations land near
    the EOM-CCSD values on H2/STO-6G."""
    from pymes_jax.solver import mp2

    n_elec, nb, e_core, e_orb, h_pq, V_pqrs = fcidump.read(
        os.path.join(DATA, "FCIDUMP.H2.sto6g"))
    no = n_elec // 2
    fock = np.asarray(hf.construct_hf_matrix(no, h_pq, V_pqrs))
    eps_i, eps_a = fock.diagonal()[:no], fock.diagonal()[no:]
    dict_t_V = part_2_body_int(no, V_pqrs)
    _, T2 = mp2.solve(eps_i, eps_a, dict_t_V["ijab"], dict_t_V["abij"])

    solver = eom_ccsd.EOM_CCSD(no, n_excit=1)
    e_mp2based = solver.solve(fock, dict_t_V, T2)[0]

    mycc = ccsd.CCSD(no)
    res = mycc.solve(fock, V_pqrs, delta_e=1e-12, max_iter=100)
    fd = mycc.get_T1_dressed_fock(fock, res["t1"], dict_t_V)
    Vd = mycc.get_T1_dressed_V(res["t1"], dict_t_V)
    e_ccsd_based = eom_ccsd.EOM_CCSD(no, n_excit=1).solve(fd, Vd,
                                                          res["t2"])[0]
    assert abs(e_mp2based - e_ccsd_based) < 0.05
    assert e_mp2based > 0


@pytest.mark.slow
def test_eom_ccsd_lih():
    n_elec, nb, e_core, e_orb, h_pq, V_pqrs = fcidump.read(
        os.path.join(DATA, "FCIDUMP.LiH.321g"))
    no = n_elec // 2
    fock = hf.construct_hf_matrix(no, h_pq, V_pqrs)

    mycc = ccsd.CCSD(no)
    mycc.max_iter = 200
    res = mycc.solve(fock, V_pqrs, delta_e=1e-12, max_iter=200)
    assert np.isclose(res["ccsd e"], -0.0190883270951031)

    dict_t_V = part_2_body_int(no, V_pqrs)
    f_dressed = mycc.get_T1_dressed_fock(fock, res["t1"], dict_t_V)
    # dressing only the 11 blocks the sigma builds touch must suffice
    from pymes_jax.solver.ccsd import EOM_DRESSED
    V_dressed = mycc.get_T1_dressed_V(res["t1"], dict_t_V,
                                      {k: None for k in EOM_DRESSED})

    solver = eom_ccsd.EOM_CCSD(no, n_excit=2)
    solver.max_iter = 1000
    e = solver.solve(f_dressed, V_dressed, res["t2"])
    assert np.allclose(e, [0.1180867117168979, 0.154376205595602],
                       atol=1e-7)


def test_hbar_factorized_sigma_equals_term_list():
    """The factorized sigma (precomputed Hbar intermediates) must equal
    the term-list sigma EXACTLY on fully asymmetric random blocks — any
    wrong term or operand-order misread shows up here (VERDICT r1 task 4)."""
    import jax.numpy as jnp

    rng = np.random.default_rng(0)
    no, nv = 3, 6
    nb = no + nv
    f = jnp.asarray(rng.standard_normal((nb, nb)))          # non-symmetric
    V = rng.standard_normal((nb,) * 4)                      # no symmetry
    dV = part_2_body_int(no, jnp.asarray(V))
    T = jnp.asarray(rng.standard_normal((nv, nv, no, no)))
    u1 = jnp.asarray(rng.standard_normal((nv, no)))
    u2 = jnp.asarray(rng.standard_normal((nv, nv, no, no)))

    hb = eom_ccsd.build_hbar(f, dV, T)
    w1a = np.asarray(eom_ccsd.sigma_singles(f, dV, u1, u2, T))
    w1b = np.asarray(eom_ccsd.sigma_singles_hbar(f, dV, hb, u1, u2, T))
    w2a = np.asarray(eom_ccsd.sigma_doubles(f, dV, u1, u2, T))
    w2b = np.asarray(eom_ccsd.sigma_doubles_hbar(f, dV, hb, u1, u2, T))
    assert np.abs(w1a - w1b).max() < 1e-12 * np.abs(w1a).max()
    assert np.abs(w2a - w2b).max() < 1e-12 * np.abs(w2a).max()


def test_hbar_sigma_ozaki_mode_matches_xla():
    """The sliced (ozaki) contraction backend through the factorized
    sigma agrees with the xla backend to f64-class accuracy — sizes above
    the ozaki dispatch threshold so the int8 path actually runs."""
    import jax.numpy as jnp

    rng = np.random.default_rng(1)
    no, nv = 4, 100
    nb = no + nv
    f = jnp.asarray(rng.standard_normal((nb, nb)))
    V = rng.standard_normal((nb,) * 4) * 0.1
    dV = part_2_body_int(no, jnp.asarray(V))
    T = jnp.asarray(rng.standard_normal((nv, nv, no, no)) * 0.05)
    u1 = jnp.asarray(rng.standard_normal((nv, no)))
    u2 = jnp.asarray(rng.standard_normal((nv, nv, no, no)))

    outs = {}
    for mode in ("xla", "ozaki:9:9"):
        hb = eom_ccsd.build_hbar(f, dV, T, contract_mode=mode)
        w1 = np.asarray(eom_ccsd.sigma_singles_hbar(
            f, dV, hb, u1, u2, T, contract_mode=mode))
        w2 = np.asarray(eom_ccsd.sigma_doubles_hbar(
            f, dV, hb, u1, u2, T, contract_mode=mode))
        outs[mode] = (w1, w2)
    for i in range(2):
        a, b = outs["xla"][i], outs["ozaki:9:9"][i]
        assert np.abs(a - b).max() < 1e-11 * max(np.abs(a).max(), 1.0)


def test_davidson_space_exhausted_tiny_basis():
    """H2/STO-6G: the full excitation space is 2-dimensional, so with
    n_excit = 2 the subspace saturates max_dim every iteration.  The
    collapse branch must still record the Ritz values and converge to
    the exact eigenvalues (regression: it skipped the update and
    returned zeros), and guess seeding must spill into the doubles
    block when n_excit exceeds the singles space (nov = 1)."""
    import os
    from pymes_jax.mean_field import hf
    from pymes_jax.solver import ccsd
    from pymes_jax.util import fcidump

    data = os.path.join(os.path.dirname(__file__), "data")
    n_elec, nb, e_core, e_orb, h, V = fcidump.read(
        os.path.join(data, "FCIDUMP.H2.sto6g"))
    no = n_elec // 2
    fock = hf.construct_hf_matrix(no, h, V)
    cc = ccsd.CCSD(no)
    res = cc.solve(fock, V, delta_e=1e-12)
    dV = part_2_body_int(no, V)
    fd = cc.get_T1_dressed_fock(fock, res["t1"], dV)
    Vd = cc.get_T1_dressed_V(res["t1"], dV)

    # exact 2x2 H-bar from the batched sigma
    dav = eom_ccsd.EOM_CCSD(no, n_excit=2)
    U1 = np.eye(2)[:, :1].reshape(2, 1, 1)
    U2 = np.eye(2)[:, 1:].reshape(2, 1, 1, 1, 1)
    W1, W2 = dav._batched_sigma(fd, Vd, U1, U2, res["t2"])
    H = np.array([[np.asarray(W1)[0].ravel()[0],
                   np.asarray(W1)[1].ravel()[0]],
                  [np.asarray(W2)[0].ravel()[0],
                   np.asarray(W2)[1].ravel()[0]]])
    e_exact = np.sort(np.linalg.eigvals(H).real)

    e = np.sort(np.real(dav.solve(fd, Vd, res["t2"])))
    np.testing.assert_allclose(e, e_exact, atol=1e-9)
