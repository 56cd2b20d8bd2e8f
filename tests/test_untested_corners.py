"""Direct coverage for formerly test-free modules (VERDICT r1 task 7):
tcfactors.read, PySCF-shaped adapters, and the supercell→primitive
optimizer workflow (task 9).  (The experimental Pallas matmul kernels
these tests once covered were pruned in round 4 — the sector-GEMM /
Ozaki sliced engine replaced custom kernels on every production path,
VERDICT r3 task 7.)
"""

import numpy as np
import pytest
import scipy.linalg

import jax.numpy as jnp


def test_tcfactors_h5_fixture(tmp_path):
    h5py = pytest.importorskip("h5py")
    from pymes_jax.util import tcfactors

    n_orb, n_grid = 4, 10
    rng = np.random.default_rng(2)
    w = rng.random(n_grid)
    mo = rng.standard_normal((n_orb, n_grid))
    yc = rng.standard_normal((n_orb, n_grid))
    path = str(tmp_path / "tcfactors.h5")
    with h5py.File(path, "w") as f:
        f["nBasis"] = np.array([n_orb])
        f["nGrid"] = np.array([n_grid])
        f["weights"] = w
        f["mo_vals"] = mo
        f["ycoulomb"] = yc
    nb, ng, w2, mo2, yc2 = tcfactors.read(path)
    assert (nb, ng) == (n_orb, n_grid)
    np.testing.assert_array_equal(w2, w)
    np.testing.assert_array_equal(mo2, mo)
    np.testing.assert_array_equal(yc2, yc)
    with pytest.raises(NameError):
        tcfactors.read("tcfactors.txt")


class _MockPyscfEOM:
    """Object with the PySCF EOMEESinglet interface shape."""

    def __init__(self, ham):
        self.ham = ham

    def vector_size(self):
        return self.ham.shape[0]

    def get_diag(self):
        return (self.ham.diagonal().copy(), None)

    def make_imds(self):
        return "imds"

    def matvec(self, x, imds=None):
        assert imds == "imds"
        return self.ham @ x


def test_feast_pyscf_adapter_against_mock():
    """FEAST_EOMEESinglet driven by a mock with the PySCF interface shape
    must find the eigenvalue inside the window (the H2O oracle itself
    needs pyscf, absent here — reference test_feast_pyscf.py:10-60)."""
    from pymes_jax.solver.feast_eom_rccsd import FEAST_EOMEESinglet

    rng = np.random.default_rng(5)
    dim = 24
    ham = np.diag(np.arange(dim) * 0.4)
    ham += 0.03 * (rng.random((dim, dim)) - 0.5)
    ham = (ham + ham.T) / 2
    e_all = np.sort(np.linalg.eigvals(ham).real)
    target = e_all[4]

    solver = FEAST_EOMEESinglet(eom=_MockPyscfEOM(ham))
    eigvals, vecs = solver.kernel(nroots=1, e_c=target, e_r=0.15,
                                  ngl_pts=8, n_jobs=1)
    assert np.min(np.abs(np.real(eigvals) - target)) < 1e-7


def test_cifrt_pyscf_adapter_against_mock():
    """One CIFRT step through the adapter = exp(i·H·dt)·u (normalized)."""
    from pymes_jax.solver.feast_eom_rccsd import CIFRT_EOMEESinglet

    rng = np.random.default_rng(6)
    dim = 12
    ham = np.diag(np.linspace(0.0, 1.5, dim))
    ham += 0.02 * (lambda a: (a + a.T) / 2)(rng.random((dim, dim)) - 0.5)
    u0 = rng.random(dim) - 0.5
    u0 /= np.linalg.norm(u0)
    dt = 0.1

    solver = CIFRT_EOMEESinglet(eom=_MockPyscfEOM(ham))
    solver.ls_conv_tol = 1e-12
    got = solver.kernel(dt=dt, e_c=0.75, e_r=1.0, ngl_pts=64,
                        guess=[u0.astype(complex)])
    got = np.asarray(got)
    got /= np.linalg.norm(got)
    want = scipy.linalg.expm(1j * ham * dt) @ u0
    want /= np.linalg.norm(want)
    phase = np.vdot(got, want)
    phase /= np.abs(phase)
    assert np.linalg.norm(got * phase - want) < 1e-6


def test_optimizer_supercell_projection():
    """Supercell→primitive force projection + relaxation step
    (reference structure.py:395-440)."""
    from pymes_jax.util.structure import Structure, \
        relax_primitive_from_supercell

    # primitive: 2 atoms in a unit cube; supercell: 2x1x1 copies
    pc = Structure()
    pc.cellVecs = np.eye(3)
    pc.latticeConstant = 1.0
    pc.numAtom = 2
    pc.posAtom = np.array([[0.0, 0.0, 0.0], [0.5, 0.5, 0.5]])
    pc.typeCor = "C"
    pc.convert2SpgCell()

    sc = Structure()
    sc.cellVecs = np.diag([2.0, 1.0, 1.0])
    sc.latticeConstant = 1.0
    sc.numAtom = 4
    sc.posAtom = np.array([[0.0, 0.0, 0.0], [0.5, 0.5, 0.5],
                           [1.0, 0.0, 0.0], [1.5, 0.5, 0.5]])
    sc.typeCor = "C"
    sc.convert2SpgCell()

    # identical force on both periodic images; opposite on the two basis
    # atoms (so the rigid-body projection keeps it)
    f = np.array([[0.2, 0.0, 0.0], [-0.2, 0.0, 0.0],
                  [0.2, 0.0, 0.0], [-0.2, 0.0, 0.0]])
    map2pc = np.array([[0, 0], [1, 1]])  # 0-based (pc_atom, sc_row)

    pos0 = pc.posAtom.copy()
    pc_out, transform, updated = relax_primitive_from_supercell(
        pc, sc, f, map2pc, threshhold=1e-3, timestep=0.01)
    np.testing.assert_array_equal(transform, np.diag([2.0, 1.0, 1.0]))
    assert updated
    # gradient step dt * F on the primitive atoms (map is 1-based:
    # rows 0 and 1 of the supercell forces)
    np.testing.assert_allclose(
        pc_out.posAtom - pos0,
        0.01 * np.array([[0.2, 0, 0], [-0.2, 0, 0]]), atol=1e-12)
