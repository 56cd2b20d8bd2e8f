"""PySCF-bridged FEAST / CIF-RT EOM-CCSD adapters.

Capability parity with ``pymes/solver/feast_eom_rccsd.py:215`` and
``pymes/solver/rt_eom_rccsd.py:101``: thin classes binding the generic
:mod:`pymes_jax.solver.feast_kernel` to PySCF's ``EOMEE`` singlet matvec
(packed vector size nov + nov(nov+1)/2).  PySCF is an optional dependency —
absent from this environment — so the classes raise a clear ImportError at
construction; the kernel itself is fully exercised against the native sigma
builds and dense Hamiltonians in the test-suite.
"""

import numpy as np

from pymes_jax.solver import feast_kernel

try:
    from pyscf.cc import eom_rccsd as _pyscf_eom
except ImportError:  # pragma: no cover - pyscf absent in this image
    _pyscf_eom = None


def _require_pyscf():
    if _pyscf_eom is None:
        raise ImportError(
            "pymes_jax.solver.feast_eom_rccsd requires pyscf (optional "
            "dependency, not available in this environment); the generic "
            "FEAST kernel in pymes_jax.solver.feast_kernel works without "
            "it.")


class FEAST_EOMEESinglet:
    """FEAST over PySCF's singlet EOM-CCSD matvec (reference API).

    ``eom`` injects any object with the PySCF EOM interface shape
    (``vector_size/get_diag/make_imds/matvec``) — used to exercise this
    adapter without pyscf (absent from this environment).
    """

    def __init__(self, cc=None, eom=None):
        if eom is None:
            _require_pyscf()
            eom = _pyscf_eom.EOMEESinglet(cc)
        self._eom = eom
        self.ls_max_iter = 100
        self.ls_conv_tol = 1e-4
        self.max_cycle = 50
        self.conv_tol = 1e-7

    def vector_size(self):
        return self._eom.vector_size()

    def get_diag(self):
        return self._eom.get_diag()[0]

    def kernel(self, nroots=1, e_c=None, e_r=None, e_brd=1, emin=None,
               emax=None, ngl_pts=8, n_aux=0, guess=None, n_jobs=-1,
               **kwargs):
        imds = self._eom.make_imds()
        diag = self.get_diag()

        def matvec(x):
            return self._eom.matvec(x, imds)

        return feast_kernel.feast(
            matvec, diag, size=self.vector_size(), nroots=nroots, e_c=e_c,
            e_r=e_r, e_brd=e_brd, emin=emin, emax=emax, ngl_pts=ngl_pts,
            n_aux=n_aux, guess=guess, max_cycle=self.max_cycle,
            conv_tol=self.conv_tol, ls_max_iter=self.ls_max_iter,
            ls_conv_tol=self.ls_conv_tol, n_jobs=n_jobs)


class CIFRT_EOMEESinglet:
    """CIF real-time propagation over PySCF's singlet matvec
    (reference API: ``rt_eom_rccsd.py:101``)."""

    def __init__(self, cc=None, eom=None):
        if eom is None:
            _require_pyscf()
            eom = _pyscf_eom.EOMEESinglet(cc)
        self._eom = eom
        self.ls_max_iter = 100
        self.ls_conv_tol = 1e-4

    def vector_size(self):
        return self._eom.vector_size()

    def kernel(self, dt=0.1, e_c=None, e_r=None, ngl_pts=16, guess=None,
               **kwargs):
        imds = self._eom.make_imds()
        diag = self._eom.get_diag()[0]

        def matvec(x):
            return self._eom.matvec(x, imds)

        if guess is None:
            rng = np.random.default_rng()
            g = rng.random(self.vector_size()) - 0.5
            guess = [g / np.linalg.norm(g)]
        return feast_kernel.rt_step(
            matvec, diag, guess[0], dt=dt, e_c=e_c, e_r=e_r,
            ngl_pts=ngl_pts, ls_max_iter=self.ls_max_iter,
            ls_conv_tol=self.ls_conv_tol)
