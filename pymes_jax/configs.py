"""Typed solver/model configurations.

The reference configures everything through constructor args, attribute
poking and ``**kwargs`` overrides at ``solve()`` (SURVEY §5.6,
``ccd.py:46-53``, ``test_eom_ccsd.py:25-26``).  These dataclasses are the
structured equivalent; every solver exposes ``from_config`` and the legacy
attribute/kwargs style keeps working.
"""

from dataclasses import asdict, dataclass


@dataclass
class GroundStateConfig:
    """CCD/DCD/drCCD/CCSD/DCSD amplitude-equation settings."""

    no: int = 0
    delta_e: float = 1e-8
    max_iter: int = 50
    level_shift: float = 0.0
    is_diis: bool = True
    diis_dim: int = 6
    is_dcd: bool = False          # distinguishable-cluster approximation
    is_dr_ccd: bool = False       # direct-ring (dRPA) channel only
    is_bruekner: bool = False     # quasi-particle energy updates
    mixed_precision: bool = False  # f32 bulk + f64 polish schedule
    log_iterations: bool = False

    def make_ccd(self):
        from pymes_jax.solver.ccd import CCD

        s = CCD(self.no, delta_e=self.delta_e, is_dcd=self.is_dcd,
                is_diis=self.is_diis, is_dr_ccd=self.is_dr_ccd,
                is_bruekner=self.is_bruekner)
        s.max_iter = self.max_iter
        s.dim_space = self.diis_dim
        s.log_iterations = self.log_iterations
        return s

    def make_ccsd(self):
        from pymes_jax.solver.ccsd import CCSD

        s = CCSD(self.no, is_diis=self.is_diis, delta_e=self.delta_e,
                 is_dcsd=self.is_dcd)
        s.max_iter = self.max_iter
        s.dim_space = self.diis_dim
        s.log_iterations = self.log_iterations
        return s


@dataclass
class EOMConfig:
    """Davidson EOM-CCSD settings."""

    no: int = 0
    n_excit: int = 3
    max_iter: int = 500
    e_epsilon: float = 1e-8
    max_dim_factor: int = 4

    def make(self):
        from pymes_jax.solver.eom_ccsd import EOM_CCSD

        s = EOM_CCSD(self.no, n_excit=self.n_excit)
        s.max_iter = self.max_iter
        s.e_epsilon = self.e_epsilon
        s.max_dim = self.n_excit * self.max_dim_factor
        return s


@dataclass
class FEASTConfig:
    """FEAST contour-filter settings (native or generic-kernel flavour)."""

    no: int = 0
    e_c: float = 0.0
    e_r: float = 1.0
    n_trial: int = 5
    n_quad: int = 8
    max_iter: int = 20
    tol: float = 1e-12
    ls_max_iter: int = 20
    seed: int = None

    def make(self):
        from pymes_jax.solver.feast_eom_ccsd import FEAST_EOM_CCSD

        s = FEAST_EOM_CCSD(self.no, e_c=self.e_c, e_r=self.e_r,
                           n_trial=self.n_trial, max_iter=self.max_iter,
                           tol=self.tol, n_quad=self.n_quad, seed=self.seed)
        s.ls_max_iter = self.ls_max_iter
        return s


@dataclass
class RTConfig:
    """CIF real-time propagation settings."""

    no: int = 0
    e_c: float = 0.0
    e_r: float = 1.0
    dt: float = 0.1
    n_quad: int = 16
    ls_max_iter: int = 100

    def make(self):
        from pymes_jax.solver.rt_eom_ccsd import RT_EOM_CCSD

        s = RT_EOM_CCSD(self.no, e_c=self.e_c, e_r=self.e_r, dt=self.dt,
                        n_quad=self.n_quad)
        s.ls_max_iter = self.ls_max_iter
        return s


@dataclass
class UEGConfig:
    """Uniform electron gas model settings."""

    n_ele: int = 14
    rs: float = 1.0
    cutoff: float = 2.0
    k_shift: tuple = (0.0, 0.0, 0.0)
    correlator: str = None        # name of a UEG correlator method
    gamma: float = None
    k_cutoff: float = None

    def make(self):
        from pymes_jax.models.ueg import UEG

        u = UEG(self.n_ele, self.n_ele // 2, self.n_ele // 2, self.rs)
        u.init_single_basis(self.cutoff, list(self.k_shift))
        u.gamma = self.gamma
        u.k_cutoff = self.k_cutoff
        if self.correlator is not None:
            u.correlator = getattr(u, self.correlator)
        return u


def to_dict(cfg):
    return asdict(cfg)
