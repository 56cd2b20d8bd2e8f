"""Pin the round-4 numerics in the suite (VERDICT r4 task 3).

Round 4 shipped four accuracy-critical mechanisms whose invariants were
first verified only by one-off probe scripts: the half-symmetric T1 dressing, the f32 carriers for
dressing corrections, the mixed-precision FEAST linear solves, and the
mixed-precision MOM-tracked Davidson default.  These tests assert each
invariant directly so a refactor cannot silently degrade them.

Reference parity anchors: the dressing expands the same Λ-transform the
reference hand-expands (``pymes/solver/ccsd.py:290-419``); the Davidson
golden pair at UEG cutoff 10 is the degenerate 5.2402523x pair
(the round-4 root-tracking record).
"""

import os

import numpy as np
import pytest

from pymes_jax.integral.partition import part_2_body_int
from pymes_jax.mean_field import hf
from pymes_jax.models import ueg
from pymes_jax.solver import ccsd, eom_ccsd
from pymes_jax.solver.ccsd import dressed_block
from pymes_jax.solver.feast_eom_ccsd import FEAST_EOM_CCSD
from pymes_jax.util import fcidump

DATA = os.path.join(os.path.dirname(__file__), "data")


def test_half_symmetric_dressing_equals_full_expansion():
    """S = dressed_block(half_symmetric=True) must satisfy
    S + P(ab,ij)·S == full dressing bit-near-exactly on a random T1/V
    (measured 5e-18 in round 4; the terms are emitted pair-by-pair,
    so agreement is rounding-level, not truncation-level)."""
    rng = np.random.default_rng(11)
    no, nv = 3, 6
    n = no + nv
    V = rng.standard_normal((n, n, n, n))
    # the mirror-pair identity term(mirror) = P·term rests on the
    # physical pair-exchange symmetry <pq|rs> = <qp|sr> (electrons are
    # identical) — the ONE symmetry even TC integrals keep
    # (fcidump.py 2-fold restore); impose it on the random V
    V = 0.5 * (V + V.transpose(1, 0, 3, 2))
    T1 = rng.standard_normal((nv, no)) * 0.1
    dV = part_2_body_int(no, V)

    for name in ("abij", "klij"):
        full = np.asarray(dressed_block(name, dV, T1))
        half = np.asarray(dressed_block(name, dV, T1,
                                        half_symmetric=True))
        sym = half + half.transpose(1, 0, 3, 2)
        assert np.abs(sym - full).max() < 1e-14

    # and with the identity term skipped (the production matrix-free
    # config hoists the bare block): corrections-only halves must also
    # P-symmetrise to the corrections-only full expansion
    full_c = np.asarray(dressed_block("abij", dV, T1, skip_identity=True))
    half_c = np.asarray(dressed_block("abij", dV, T1, skip_identity=True,
                                      half_symmetric=True))
    assert np.abs(half_c + half_c.transpose(1, 0, 3, 2)
                  - full_c).max() < 1e-14

    # out_perm composes: the (2,3,0,1)-permuted half must be the permuted
    # image of the natural-order half (the ij-layout residual consumes it
    # in this order)
    half_p = np.asarray(dressed_block("abij", dV, T1, skip_identity=True,
                                      half_symmetric=True,
                                      out_perm=(2, 3, 0, 1)))
    assert np.abs(half_p - half_c.transpose(2, 3, 0, 1)).max() < 1e-14


def test_ccsd_f32_dressing_carriers_match_f64():
    """Matrix-free CCSD with the f32 dressing-correction carriers
    (``dress_precision="f32"``) must converge to the all-f64 dressing
    energy to ≤1e-9 Ha on a T1≠0 system (round 4 measured the
    correction error at 8.8e-10 of |V|; the fixed point self-corrects)."""
    from pymes_jax.ops.ueg_ladder import build_block_ladder, build_ovvv_plans

    u = ueg.UEG(14, 7, 7, 1.0)
    u.init_single_basis(2)
    V = np.asarray(u.eval_2b_integrals())
    no = 7
    fock = np.asarray(hf.construct_hf_matrix(
        no, np.diag(u.kinetic_energies()), V))
    rng = np.random.default_rng(5)
    noise = rng.standard_normal(fock.shape) * 0.02
    fock = fock + noise + noise.T  # break Γ-point momentum symmetry: T1≠0

    dict_V = {k: v for k, v in part_2_body_int(no, V).items()
              if k not in ("abcd", "abci", "iabc", "aibc", "abic")}
    dict_V["_ovvv_plans"] = build_ovvv_plans(u)
    lad_all = build_block_ladder(u, bra="all")

    res = {}
    for prec in ("f64", "f32"):
        r = ccsd.CCSD(no).solve(fock, dict(dict_V), delta_e=1e-10,
                                max_iter=200, ladder=lad_all,
                                dress_precision=prec)
        res[prec] = r
    assert float(np.abs(np.asarray(res["f32"]["t1"])).max()) > 1e-3
    assert abs(res["f32"]["ccsd e"] - res["f64"]["ccsd e"]) < 1e-9


def test_feast_mixed_precision_matches_f64_molecular():
    """FEAST with the default mixed linear solves (f32 Krylov + f64
    iterative refinement) must agree with the all-f64 solves to ≤1e-8 on
    a molecular window (VERDICT r4 task 3c)."""
    n_elec, nb, e_core, e_orb, h_pq, V_pqrs = fcidump.read(
        os.path.join(DATA, "FCIDUMP.H2.sto6g"))
    no = n_elec // 2
    fock = hf.construct_hf_matrix(no, h_pq, V_pqrs)
    mycc = ccsd.CCSD(no)
    res = mycc.solve(fock, V_pqrs, delta_e=1e-12, max_iter=100)
    dict_t_V = part_2_body_int(no, V_pqrs)
    fd = mycc.get_T1_dressed_fock(fock, res["t1"], dict_t_V)
    Vd = mycc.get_T1_dressed_V(res["t1"], dict_t_V)

    dav = eom_ccsd.EOM_CCSD(no, n_excit=1)
    e_dav = dav.solve(fd, Vd, res["t2"])[0]

    evs = {}
    for prec in ("mixed", "f64"):
        s = FEAST_EOM_CCSD(no, e_c=float(e_dav), e_r=0.2, n_trial=2,
                           max_iter=50, tol=1e-10, seed=1)
        s.ls_precision = prec
        s.ls_max_iter = 50
        ev = np.real(np.asarray(s.solve(fd, Vd, res["t2"])))
        evs[prec] = ev[np.argmin(np.abs(ev - e_dav))]
    assert abs(evs["mixed"] - evs["f64"]) < 1e-8
    assert abs(evs["mixed"] - e_dav) < 1e-6


@pytest.mark.slow
def test_mixed_davidson_default_ueg_cutoff10_golden():
    """The DEFAULT Davidson pipeline (f32 phase + f64 polish, MOM
    tracking) must reproduce the f64 golden roots on the UEG system where
    the spurious negative basin exists (cutoff 10, nP=123): the two
    lowest roots are the degenerate 5.2402523x pair — lowest-real f64
    selection historically missed the partner, and an untracked mixed
    run diverges into the −0.6 basin (round-4 record)."""
    from pymes_jax.ops.ueg_ladder import build_block_ladder, build_ovvv_plans
    from pymes_jax.solver import ccd
    import jax.numpy as jnp

    u = ueg.UEG(14, 7, 7, 0.5)
    u.init_single_basis(10)
    no, n_p = 7, u.n_spatial
    nv = n_p - no
    idx, vals = u.eval_2b_integrals(sp=2)
    d = ueg.sparse_to_blocks(idx, vals, n_p, no,
                             names=('klij', 'ijab', 'abij', 'iajb', 'iabj',
                                    'aibj', 'aijb', 'ijka', 'ijak', 'iajk'),
                             dtype=jnp.float64)
    kin = jnp.asarray(u.kinetic_energies())
    eps_i = hf.calcOccupiedOrbE(kin, d['klij'], no)
    eps_a = hf.calcVirtualOrbE(kin, d['aibj'], d['aijb'], no, nv)
    fock = jnp.diag(jnp.concatenate([eps_i, eps_a]))
    bp_all = build_block_ladder(u, bra="all")
    blocks = ccd.CCDBlocks(klij=d['klij'], ijab=d['ijab'], abij=d['abij'],
                           iajb=d['iajb'], iabj=d['iabj'], abcd=None,
                           ladder=bp_all)
    res = ccd.CCD(no).solve(fock, blocks, level_shift=-1.0, max_iter=60)
    assert abs(res["ccd e"] - (-0.5622035872)) < 1e-6  # sanity: converged

    Vd = {k: d[k] for k in ('klij', 'ijab', 'abij', 'iajb', 'iabj',
                            'ijka', 'ijak', 'iajk')}
    Vd["abcd"] = None
    Vd["abcd_ladder"] = bp_all
    Vd["_ovvv_plans"] = build_ovvv_plans(u)
    T2 = jnp.asarray(res["t2 amp"])

    GOLD = 5.2402523  # degenerate pair, split ~2e-8
    dav = eom_ccsd.EOM_CCSD(no, n_excit=2)   # default: mixed + MOM
    roots = np.sort(np.real(dav.solve(fock, Vd, T2)))
    assert np.abs(roots - GOLD).max() < 1e-5

    # f64 pipeline with the same tracking must land on the same pair
    dav64 = eom_ccsd.EOM_CCSD(no, n_excit=2)
    dav64.precision = "f64"
    dav64.root_tracking = "guess"
    roots64 = np.sort(np.real(dav64.solve(fock, Vd, T2)))
    assert np.abs(roots - roots64).max() < 1e-6
