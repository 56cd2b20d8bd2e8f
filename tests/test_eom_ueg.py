"""EOM-CCSD on the uniform electron gas.

The reference only runs EOM on molecular FCIDUMPs; this exercises the same
machinery on the metallic plane-wave Hamiltonian (degenerate shells,
gapless limit).  In a minimal cell the lowest H̄ roots can sit below zero
(genuine reference-state instability), so the assertions target solver
self-consistency: finite real roots, stable under subspace enlargement.
"""

import numpy as np
import pytest

from pymes_jax.integral.partition import part_2_body_int
from pymes_jax.mean_field import hf
from pymes_jax.models import ueg
from pymes_jax.solver import ccsd, eom_ccsd


@pytest.mark.slow
def test_ueg_eom_davidson_consistency():
    nel, rs, cutoff = 14, 1.0, 2
    no = nel // 2
    u = ueg.UEG(nel, no, no, rs)
    u.init_single_basis(cutoff)
    V = np.asarray(u.eval_2b_integrals())
    fock = np.asarray(hf.construct_hf_matrix(
        no, np.diag(u.kinetic_energies()), V))

    cc = ccsd.CCSD(no)
    res = cc.solve(fock, V, delta_e=1e-11, max_iter=100)
    dict_V = part_2_body_int(no, V)
    fd = cc.get_T1_dressed_fock(fock, res["t1"], dict_V)
    Vd = cc.get_T1_dressed_V(res["t1"], dict_V)

    dav2 = eom_ccsd.EOM_CCSD(no, n_excit=2)
    dav2.max_iter = 2000
    e2 = np.sort(dav2.solve(fd, Vd, res["t2"]))
    assert np.all(np.isfinite(e2))

    # matrix-free sigma: replace the dressed abcd block with the gather
    # plan (exact here: T1 = 0 at the Γ-point, so V̄_abcd = V_abcd).
    # Compared at the sigma-matvec level — bitwise-level equality is the
    # actual property; full Davidson outcomes are basin-sensitive on this
    # pathological metallic spectrum (negative near-degenerate roots), so
    # tiny rounding differences between the two jaxprs can legitimately
    # select different roots.
    from pymes_jax.ops.ueg_ladder import build_ueg_ladder

    assert float(np.abs(np.asarray(res["t1"])).max()) < 1e-10
    Vd_mf = {k: v for k, v in Vd.items() if k != "abcd"}
    Vd_mf["abcd"] = None
    Vd_mf["abcd_ladder"] = build_ueg_ladder(u)
    rng = np.random.default_rng(4)
    nv = res["t2"].shape[0]
    U1 = rng.standard_normal((2, nv, no))
    U2 = rng.standard_normal((2, nv, nv, no, no))
    dav_mf = eom_ccsd.EOM_CCSD(no, n_excit=2)
    W1a, W2a = dav_mf._batched_sigma(fd, Vd, U1, U2, res["t2"])
    W1b, W2b = dav_mf._batched_sigma(fd, Vd_mf, U1, U2, res["t2"])
    assert np.abs(W1a - W1b).max() < 1e-12
    assert np.abs(W2a - W2b).max() < 1e-12

    # the UEG's degenerate shells make trailing roots of a small-subspace
    # Davidson unreliable (n_excit=2 misses a degenerate partner and its
    # 2nd "root" is a subspace mixture); the invariant that holds is that
    # the LOWEST root is stable under subspace enlargement
    dav3 = eom_ccsd.EOM_CCSD(no, n_excit=3)
    dav3.max_iter = 2000
    e3 = np.sort(dav3.solve(fd, Vd, res["t2"]))
    assert abs(e3[0] - e2[0]) < 1e-5
    # and the enlarged run resolves the degenerate pair
    assert abs(e3[1] - e3[0]) < 1e-5


def test_matrix_free_sigma_t1_dressed():
    """Matrix-free EOM sigma with NONZERO T1: the 'abcd_t1' path must
    reproduce the dense dressed-V̄_abcd sigma exactly (VERDICT r1 task 4;
    the bare-ladder fallback is only valid at T1 = 0)."""
    u = ueg.UEG(14, 7, 7, 1.0)
    u.init_single_basis(2)
    V = np.asarray(u.eval_2b_integrals())
    no = 7
    fock = np.asarray(hf.construct_hf_matrix(
        no, np.diag(u.kinetic_energies()), V))
    rng = np.random.default_rng(5)
    noise = rng.standard_normal(fock.shape) * 0.02
    fock = fock + noise + noise.T

    cc = ccsd.CCSD(no)
    res = cc.solve(fock, V, delta_e=1e-10, max_iter=200)
    assert float(np.abs(np.asarray(res["t1"])).max()) > 1e-3  # genuine T1

    dict_V = part_2_body_int(no, V)
    fd = cc.get_T1_dressed_fock(fock, res["t1"], dict_V)
    Vd = cc.get_T1_dressed_V(res["t1"], dict_V)

    from pymes_jax.ops.ueg_ladder import build_ueg_ladder
    Vd_mf = {k: v for k, v in Vd.items() if k != "abcd"}
    Vd_mf["abcd"] = None
    Vd_mf["abcd_ladder"] = build_ueg_ladder(u, bra="all")
    Vd_mf["abcd_t1"] = res["t1"]

    nv = res["t2"].shape[0]
    U1 = rng.standard_normal((2, nv, no))
    U2 = rng.standard_normal((2, nv, nv, no, no))
    dav = eom_ccsd.EOM_CCSD(no, n_excit=2)
    W1a, W2a = dav._batched_sigma(fd, Vd, U1, U2, res["t2"])
    W1b, W2b = dav._batched_sigma(fd, Vd_mf, U1, U2, res["t2"])
    assert np.abs(np.asarray(W1a) - np.asarray(W1b)).max() < 1e-11
    assert np.abs(np.asarray(W2a) - np.asarray(W2b)).max() < 1e-11

    # the bare fallback (no abcd_t1) must now DIFFER — T1 is nonzero
    Vd_bare = dict(Vd_mf)
    del Vd_bare["abcd_t1"]
    _, W2c = dav._batched_sigma(fd, Vd_bare, U1, U2, res["t2"])
    assert np.abs(np.asarray(W2a) - np.asarray(W2c)).max() > 1e-6


def test_matrix_free_sigma_no_ovvv_blocks():
    """EOM sigma with NO ovvv blocks at all: the <ov|vv>-class terms run
    as OVVV momentum gathers + all-bra ladder corners (same machinery as
    matrix-free CCSD).  Exact vs the dense-block factorized sigma at the
    Γ-point (T1 = 0, so undressed blocks are the dressed ones)."""
    import jax.numpy as jnp
    from pymes_jax.ops.ueg_ladder import (build_block_ladder,
                                          build_ovvv_plans)
    from pymes_jax.solver import ccd, mp2
    from pymes_jax.mean_field import hf as hf_mod

    u = ueg.UEG(14, 7, 7, 1.0)
    u.init_single_basis(2)
    V = np.asarray(u.eval_2b_integrals())
    no = 7
    nv = u.n_spatial - no
    fock = np.asarray(hf_mod.construct_hf_matrix(
        no, np.diag(u.kinetic_energies()), V))
    dict_V = part_2_body_int(no, jnp.asarray(V))
    eps = np.diag(fock)
    _, T2 = mp2.solve(jnp.asarray(eps[:no]), jnp.asarray(eps[no:]),
                      dict_V["ijab"], dict_V["abij"], 0.0)

    rng = np.random.default_rng(6)
    U1 = rng.standard_normal((2, nv, no))
    U2 = rng.standard_normal((2, nv, nv, no, no))

    dav = eom_ccsd.EOM_CCSD(no, n_excit=2)
    W1a, W2a = dav._batched_sigma(jnp.asarray(fock), dict_V, U1, U2, T2)

    V_mf = {k: v for k, v in dict_V.items()
            if k not in ("abcd", "iabc", "abic", "aibc", "abci", "aibj",
                         "aijb", "iajb_", "ijba")}
    V_mf.pop("iabc", None)
    V_mf["abcd_ladder"] = build_block_ladder(u, bra="all")
    V_mf["_ovvv_plans"] = build_ovvv_plans(u)
    dav2 = eom_ccsd.EOM_CCSD(no, n_excit=2)
    W1b, W2b = dav2._batched_sigma(jnp.asarray(fock), V_mf, U1, U2, T2)
    assert np.abs(np.asarray(W1a) - np.asarray(W1b)).max() < 1e-11
    assert np.abs(np.asarray(W2a) - np.asarray(W2b)).max() < 1e-11

    # gather-plan variant of the same mode
    from pymes_jax.ops.ueg_ladder import build_ueg_ladder
    V_mf["abcd_ladder"] = build_ueg_ladder(u, bra="all")
    dav3 = eom_ccsd.EOM_CCSD(no, n_excit=2)
    W1c, W2c = dav3._batched_sigma(jnp.asarray(fock), V_mf, U1, U2, T2)
    assert np.abs(np.asarray(W1a) - np.asarray(W1c)).max() < 1e-11
    assert np.abs(np.asarray(W2a) - np.asarray(W2c)).max() < 1e-11


def test_matrix_free_sigma_no_ovvv_t1_dressed():
    """T1 ≠ 0 (noisy-Fock UEG) matrix-free EOM sigma with NO ovvv blocks:
    every dressed <ov|vv>-class term expands into bare gathers + small-
    block T1 corrections.  Must equal the dense dressed-block sigma
    exactly."""
    import jax.numpy as jnp
    from pymes_jax.ops.ueg_ladder import (build_block_ladder,
                                          build_ovvv_plans)

    u = ueg.UEG(14, 7, 7, 1.0)
    u.init_single_basis(2)
    V = np.asarray(u.eval_2b_integrals())
    no = 7
    nv = u.n_spatial - no
    fock = np.asarray(hf.construct_hf_matrix(
        no, np.diag(u.kinetic_energies()), V))
    rng = np.random.default_rng(5)
    noise = rng.standard_normal(fock.shape) * 0.02
    fock = fock + noise + noise.T

    cc = ccsd.CCSD(no)
    res = cc.solve(fock, V, delta_e=1e-10, max_iter=200)
    assert float(np.abs(np.asarray(res["t1"])).max()) > 1e-3

    dict_V = part_2_body_int(no, V)
    fd = cc.get_T1_dressed_fock(fock, res["t1"], dict_V)
    Vd = cc.get_T1_dressed_V(res["t1"], dict_V)

    rng2 = np.random.default_rng(9)
    U1 = rng2.standard_normal((2, nv, no))
    U2 = rng2.standard_normal((2, nv, nv, no, no))

    dav = eom_ccsd.EOM_CCSD(no, n_excit=2)
    W1a, W2a = dav._batched_sigma(fd, Vd, U1, U2, res["t2"])

    V_mf = {k: v for k, v in Vd.items()
            if k not in ("abcd", "iabc", "abic", "aibc", "abci")}
    V_mf["abcd"] = None
    V_mf["abcd_ladder"] = build_block_ladder(u, bra="all")
    V_mf["abcd_t1"] = jnp.asarray(res["t1"])
    V_mf["_ovvv_plans"] = build_ovvv_plans(u)
    V_mf["_bare"] = {k: dict_V[k] for k in ("iajb", "iabj", "ijka")}
    dav2 = eom_ccsd.EOM_CCSD(no, n_excit=2)
    W1b, W2b = dav2._batched_sigma(fd, V_mf, U1, U2, res["t2"])
    assert np.abs(np.asarray(W1a) - np.asarray(W1b)).max() < 1e-10
    assert np.abs(np.asarray(W2a) - np.asarray(W2b)).max() < 1e-10
