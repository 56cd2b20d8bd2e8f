"""Matrix-free UEG ladder: exactness vs the dense contraction, and the
full CCD oracle through the storage-free path."""

import numpy as np

from pymes_jax.mean_field import hf
from pymes_jax.models import ueg
from pymes_jax.ops.ueg_ladder import build_ueg_ladder, ueg_ladder_apply
from pymes_jax.solver import ccd


def test_ladder_matches_dense():
    u = ueg.UEG(14, 7, 7, 1.0)
    u.init_single_basis(2)
    V = u.eval_2b_integrals()
    no = 7
    nv = u.n_spatial - no
    rng = np.random.default_rng(0)
    T = rng.standard_normal((nv, nv, no, no))

    lad = build_ueg_ladder(u)
    R_mf = np.asarray(ueg_ladder_apply(lad, T))
    R_dense = np.einsum("abcd,cdij->abij", V[no:, no:, no:, no:], T)
    assert np.abs(R_mf - R_dense).max() < 1e-12
    # chunking must not change the result
    R_c1 = np.asarray(ueg_ladder_apply(lad, T, chunk=1))
    R_c32 = np.asarray(ueg_ladder_apply(lad, T, chunk=32))
    assert np.abs(R_c1 - R_dense).max() < 1e-12
    assert np.abs(R_c32 - R_dense).max() < 1e-12


def test_ladder_matches_dense_hermitian_tc():
    u = ueg.UEG(14, 7, 7, 1.0)
    u.init_single_basis(2)
    u.gamma = None
    u.k_cutoff = u.L / (2 * np.pi) * 2.3225029893472993
    V = u.eval_2b_integrals(correlator=u.trunc, is_only_hermi_2b=True, sp=0)
    no = 7
    nv = u.n_spatial - no
    rng = np.random.default_rng(1)
    T = rng.standard_normal((nv, nv, no, no))

    lad = build_ueg_ladder(u, correlator=u.trunc, is_only_hermi_2b=True)
    R_mf = np.asarray(ueg_ladder_apply(lad, T))
    R_dense = np.einsum("abcd,cdij->abij", V[no:, no:, no:, no:], T)
    assert np.abs(R_mf - R_dense).max() < 1e-12


def test_dressed_ladder_matches_dense():
    """Matrix-free T1-dressed ladder (all-bra gather + rank-1 Λ) equals the
    dense dressed V̄_abcd contraction."""
    from pymes_jax.ops.ueg_ladder import dressed_ladder_apply
    from pymes_jax.solver.ccsd import get_T1_dressed_V
    from pymes_jax.integral.partition import part_2_body_int

    u = ueg.UEG(14, 7, 7, 1.0)
    u.init_single_basis(2)
    V = np.asarray(u.eval_2b_integrals())
    no = 7
    nv = u.n_spatial - no
    rng = np.random.default_rng(2)
    T1 = rng.standard_normal((nv, no)) * 0.1
    T2 = rng.standard_normal((nv, nv, no, no)) * 0.1

    Vd = get_T1_dressed_V(T1, part_2_body_int(no, V), keys=("abcd",))
    want = np.einsum("abcd,cdij->abij", np.asarray(Vd["abcd"]), T2)

    lad_all = build_ueg_ladder(u, bra="all")
    got = np.asarray(dressed_ladder_apply(lad_all, T1, T2, no))
    assert np.abs(got - want).max() < 1e-12


def test_ueg_ccsd_matrix_free_matches_dense():
    """Full CCSD through the matrix-free dressed ladder equals dense CCSD
    (no nv⁴ object is ever built on the matrix-free path).

    The Fock matrix gets small symmetric off-diagonal noise so that T1 is
    genuinely NONZERO — at the clean Γ-point UEG, momentum conservation
    forces T1 ≡ 0, which would mask any defect in the T1-dressed ladder
    assembly (it did: an earlier version double-counted the bra-dressing
    terms, invisible at T1 = 0, caught by review)."""
    from pymes_jax.integral.partition import part_2_body_int
    from pymes_jax.solver import ccsd as ccsd_mod

    u = ueg.UEG(14, 7, 7, 1.0)
    u.init_single_basis(2)
    V = np.asarray(u.eval_2b_integrals())
    no = 7
    fock = np.asarray(hf.construct_hf_matrix(
        no, np.diag(u.kinetic_energies()), V))
    rng = np.random.default_rng(5)
    noise = rng.standard_normal(fock.shape) * 0.02
    fock = fock + noise + noise.T

    res_dense = ccsd_mod.CCSD(no).solve(fock, V, delta_e=1e-10,
                                        max_iter=200)
    assert float(np.abs(np.asarray(res_dense["t1"])).max()) > 1e-3

    dict_V = {k: v for k, v in part_2_body_int(no, V).items()
              if k not in ("abcd", "abci")}
    lad_all = build_ueg_ladder(u, bra="all")
    res_mf = ccsd_mod.CCSD(no).solve(fock, dict_V, delta_e=1e-10,
                                     max_iter=200, ladder=lad_all)
    assert abs(res_mf["ccsd e"] - res_dense["ccsd e"]) < 1e-9


def test_ueg_ccd_oracle_matrix_free():
    """The UEG CCD golden energy through the matrix-free ladder — the nv⁴
    ``abcd`` block is never built."""
    nel, rs, cutoff = 14, 0.5, 5
    no = nel // 2
    u = ueg.UEG(nel, no, no, rs)
    u.init_single_basis(cutoff)
    idx, vals = u.eval_2b_integrals(sp=2)
    n_p = u.n_spatial

    d = ueg.sparse_to_blocks(idx, vals, n_p, no,
                             names=("klij", "ijab", "abij", "iajb", "iabj",
                                    "aibj", "aijb"))
    kin = u.kinetic_energies()
    import jax.numpy as jnp
    eps_i = hf.calcOccupiedOrbE(jnp.asarray(kin), d["klij"], no)
    eps_a = hf.calcVirtualOrbE(jnp.asarray(kin), d["aibj"], d["aijb"], no,
                               n_p - no)
    fock = np.diag(np.concatenate([np.asarray(eps_i), np.asarray(eps_a)]))

    blocks = ccd.CCDBlocks(klij=d["klij"], ijab=d["ijab"], abij=d["abij"],
                           iajb=d["iajb"], iabj=d["iabj"], abcd=None,
                           ladder=build_ueg_ladder(u))
    solver = ccd.CCD(no, is_diis=True)
    res = solver.solve(jnp.asarray(fock), blocks, level_shift=-1.0,
                       max_iter=60)
    assert abs(res["ccd e"] - (-0.5120153512190824)) < 1e-6


def test_ueg_ccsd_fully_matrix_free_no_ovvv():
    """CCSD through gather plans ONLY — no abcd AND no ovvv-class block
    on device (their T1 contractions run as momentum gathers; the singles
    ovvv term comes from the all-bra ladder W).  Must equal dense CCSD
    with genuinely nonzero T1 (VERDICT r1 task 6)."""
    from pymes_jax.integral.partition import part_2_body_int
    from pymes_jax.ops.ueg_ladder import build_ovvv_plans
    from pymes_jax.solver import ccsd as ccsd_mod

    u = ueg.UEG(14, 7, 7, 1.0)
    u.init_single_basis(2)
    V = np.asarray(u.eval_2b_integrals())
    no = 7
    fock = np.asarray(hf.construct_hf_matrix(
        no, np.diag(u.kinetic_energies()), V))
    rng = np.random.default_rng(5)
    noise = rng.standard_normal(fock.shape) * 0.02
    fock = fock + noise + noise.T

    res_dense = ccsd_mod.CCSD(no).solve(fock, V, delta_e=1e-10,
                                        max_iter=200)
    assert float(np.abs(np.asarray(res_dense["t1"])).max()) > 1e-3

    dict_V = {k: v for k, v in part_2_body_int(no, V).items()
              if k not in ("abcd", "abci", "iabc", "aibc", "abic",
                           "iabc")}
    dict_V["_ovvv_plans"] = build_ovvv_plans(u)
    lad_all = build_ueg_ladder(u, bra="all")
    res_mf = ccsd_mod.CCSD(no).solve(fock, dict_V, delta_e=1e-10,
                                     max_iter=200, ladder=lad_all)
    assert abs(res_mf["ccsd e"] - res_dense["ccsd e"]) < 1e-9


def test_block_ladder_matches_dense_and_solves():
    """Momentum-block-diagonal ladder (BlockLadder): exact vs dense for
    Coulomb + hermitian-TC + all-bra, and drives the full matrix-free CCD
    solve to the same fixed point as the gather plan."""
    import jax.numpy as jnp
    from pymes_jax.ops.ueg_ladder import (build_block_ladder,
                                          block_ladder_apply,
                                          block_ladder_apply_ij)

    u = ueg.UEG(14, 7, 7, 1.0)
    u.init_single_basis(2)
    V = np.asarray(u.eval_2b_integrals())
    no = 7
    nv = u.n_spatial - no
    rng = np.random.default_rng(3)
    T = rng.standard_normal((nv, nv, no, no))
    R_dense = np.einsum("abcd,cdij->abij", V[no:, no:, no:, no:], T)

    bp = build_block_ladder(u)
    assert np.abs(np.asarray(block_ladder_apply(bp, T))
                  - R_dense).max() < 1e-12
    R_ij = np.asarray(block_ladder_apply_ij(bp, T.transpose(2, 3, 0, 1)))
    assert np.abs(R_ij.transpose(2, 3, 0, 1) - R_dense).max() < 1e-12

    bpa = build_block_ladder(u, bra="all")
    W_dense = np.einsum("pqcd,cdij->pqij", V[:, :, no:, no:], T)
    assert np.abs(np.asarray(block_ladder_apply(bpa, T))
                  - W_dense).max() < 1e-12

    # full CCD solve through the block plan (both layouts)
    kin = jnp.asarray(u.kinetic_energies())
    Vj = jnp.asarray(V)
    eps_i = hf.calcOccupiedOrbE(kin, Vj[:no, :no, :no, :no], no)
    eps_a = hf.calcVirtualOrbE(kin, Vj[no:, :no, no:, :no],
                               Vj[no:, :no, :no, no:], no, nv)
    fock = jnp.diag(jnp.concatenate([eps_i, eps_a]))
    blocks = ccd.CCDBlocks(
        klij=Vj[:no, :no, :no, :no], ijab=Vj[:no, :no, no:, no:],
        abij=Vj[no:, no:, :no, :no], iajb=Vj[:no, no:, :no, no:],
        iabj=Vj[:no, no:, no:, :no], abcd=None, ladder=bp)
    from pymes_jax.solver import mp2
    _, T0 = mp2.solve(eps_i, eps_a, blocks.ijab, blocks.abij, -1.0)
    e_ref = None
    for layout in ("abij", "ijab"):
        e, *_ = ccd.ccd_solve_jit(fock, blocks, no, T0, level_shift=-1.0,
                                  delta_e=1e-10, max_iter=80,
                                  layout=layout)
        if e_ref is None:
            e_ref = float(e)
        else:
            assert abs(float(e) - e_ref) < 1e-10
    # against the dense-abcd solve
    blocks_d = blocks._replace(abcd=Vj[no:, no:, no:, no:], ladder=None)
    e_d, *_ = ccd.ccd_solve_jit(fock, blocks_d, no, T0, level_shift=-1.0,
                                delta_e=1e-10, max_iter=80)
    assert abs(e_ref - float(e_d)) < 1e-10
    # ozaki block path (sector matmuls as Ozaki slice products)
    e_oz, *_ = ccd.ccd_solve_jit(fock, blocks, no, T0, level_shift=-1.0,
                                 delta_e=1e-10, max_iter=80,
                                 contract_mode="ozaki:9:9", layout="ijab")
    assert abs(e_ref - float(e_oz)) < 1e-9


def test_block_ladder_ccsd_dressed():
    """Matrix-free CCSD through the BlockLadder all-bra plan with nonzero
    T1 equals the dense CCSD (same setup as the no-ovvv test)."""
    from pymes_jax.integral.partition import part_2_body_int
    from pymes_jax.solver import ccsd as ccsd_mod
    from pymes_jax.ops.ueg_ladder import build_block_ladder

    u = ueg.UEG(14, 7, 7, 1.0)
    u.init_single_basis(2)
    V = np.asarray(u.eval_2b_integrals())
    no = 7
    fock = np.asarray(hf.construct_hf_matrix(
        no, np.diag(u.kinetic_energies()), V))
    rng = np.random.default_rng(5)
    noise = rng.standard_normal(fock.shape) * 0.02
    fock = fock + noise + noise.T

    res_dense = ccsd_mod.CCSD(no).solve(fock, V, delta_e=1e-10,
                                        max_iter=200)
    dict_V = {k: v for k, v in part_2_body_int(no, V).items()
              if k not in ("abcd", "abci")}
    bpa = build_block_ladder(u, bra="all")
    for layout in ("abij", "ijab"):
        res_mf = ccsd_mod.CCSD(no).solve(fock, dict_V, delta_e=1e-10,
                                         max_iter=200, ladder=bpa,
                                         layout=layout)
        assert abs(res_mf["ccsd e"] - res_dense["ccsd e"]) < 1e-9


def test_no_momentum_violating_integrals_cutoff10():
    """Regression for the flat-lookup aliasing bug inherited from the
    reference (``ueg.py:234-243,397-407``: only the flattened index range
    is checked, so out-of-range k components wrap into neighbouring grid
    rows): at cutoff 10 the reference-compatible lookup yields 16
    momentum-VIOLATING nonzeros (e.g. V[40,121,118,118] with
    k_p+k_q=(-1,5,0) vs k_r+k_s=(0,-6,0)), which made the gather/dense
    paths disagree with the physically exact BlockLadder by ~1e-5 Ha at
    nP=219.  With per-component bounds in ``UEG._lookup_flat`` there are
    none, and gather == block == dense."""
    u = ueg.UEG(14, 7, 7, 0.5)
    u.init_single_basis(10)
    V = np.asarray(u.eval_2b_integrals())
    k = np.asarray(u.basis.k_int)
    Kpq = k[:, None, :] + k[None, :, :]
    nz = np.argwhere(np.abs(V) > 1e-300)
    p, q, r, s = nz.T
    viol = np.abs(Kpq[p, q] - Kpq[r, s]).max(axis=1) > 0
    assert int(viol.sum()) == 0

    from pymes_jax.ops.ueg_ladder import (build_block_ladder,
                                          block_ladder_apply)
    no = 7
    nv = u.n_spatial - no
    rng = np.random.default_rng(0)
    T = rng.standard_normal((nv, nv, no, no))
    R_dense = np.einsum("abcd,cdij->abij", V[no:, no:, no:, no:], T)
    gp = build_ueg_ladder(u)
    bp = build_block_ladder(u)
    assert np.abs(np.asarray(ueg_ladder_apply(gp, T)) - R_dense).max() < 1e-12
    assert np.abs(np.asarray(block_ladder_apply(bp, T)) - R_dense).max() < 1e-12


def test_block_ladder_non_hermitian_tc():
    """The non-hermitian TC classes matrix-free (VERDICT r2 task 6): the
    sector blocks carry the rs-dependent term −(kp_c−kp_d)·q·u(q²)/Ω, so
    the block ladder equals the dense abcd block for is_only_2b and
    is_only_non_hermi_2b — including with a twist shift."""
    from pymes_jax.ops.ueg_ladder import build_block_ladder, ladder_apply

    rng = np.random.default_rng(3)
    for flags, shift in (({"is_only_2b": True}, (0.0, 0.0, 0.0)),
                         ({"is_only_non_hermi_2b": True}, (0.0, 0.0, 0.0)),
                         ({"is_only_2b": True}, (0.1, 0.25, 0.5))):
        u = ueg.UEG(14, 7, 7, 1.0)
        u.init_single_basis(2, k_shift=shift)
        no = 7
        nv = u.n_spatial - no
        V = u.eval_2b_integrals(correlator=u.yukawa, **flags)
        abcd = V[no:, no:, no:, no:]
        # the class is genuinely non-hermitian, and its rs-dependent term
        # contributes inside abcd (the vvvv block itself turns out
        # transpose-symmetric — the asymmetry cancels structurally — but
        # the nh term still shifts its VALUES, which is what the sector
        # blocks must carry)
        assert np.abs(V - V.transpose(2, 3, 0, 1)).max() > 1e-8
        u_h = ueg.UEG(14, 7, 7, 1.0)
        u_h.init_single_basis(2, k_shift=shift)
        V_h = u_h.eval_2b_integrals(correlator=u_h.yukawa,
                                    is_only_hermi_2b=True)
        if flags.get("is_only_2b"):
            assert np.abs(abcd - V_h[no:, no:, no:, no:]).max() > 1e-2
        T = rng.standard_normal((nv, nv, no, no))
        bp = build_block_ladder(u, correlator=u.yukawa, preslice=None,
                                **flags)
        R_mf = np.asarray(ladder_apply(bp, T))
        R_dense = np.einsum("abcd,cdij->abij", abcd, T)
        assert np.abs(R_mf - R_dense).max() < 1e-12


def test_ueg_ccd_non_hermitian_matrix_free_matches_dense():
    """Full TC (yukawa, is_only_2b) CCD: matrix-free block-ladder solve
    equals the dense-abcd solve to 1e-10 (VERDICT r2 task 6 'done'
    criterion, at the cutoff-5 oracle size)."""
    import jax.numpy as jnp
    from pymes_jax.ops.ueg_ladder import build_block_ladder

    nel, rs, cutoff = 14, 1.0, 3
    no = nel // 2
    u = ueg.UEG(nel, no, no, rs)
    u.init_single_basis(cutoff)
    n_p = u.n_spatial
    V = u.eval_2b_integrals(correlator=u.yukawa, is_only_2b=True)
    kin = u.kinetic_energies()
    fock = np.asarray(hf.construct_hf_matrix(no, np.diag(kin), V))

    # the raw yukawa-TC Hamiltonian is unbound at this rs (both paths
    # diverge identically) — so pin a FIXED iteration budget and require
    # the matrix-free trajectory to track the dense one to 1e-10
    solver = ccd.CCD(no, is_diis=False)
    res_dense = solver.solve(jnp.asarray(fock), jnp.asarray(V),
                             level_shift=-3.0, max_iter=6, delta_e=1e-30)

    from pymes_jax.solver.ccd import blocks_from_full
    blk = blocks_from_full(no, jnp.asarray(V))
    blocks = blk._replace(abcd=None,
                          ladder=build_block_ladder(u, correlator=u.yukawa,
                                                    preslice=None,
                                                    is_only_2b=True))
    res_mf = ccd.CCD(no, is_diis=False).solve(
        jnp.asarray(fock), blocks, level_shift=-3.0, max_iter=6,
        delta_e=1e-30)
    assert np.isfinite(res_dense["ccd e"])
    # divergence amplifies the absolute scale, so compare relatively
    scale = max(1.0, abs(res_dense["ccd e"]))
    assert abs(res_mf["ccd e"] - res_dense["ccd e"]) < 1e-10 * scale
    t_dense = np.asarray(res_dense["t2 amp"])
    t_scale = max(1.0, np.abs(t_dense).max())
    assert np.abs(np.asarray(res_mf["t2 amp"])
                  - t_dense).max() < 1e-10 * t_scale


def test_ovvv_gather_j_leading_matches():
    """Occupied-leading ovvv gather must equal the trailing-j original."""
    from pymes_jax.ops.ueg_ladder import (build_ovvv_plans, ovvv_t1_apply,
                                          ovvv_t1_apply_j)
    u = ueg.UEG(14, 7, 7, 1.0)
    u.init_single_basis(2)
    plans = build_ovvv_plans(u)
    rng = np.random.default_rng(3)
    nv = u.n_spatial - 7
    T1 = rng.standard_normal((nv, 7))
    for pat, plan in plans.items():
        a = np.asarray(ovvv_t1_apply(plan, T1))
        b = np.asarray(ovvv_t1_apply_j(plan, T1))
        assert np.abs(np.moveaxis(b, 0, -1) - a).max() < 1e-14, pat
