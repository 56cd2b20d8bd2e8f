"""Run the main path once on one GPU and check every phase against the oracles.

    python chip_smoke.py              # one GPU: phases 0-4
    python chip_smoke.py --four-gpus  # the multi-device path only, four GPUs

Phases (one process; a JAX process reserves most of the card):

0. the device: refuses anything but a GPU;
1. FCIDUMP LiH/3-21G: HF, CCSD and CCD against ``BASELINE.md``;
2. excited states: EOM-CCSD Davidson roots, and a FEAST window whose root
   must match the Davidson root (f32 Krylov + f64 refinement);
3. UEG 14e, rs=0.5, cutoff 5 (nP=57): CCD and DCD oracles, and the
   mixed-precision solve against the f64 solve;
4. UEG at cutoff 14 (nP=219, nv=212): matrix-free BlockLadder CCD in the
   ``xla`` and ``ozaki:7:6`` contraction modes, matrix-free CCSD with f64
   against f32 T1 dressing, and fixed-iteration timings in ms/iter.

Each phase prints its results with their deviations; a failed check raises,
so the script exits non-zero.  The last line of stdout is one JSON object
naming the device.  The phase functions take their sizes as arguments so
the CPU tests can run them small; only :func:`main` insists on a GPU.
"""

import argparse
import json
import os
import subprocess
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
LIH = os.path.join(HERE, "tests", "data", "FCIDUMP.LiH.321g")
H2 = os.path.join(HERE, "tests", "data", "FCIDUMP.H2.sto6g")

TOL = 1e-8                       # the repo's correctness bar (Ha)
HF_LIH = -7.92958534362757       # BASELINE.md
CCSD_LIH = -0.01908832712812761
CCD_LIH = -0.01830250126018896
# The reference stops CCD at |dE| < 1e-8 and lands 1.2e-8 above the fixed
# point; this is the fixed point, converged to |dE| < 1e-10 in f64 on a CPU.
CCD_LIH_CONVERGED = -0.018302513380863087
EOM_LIH = (0.1180867117168979, 0.154376205595602)
EOM_TOL = 1e-7                   # tests/test_eom_ccsd.py
CCD_UEG57 = -0.5120153512190824
DCD_UEG57 = -0.515296499349519
UEG_NEED = ('klij', 'ijab', 'abij', 'iajb', 'iabj', 'aibj', 'aijb')
CCSD_NEED = UEG_NEED + ('ijka', 'ijak', 'iajk')


def check(label, value, ref, tol):
    """Print ``value`` beside its reference; raise if |value-ref| > tol."""
    dev = abs(value - ref)
    print(f"{label}: {value:.14f}  reference {ref:.14f}  |dev| {dev:.2e}"
          f"  (tol {tol:.0e})", flush=True)
    if not dev <= tol:           # also refuses NaN
        raise AssertionError(f"{label}: |dev| {dev:.3e} exceeds {tol:.0e}")
    return dev


def say(*args):
    print(*args, flush=True)


# --- phase 0 ---------------------------------------------------------------

def gpu_name_and_power():
    """``nvidia-smi``'s name and power limit of the cards."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def phase_device(n_devices=1):
    import jax

    devs = jax.devices()
    d0 = devs[0]
    if d0.platform != "gpu":
        raise SystemExit(f"chip_smoke: needs a GPU, JAX found "
                         f"{d0.platform!r} ({d0.device_kind})")
    if len(devs) < n_devices:
        raise SystemExit(f"chip_smoke: needs {n_devices} GPUs, JAX found "
                         f"{len(devs)}")
    import pymes_jax  # noqa: F401  (x64 on, compile cache set)

    say(f"device: {d0.device_kind}, count {len(devs)}, jax "
        f"{jax.__version__}, compile cache "
        f"{jax.config.jax_compilation_cache_dir}")
    say("nvidia-smi name, power limit:")
    say(gpu_name_and_power())
    return {"platform": d0.platform, "kind": d0.device_kind,
            "count": len(devs)}


# --- phase 1 ---------------------------------------------------------------

def phase_fcidump(path=LIH):
    """FCIDUMP -> HF -> CCSD and CCD on LiH/3-21G."""
    from pymes_jax.mean_field import hf
    from pymes_jax.solver import ccd, ccsd
    from pymes_jax.util import fcidump

    n_elec, nb, e_core, e_orb, h, V = fcidump.read(path)
    no = n_elec // 2
    check("phase 1 LiH HF energy", float(hf.calc_hf_e(no, e_core, h, V)),
          HF_LIH, TOL)
    fock = hf.construct_hf_matrix(no, h, V)
    cc = ccsd.CCSD(no)
    res = cc.solve(fock, V, delta_e=1e-12, max_iter=200)
    check("phase 1 LiH CCSD", res["ccsd e"], CCSD_LIH, TOL)
    e_ccd = ccd.CCD(no).solve(fock, V, delta_e=1e-12, max_iter=200)["ccd e"]
    check("phase 1 LiH CCD", e_ccd, CCD_LIH_CONVERGED, TOL)
    check("phase 1 LiH CCD vs the reference's early stop", e_ccd, CCD_LIH,
          2 * TOL)
    return {"no": no, "fock": fock, "V": V, "cc": cc, "ccsd": res}


# --- phase 2 ---------------------------------------------------------------

def phase_excited(lih):
    """EOM-CCSD Davidson roots, then a FEAST window around the first."""
    from pymes_jax.integral.partition import part_2_body_int
    from pymes_jax.solver import eom_ccsd
    from pymes_jax.solver.ccsd import EOM_DRESSED
    from pymes_jax.solver.feast_eom_ccsd import FEAST_EOM_CCSD

    no, fock, cc, res = lih["no"], lih["fock"], lih["cc"], lih["ccsd"]
    dict_V = part_2_body_int(no, lih["V"])
    fd = cc.get_T1_dressed_fock(fock, res["t1"], dict_V)
    Vd = cc.get_T1_dressed_V(res["t1"], dict_V,
                             {k: None for k in EOM_DRESSED})
    dav = eom_ccsd.EOM_CCSD(no, n_excit=2)
    dav.max_iter = 1000
    roots = np.sort(np.real(dav.solve(fd, Vd, res["t2"])))
    for k, (e, ref) in enumerate(zip(roots, EOM_LIH)):
        check(f"phase 2 LiH EOM-CCSD root {k}", float(e), ref, EOM_TOL)

    feast = FEAST_EOM_CCSD(no, e_c=0.12, e_r=0.025, n_trial=2, max_iter=60,
                           tol=1e-11, seed=7)
    feast.ls_max_iter = 60
    ev = np.real(feast.solve(fd, cc.get_T1_dressed_V(res["t1"], dict_V),
                             res["t2"]))
    e_feast = float(ev[np.argmin(np.abs(ev - roots[0]))])
    check("phase 2 LiH FEAST root vs Davidson", e_feast, float(roots[0]),
          TOL)
    return roots


# --- phases 3 and 4: the UEG -------------------------------------------------

def ueg_system(cutoff, names=UEG_NEED, fock_noise=0.0, seed=0):
    """UEG 14e, rs=0.5: named o/v blocks built on the device from the
    momentum-conserving integral list, and the HF fock.  ``fock_noise``
    adds a seeded symmetric perturbation, which makes T1 nonzero (at a
    canonical fock momentum conservation keeps T1 = 0)."""
    import jax.numpy as jnp

    from pymes_jax.mean_field import hf
    from pymes_jax.models import ueg

    u = ueg.UEG(14, 7, 7, 0.5)
    u.init_single_basis(cutoff)
    idx, vals = u.eval_2b_integrals(sp=2)
    n_p, no = u.n_spatial, 7
    d = ueg.sparse_to_blocks(idx, vals, n_p, no, names=names,
                             dtype=jnp.float64)
    kin = jnp.asarray(u.kinetic_energies())
    eps_i = hf.calcOccupiedOrbE(kin, d['klij'], no)
    eps_a = hf.calcVirtualOrbE(kin, d['aibj'], d['aijb'], no, n_p - no)
    fock = jnp.diag(jnp.concatenate([eps_i, eps_a]))
    if fock_noise:
        noise = np.random.default_rng(seed).standard_normal(fock.shape)
        fock = fock + fock_noise * jnp.asarray(noise + noise.T)
    return u, no, d, fock


def ccd_blocks(d, ladder):
    from pymes_jax.solver import ccd

    return ccd.CCDBlocks(klij=d['klij'], ijab=d['ijab'], abij=d['abij'],
                         iajb=d['iajb'], iabj=d['iabj'], abcd=None,
                         ladder=ladder)


def compile_ccd(fock, blocks, no, T0, mode="xla", max_iter=60):
    """AOT-compile the on-device CCD fixed point (``ccd.ccd_solve_jit``);
    ``delta_e`` stays a runtime argument, so one program serves converged
    solves and fixed-iteration timings (``delta_e=-1`` runs to the cap).
    Returns (call(delta_e) -> (e, n_iter), compiled, compile seconds)."""
    import jax

    from pymes_jax.solver import ccd

    t0 = time.perf_counter()
    compiled = ccd.ccd_solve_jit.lower(
        fock, blocks, no=no, t_T0_abij=T0, level_shift=-1.0, delta_e=1e-10,
        max_iter=max_iter, contract_mode=mode,
        layout="ijab").compile()
    compile_s = time.perf_counter() - t0

    def call(delta_e):
        out = compiled(fock, blocks, t_T0_abij=T0, level_shift=-1.0,
                       delta_e=delta_e)
        jax.block_until_ready(out)
        return float(out[0]), int(out[5])

    return call, compiled, compile_s


def time_per_iter(variants, reps):
    """Fixed-iteration solves of each compiled variant, in turns; returns
    {name: (min, max) ms/iter}."""
    walls = {name: [] for name in variants}
    iters = {}
    for name, call in variants.items():
        call(-1.0)               # warm: first call pays the transfer
    for _ in range(reps):
        for name, call in variants.items():
            t0 = time.perf_counter()
            _, iters[name] = call(-1.0)
            walls[name].append(time.perf_counter() - t0)
    return {name: (min(w) / iters[name] * 1e3, max(w) / iters[name] * 1e3)
            for name, w in walls.items()}


def compile_variants(fock, blocks, no, T0, modes, max_iter):
    """The CCD program compiled once per contraction mode."""
    out = {}
    for mode in modes:
        out[mode] = compile_ccd(fock, blocks, no, T0, mode, max_iter)
        say(f"  compiled {mode}: {out[mode][2]:.1f} s")
    return out


def phase_ueg_oracle(cutoff=5, reps=3):
    """CCD and DCD oracles at nP=57, mixed precision against f64."""
    from pymes_jax.ops.ueg_ladder import build_block_ladder
    from pymes_jax.solver import ccd, mp2

    u, no, d, fock = ueg_system(cutoff)
    say(f"phase 3 UEG nP={u.n_spatial}")
    blocks = ccd_blocks(d, build_block_ladder(u))
    eps = np.diagonal(np.asarray(fock))
    _, T0 = mp2.solve(eps[:no], eps[no:], d['ijab'], d['abij'], -1.0)
    progs = compile_variants(fock, blocks, no, T0, ("xla",), 60)
    e_ccd, n_it = progs["xla"][0](1e-10)
    say(f"phase 3 CCD converged in {n_it} iterations")
    check("phase 3 UEG CCD (ccd_solve_jit)", e_ccd, CCD_UEG57, TOL)
    e_dcd = ccd.CCD(no, is_dcd=True).solve(
        fock, blocks, level_shift=-1.0, max_iter=60, delta_e=1e-10)["ccd e"]
    check("phase 3 UEG DCD", e_dcd, DCD_UEG57, TOL)
    solver = ccd.CCD(no)
    f64 = solver.solve(fock, blocks, level_shift=-1.0, max_iter=60,
                       delta_e=1e-10)
    mixed = solver.solve(fock, blocks, level_shift=-1.0, max_iter=60,
                         delta_e=1e-10, mixed_precision=True)
    say(f"phase 3 mixed precision: {mixed['f32 iterations']} f32 "
        f"iterations, then {len(mixed['e history'])} f64")
    check("phase 3 UEG CCD mixed vs f64", mixed["ccd e"], f64["ccd e"], TOL)
    ms = time_per_iter({k: v[0] for k, v in progs.items()}, reps)
    for name, (lo, hi) in ms.items():
        say(f"phase 3 nP={u.n_spatial} CCD {name}: {lo:.3f} ms/iter "
            f"(min of {reps}; max {hi:.3f})")
    return {"ccd": e_ccd, "dcd": e_dcd, "ms_per_iter": ms}


def phase_full_width(cutoff=14, reps=3, max_iter=60):
    """Matrix-free CCD and CCSD at nP=219: no nv^4 tensor is held."""
    import jax.numpy as jnp

    from pymes_jax.ops.ueg_ladder import build_block_ladder, build_ovvv_plans
    from pymes_jax.solver import ccsd, mp2

    t0 = time.perf_counter()
    u, no, d, fock = ueg_system(cutoff)
    lad = build_block_ladder(u)
    blocks = ccd_blocks(d, lad)
    eps = np.diagonal(np.asarray(fock))
    _, T0 = mp2.solve(eps[:no], eps[no:], d['ijab'], d['abij'], -1.0)
    n_p = u.n_spatial
    say(f"phase 4 UEG nP={n_p}, nv={n_p - no}: setup "
        f"{time.perf_counter() - t0:.1f} s")

    progs = compile_variants(fock, blocks, no, T0, ("xla", "ozaki:7:6"),
                             max_iter)
    say(f"phase 4 xla program memory: {progs['xla'][1].memory_analysis()}")
    e = {}
    for name in ("xla", "ozaki:7:6"):
        e[name], n_it = progs[name][0](1e-10)
        say(f"phase 4 CCD {name}: {e[name]:.14f} ({n_it} iterations)")
    check("phase 4 CCD ozaki:7:6 vs xla", e["ozaki:7:6"], e["xla"], TOL)
    ms = time_per_iter({k: v[0] for k, v in progs.items()}, reps)
    for name, (lo, hi) in ms.items():
        say(f"phase 4 nP={n_p} CCD {name}: {lo:.3f} ms/iter "
            f"(min of {reps}; max {hi:.3f})")

    # T1-dressed matrix-free CCSD: all-bra ladder + OVVV gather plans
    t0 = time.perf_counter()
    _, _, dmf, fock_nc = ueg_system(cutoff, names=CCSD_NEED,
                                    fock_noise=0.02, seed=5)
    dmf['_ovvv_plans'] = build_ovvv_plans(u)
    lad_all = build_block_ladder(u, bra="all")
    say(f"phase 4 CCSD setup {time.perf_counter() - t0:.1f} s")
    e_cc = {}
    for prec in ("f64", "f32"):
        t0 = time.perf_counter()
        res = ccsd.CCSD(no).solve(fock_nc, dmf, delta_e=1e-10,
                                  max_iter=100, level_shift=-0.5,
                                  ladder=lad_all, contract_mode="xla",
                                  dress_precision=prec)
        e_cc[prec] = res["ccsd e"]
        t1max = float(jnp.abs(res["t1"]).max())
        say(f"phase 4 mf-CCSD dress {prec}: {e_cc[prec]:.14f} "
            f"({len(res['e history'])} iterations, max|T1| {t1max:.2e}, "
            f"{time.perf_counter() - t0:.1f} s with compile)")
    check("phase 4 mf-CCSD dress f32 vs f64", e_cc["f32"], e_cc["f64"], TOL)
    return {"ccd": e, "ccsd": e_cc, "ms_per_iter": ms}


# --- --four-gpus -------------------------------------------------------------

def phase_sharded(n_devices=4, cutoff=14, fcidump_path=H2):
    """The multi-device path against the same solve on device 0 alone."""
    import jax
    from jax.sharding import Mesh

    from pymes_jax.ops.ueg_ladder import build_block_ladder, shard_block_ladder
    from pymes_jax.solver import ccd
    from pymes_jax.parallel import mesh as pmesh

    devs = jax.devices()[:n_devices]
    u, no, d, fock = ueg_system(cutoff)
    say(f"sharded: UEG nP={u.n_spatial} over {n_devices} devices")
    solver = ccd.CCD(no)
    kw = dict(level_shift=-1.0, max_iter=60, delta_e=1e-10)
    t0 = time.perf_counter()
    ref = solver.solve(fock, ccd_blocks(d, build_block_ladder(
        u, preslice=None)), **kw)["ccd e"]
    say(f"  device 0 alone: {time.perf_counter() - t0:.1f} s")
    mesh = Mesh(np.array(devs), ("s",))
    plan = shard_block_ladder(build_block_ladder(u, pad_sectors=n_devices,
                                                 preslice=None),
                              mesh, axis="s")
    t0 = time.perf_counter()
    e_sh = solver.solve(fock, ccd_blocks(d, plan), **kw)["ccd e"]
    say(f"  sector-sharded: {time.perf_counter() - t0:.1f} s")
    check(f"sector-sharded mf-CCD over {n_devices} devices vs one", e_sh,
          ref, TOL)

    # FEAST on H2/STO-6G, its contour nodes sharded over the devices
    from pymes_jax.integral.partition import part_2_body_int
    from pymes_jax.mean_field import hf
    from pymes_jax.solver import ccsd, eom_ccsd
    from pymes_jax.solver.feast_eom_ccsd import FEAST_EOM_CCSD
    from pymes_jax.util import fcidump

    n_elec, nb, e_core, e_orb, h, V = fcidump.read(fcidump_path)
    no = n_elec // 2
    fock = hf.construct_hf_matrix(no, h, V)
    cc = ccsd.CCSD(no)
    res = cc.solve(fock, V, delta_e=1e-12, max_iter=100)
    dict_V = part_2_body_int(no, V)
    fd = cc.get_T1_dressed_fock(fock, res["t1"], dict_V)
    Vd = cc.get_T1_dressed_V(res["t1"], dict_V)
    e_dav = float(np.real(eom_ccsd.EOM_CCSD(no, n_excit=1).solve(
        fd, Vd, res["t2"])[0]))
    ev = {}
    for label, node_mesh in (("one", None),
                             ("sharded", pmesh.make_mesh(
                                 n_devices, axis_names=("a",)))):
        feast = FEAST_EOM_CCSD(no, e_c=e_dav, e_r=0.2, n_trial=2,
                               max_iter=50, tol=1e-10, seed=1,
                               node_mesh=node_mesh)
        feast.ls_max_iter = 50
        feast.ls_precision = "f64"   # the node-sharded path's precision
        t0 = time.perf_counter()
        out = np.real(feast.solve(fd, Vd, res["t2"]))
        ev[label] = float(out[np.argmin(np.abs(out - e_dav))])
        say(f"  FEAST {label}: {ev[label]:.14f} "
            f"({time.perf_counter() - t0:.1f} s)")
    check(f"node-sharded FEAST over {n_devices} devices vs one",
          ev["sharded"], ev["one"], TOL)
    return {"ccd": (e_sh, ref), "feast": ev}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-gpus", action="store_true",
                    help="run only the multi-device path, on four GPUs")
    args = ap.parse_args(argv)
    device = phase_device(4 if args.four_gpus else 1)
    t_start = time.perf_counter()

    def run(name, fn, *a):
        t0 = time.perf_counter()
        out = fn(*a)
        say(f"{name} done in {time.perf_counter() - t0:.1f} s")
        return out

    if args.four_gpus:
        run("sharded phase", phase_sharded, 4)
    else:
        lih = run("phase 1", phase_fcidump)
        run("phase 2", phase_excited, lih)
        run("phase 3", phase_ueg_oracle)
        run("phase 4", phase_full_width)
    say(f"all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"ok": True, "device": device}), flush=True)


if __name__ == "__main__":
    main()
