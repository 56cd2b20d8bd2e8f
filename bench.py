"""Benchmark: CCD amplitude-iteration wall-clock on one GPU.

Primary metric: per-iteration wall-clock of the UEG 14-electron, rs=0.5,
cutoff=5 CCD (nP=57, no=7, nv=50) in full float64, through the production
path (momentum-block ladder plan, occupied-leading loop layout, the whole
fixed point in one ``lax.while_loop``).  The nP=57 solve is
latency-bound — a converged solve takes a handful of iterations — so the
primary number is the min over 5 *fixed-61-iteration* solves
(``delta_e=-1`` runs the identical compiled while_loop program to the
iteration cap), which amortizes the dispatch; the converged-solve number
and its spread are reported alongside.

Secondary metric: a FULL matrix-free CCD iteration at nP=219 (ladder +
rings + Jacobi + DIIS + energy, native f64), timed as a fixed-iteration
``ccd_solve_jit``, with its effective f64 TFLOP/s.  No share of a device
peak is reported until a peak table keyed by ``device_kind`` exists.

``vs_baseline`` is the speedup over the reference implementation
(nickirk/pymes, pure numpy ``np.einsum`` CCD) on a CPU for the same
system: 2161 ms/iteration, measured once on the development host.

Every stage is timed (``setup_s``, ``warmup_s``, per-stage breakdown on
stderr), and the record names the device it ran on.  ``python bench.py``
refuses to run without a GPU.

Prints exactly one JSON line on stdout; diagnostics go to stderr.
"""

import json
import os
import sys
import time

import numpy as np

REF_CPU_MS_PER_ITER = 2161.0
ORACLE_E = -0.5120153512190824
# schema smoke mode for the CPU test suite: 1 timed solve each, no
# nP=219 secondary (the full driver protocol costs ~25 min on CPU)
SMOKE = os.environ.get("PYMES_BENCH_SMOKE", "0") == "1"


def log(*args):
    print(*args, file=sys.stderr, flush=True)


def main():
    import pymes_jax  # noqa: F401  (x64 on)
    import jax
    import jax.numpy as jnp

    from pymes_jax.log import set_verbosity
    from pymes_jax.mean_field import hf
    from pymes_jax.models import ueg
    from pymes_jax.solver import ccd, mp2

    set_verbosity(-1)
    devs = jax.devices()
    device = {"platform": devs[0].platform, "kind": devs[0].device_kind,
              "count": len(devs)}
    log("devices:", devs)

    t_setup0 = time.time()
    t0 = time.time()
    u = ueg.UEG(14, 7, 7, 0.5)
    u.init_single_basis(5)
    idx, vals = u.eval_2b_integrals(sp=2)
    n_p = u.n_spatial
    no = 7
    log(f"integrals: nP={n_p}, nnz={len(vals)} "
        f"({time.time() - t0:.1f}s host)")

    # ship the momentum-conservation-sparse integral list (~4 MB), build
    # the named o/v blocks on device and the momentum-block-diagonal
    # ladder plan on host — the production path holds NO nv^4 tensor
    t0 = time.time()
    from pymes_jax.ops.ueg_ladder import build_block_ladder
    NEED = ('klij', 'ijab', 'abij', 'iajb', 'iabj', 'aibj', 'aijb')
    d = ueg.sparse_to_blocks(idx, vals, n_p, no, names=NEED,
                             dtype=jnp.float64)
    kin = jnp.asarray(u.kinetic_energies())
    eps_i = hf.calcOccupiedOrbE(kin, d['klij'], no)
    eps_a = hf.calcVirtualOrbE(kin, d['aibj'], d['aijb'], no, n_p - no)
    fock = jnp.diag(jnp.concatenate([eps_i, eps_a]))
    jax.block_until_ready(fock)
    log(f"upload+blocks+fock: {time.time() - t0:.1f}s")
    t0 = time.time()
    lad = build_block_ladder(u)
    blocks = ccd.CCDBlocks(klij=d['klij'], ijab=d['ijab'], abij=d['abij'],
                           iajb=d['iajb'], iabj=d['iabj'], abcd=None,
                           ladder=lad)
    jax.block_until_ready(lad.groups[0].blocks)
    log(f"ladder plan: {time.time() - t0:.1f}s")

    t0 = time.time()
    _, T0 = mp2.solve(eps_i, eps_a, blocks.ijab, blocks.abij, -1.0)
    jax.block_until_ready(T0)
    log(f"mp2 start guess: {time.time() - t0:.1f}s")
    setup_s = time.time() - t_setup0

    # production path: matrix-free momentum-block ladder +
    # occupied-leading loop layout, native f64 contractions
    def solve(delta_e=1e-8):
        out = ccd.ccd_solve_jit(fock, blocks, no, T0, level_shift=-1.0,
                                delta_e=delta_e, max_iter=60,
                                contract_mode="xla", layout="ijab")
        return float(out[0]), int(out[5])

    # program-size metric: StableHLO op count of the
    # lowered primary program — compile wall-clock context.  Host-side
    # lowering, no device work.
    import re as _re
    t0 = time.time()
    lowered = jax.jit(
        lambda f, b, T: ccd.ccd_solve_jit(
            f, b, no, T, level_shift=-1.0, delta_e=1e-8, max_iter=60,
            contract_mode="xla", layout="ijab")).lower(fock, blocks, T0)
    hlo_ops = len(_re.findall(r"= \"?[\w.]+\"?[( ]", lowered.as_text()))
    log(f"primary program: {hlo_ops} stablehlo ops "
        f"({time.time() - t0:.1f}s lowering)")

    # compile-cache state: count new persistent-cache entries to tell a
    # cold compile from a warm-cache cold-process start so the recorded
    # warmup_s is interpretable under either state.
    cache_dir = jax.config.jax_compilation_cache_dir
    def _cache_n():
        try:
            return len(os.listdir(cache_dir))
        except OSError:
            return 0
    n_cache0 = _cache_n()
    t0 = time.time()
    e, n_it = solve()
    warmup_s = time.time() - t0
    cache_misses = _cache_n() - n_cache0
    log(f"warmup solve: e={e:.10f} iters={n_it} "
        f"wall={warmup_s:.1f}s (includes compile; "
        f"{cache_misses} new persistent-cache entries -> "
        f"{'COLD compile' if cache_misses else 'warm-cache start'})")
    log(f"energy vs oracle: {abs(e - ORACLE_E):.2e} (oracle {ORACLE_E})")
    if not abs(e - ORACLE_E) <= 1e-6:
        raise RuntimeError(f"converged energy {e!r} is off the oracle")

    # converged-solve timing (rounds 1-3 methodology, for continuity):
    # noisy at this size — report min and spread over 5
    conv_walls = []
    for _ in range(1 if SMOKE else 5):
        t0 = time.time()
        e, n_it = solve()
        conv_walls.append(time.time() - t0)
    conv_ms = [w / max(n_it, 1) * 1e3 for w in conv_walls]
    log(f"converged solves ({n_it} iters): "
        f"{['%.1f' % m for m in conv_ms]} ms/iter")

    # primary: steady-state per-iteration from fixed-61-iteration solves
    # (delta_e=-1 -> |dE| > -1 always, the while_loop runs to the cap;
    # SAME compiled program, delta_e is a traced scalar; delta_e=0 exits
    # early once dE hits exactly 0.0 in f64), min over 5
    fixed_walls = []
    for _ in range(1 if SMOKE else 5):
        t0 = time.time()
        e_f, n_fixed = solve(delta_e=-1.0)
        fixed_walls.append(time.time() - t0)
    per_iter_ms = min(fixed_walls) / max(n_fixed, 1) * 1e3
    log(f"fixed-{n_fixed}-iteration solves: "
        f"{['%.0f' % (w * 1e3) for w in fixed_walls]} ms wall "
        f"-> min {per_iter_ms:.2f} ms/iter")

    # --- secondary, FLOP-bound metric: the nP=57 primary is
    # latency-bound, so the full mf-CCD iteration is also tracked at
    # cutoff 14 (nP=219, ~95 GFLOP/residual)
    secondary = None
    if not SMOKE:
        from pymes_jax.util import roofline

        t0 = time.time()
        u2 = ueg.UEG(14, 7, 7, 0.5)
        u2.init_single_basis(14)
        idx2, vals2 = u2.eval_2b_integrals(sp=2)
        n_p2 = u2.n_spatial
        nv2 = n_p2 - no
        d2 = ueg.sparse_to_blocks(idx2, vals2, n_p2, no, names=NEED,
                                  dtype=jnp.float64)
        kin2 = jnp.asarray(u2.kinetic_energies())
        eps_i2 = hf.calcOccupiedOrbE(kin2, d2['klij'], no)
        eps_a2 = hf.calcVirtualOrbE(kin2, d2['aibj'], d2['aijb'], no, nv2)
        fock2 = jnp.diag(jnp.concatenate([eps_i2, eps_a2]))
        lad2 = build_block_ladder(u2)
        blocks2 = ccd.CCDBlocks(
            klij=d2['klij'], ijab=d2['ijab'], abij=d2['abij'],
            iajb=d2['iajb'], iabj=d2['iabj'], abcd=None, ladder=lad2)
        _, T2g = mp2.solve(eps_i2, eps_a2, d2['ijab'], d2['abij'], -1.0)
        jax.block_until_ready(T2g)
        sec_setup_s = time.time() - t0
        log(f"secondary setup: nP={n_p2} ({sec_setup_s:.1f}s)")

        N_IT2 = 15

        def solve2(delta_e):
            out = ccd.ccd_solve_jit(fock2, blocks2, no, T2g,
                                    level_shift=-1.0, delta_e=delta_e,
                                    max_iter=N_IT2, contract_mode="xla",
                                    layout="ijab")
            return float(out[0]), int(out[5])

        t0 = time.time()
        e2, _ = solve2(1e-8)
        sec_compile_s = time.time() - t0
        log(f"secondary compile+first solve: {sec_compile_s:.1f}s "
            f"(e={e2:.10f})")
        walls2 = []
        n2 = 0
        for _ in range(3):
            t0 = time.time()
            _, n2 = solve2(-1.0)
            walls2.append(time.time() - t0)
        iter_ms = min(walls2) / max(n2, 1) * 1e3
        eff_lad = roofline.block_ladder_flops(lad2, no * no)
        terms = roofline.ccd_iteration_flops(no, nv2, ladder_flops=eff_lad)
        eff_tflops = terms["TOTAL"] / (iter_ms / 1e3) / 1e12
        log(f"secondary mf-CCD FULL iteration nP={n_p2}: {iter_ms:.2f} ms, "
            f"{eff_tflops:.2f} eff-f64 TFLOP/s")
        secondary = {
            "metric": "ueg14_rs0.5_c14_ccd_full_iter_wall",
            "value": iter_ms,
            "unit": "ms/iteration",
            "method": f"min of 3 fixed-{n2}-iteration solves, full "
                      "iteration (ladder+rings+Jacobi+DIIS+energy)",
            "eff_f64_tflops": eff_tflops,
            "setup_s": round(sec_setup_s, 1),
            "compile_s": round(sec_compile_s, 1),
        }

    out = {
        "metric": "ueg14_rs0.5_c5_ccd_f64_iter_wall",
        "value": per_iter_ms,
        "unit": "ms/iteration",
        "vs_baseline": REF_CPU_MS_PER_ITER / per_iter_ms,
        "method": f"min of 5 fixed-{n_fixed}-iteration solves",
        "converged_ms_iter": min(conv_ms),
        "converged_ms_iter_max": max(conv_ms),
        "setup_s": round(setup_s, 1),
        "warmup_s": round(warmup_s, 1),
        "warmup_cache_state": ("cold" if cache_misses else "warm"),
        "program_hlo_ops": hlo_ops,
        "device": device,
    }
    if secondary is not None:
        out["secondary"] = secondary
    print(json.dumps(out))


if __name__ == "__main__":
    import jax

    if jax.devices()[0].platform != "gpu":
        sys.exit(f"bench.py: needs a GPU, JAX found "
                 f"{jax.devices()[0].platform!r}")
    main()
