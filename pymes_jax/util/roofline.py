"""FLOP accounting for the hot CC contractions.

BASELINE.md's north star is "per-iteration wall-clock at the matmul
roofline of the vvvv contraction" (the reference's FLOP hot spot,
``pymes/solver/ccd.py:187``).  This module turns measured per-iteration
times into achieved TFLOP/s so the claim is quantified rather than
asserted (VERDICT r2 task 7).  Device peaks are not kept here: a share of
peak needs the device's own table, keyed by its ``device_kind``.

Two FLOP currencies:

* **f64-effective** — the FLOPs of the mathematical contraction
  (2·Πdims per einsum), what a dgemm would execute.  For the
  momentum-block ladder the count uses the plan's ACTUAL padded sector
  GEMMs, not the dense nv⁴ equivalent.
* **raw sliced** — the bf16 multiply-adds the Ozaki sliced path really
  issues: the stacked fast path reconstructs all ``n_slices²`` slice
  pairs, so raw = S² × effective for sliced contractions.
"""


def block_ladder_gemm_dims(plan):
    """(nS, mB, mK) of every bucketed sector-GEMM batch in the plan."""
    return [(int(g.blocks.shape[0]), int(g.blocks.shape[1]),
             int(g.blocks.shape[2])) for g in plan.groups]


def block_ladder_flops(plan, no2):
    """f64-effective FLOPs of one block-ladder apply on (…, no2)
    amplitudes: the padded sector GEMMs actually dispatched,
    ``Σ_buckets 2·nS·mB·mK·no2``."""
    return sum(2 * nS * mB * mK * no2
               for nS, mB, mK in block_ladder_gemm_dims(plan))


def block_ladder_mxu_flops(plan, no2, n_slices):
    """Raw bf16 FLOPs of the sliced (Ozaki) block-ladder apply.

    The stationary-operand fast path (``ozaki.matmul_presliced``)
    reconstructs all ``n_slices²`` slice pairs with each big-operand slice
    entering one GEMM of n_slices× the small free dimension — raw work is
    exactly ``n_slices² ×`` the effective count."""
    return n_slices ** 2 * block_ladder_flops(plan, no2)


def dense_ladder_flops(no, nv):
    """f64-effective FLOPs of the dense vvvv ladder (the reference's hot
    spot): 2·nv⁴·no²."""
    return 2 * nv ** 4 * no ** 2


def ccd_iteration_flops(no, nv, ladder_flops=None, is_dcd=False):
    """f64-effective FLOPs of one CCD/DCD doubles-residual evaluation
    (:func:`pymes_jax.solver.ccd.doubles_residual_ij`), term by term.

    ``ladder_flops``: actual pp-ladder count (e.g.
    :func:`block_ladder_flops`); defaults to the dense 2·nv⁴·no².
    Returns a dict of term → FLOPs plus ``"TOTAL"``.
    """
    t = {}
    if ladder_flops is None:
        ladder_flops = dense_ladder_flops(no, nv)
    t["pp ladder (vvvv)"] = ladder_flops
    t["hh ladder apply (klij,klab)"] = 2 * no ** 4 * nv ** 2
    # one-particle dressed intermediates + their applications
    t["X_ac build+apply"] = 2 * nv ** 3 * no ** 2 * 2
    t["X_ki build+apply"] = 2 * no ** 3 * nv ** 2 * 2
    # ring / crossed-ring class: O(no³nv³) terms
    n_ring = 3  # kaic, kbic, acik·kbcj
    if not is_dcd:
        t["hh I_klij build (klcd,ijcd)"] = 2 * no ** 4 * nv ** 2
        n_ring += 7  # X_alcj(+apply), X_cbkj(+apply), X_alci(+2 applies)
    else:
        n_ring += 2  # X_cbkj + its apply survive in DCD
    t[f"ring-class terms ({n_ring}x no3nv3)"] = n_ring * 2 * no**3 * nv**3
    t["TOTAL"] = sum(t.values())
    return t


def report(tag, seconds, eff_flops, raw_flops=None):
    """One formatted roofline line: achieved effective TFLOP/s (+ the raw
    slice-redundant bf16 TFLOP/s when the raw count is given)."""
    eff = eff_flops / seconds / 1e12
    line = f"{tag}: {seconds*1e3:.1f} ms, {eff:.2f} eff-f64 TFLOP/s"
    if raw_flops:
        raw = raw_flops / seconds / 1e12
        line += f", {raw:.1f} raw slice-redundant bf16 TFLOP/s"
    return line
