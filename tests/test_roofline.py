"""FLOP accounting (`pymes_jax.util.roofline`): the block-ladder counts
must equal the plan's actual padded sector GEMMs, and the CCD term model
must be internally consistent."""

import numpy as np

from pymes_jax.models import ueg
from pymes_jax.ops.ueg_ladder import build_block_ladder
from pymes_jax.util import roofline


def test_block_ladder_flop_counts():
    u = ueg.UEG(14, 7, 7, 1.0)
    u.init_single_basis(2)
    lad = build_block_ladder(u, preslice=None)
    dims = roofline.block_ladder_gemm_dims(lad)
    # hand-count from the group arrays
    expect = sum(2 * g.blocks.shape[0] * g.blocks.shape[1]
                 * g.blocks.shape[2] * 49 for g in lad.groups)
    assert roofline.block_ladder_flops(lad, 49) == expect
    assert roofline.block_ladder_mxu_flops(lad, 49, 7) == 49 * expect
    # padded sectors can only add work vs the exact momentum-conserving
    # count, and the block structure must beat dense nv^4 by a wide margin
    nv = u.n_spatial - 7
    assert roofline.block_ladder_flops(lad, 49) < \
        roofline.dense_ladder_flops(7, nv)
    assert all(mB >= 8 and mK >= 8 for _, mB, mK in dims)


def test_ccd_iteration_flop_model():
    no, nv = 7, 50
    t = roofline.ccd_iteration_flops(no, nv)
    assert t["TOTAL"] == sum(v for k, v in t.items() if k != "TOTAL")
    # ladder override is respected
    t2 = roofline.ccd_iteration_flops(no, nv, ladder_flops=123)
    assert t2["pp ladder (vvvv)"] == 123
    # DCD drops the quadratic terms -> strictly fewer FLOPs
    assert roofline.ccd_iteration_flops(no, nv, is_dcd=True)["TOTAL"] \
        < t["TOTAL"]
    # report() formats without raw
    line = roofline.report("x", 0.05, t["TOTAL"])
    assert "eff-f64 TFLOP/s" in line
    line2 = roofline.report("x", 0.05, t["TOTAL"], 49 * t["TOTAL"])
    assert "raw slice-redundant bf16 TFLOP/s" in line2
    assert "%" not in line2          # no device peak without its table
