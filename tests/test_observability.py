"""Run-record observability round trip with a real solve."""

import os

import numpy as np

from pymes_jax.mean_field import hf
from pymes_jax.solver import ccd
from pymes_jax.util import fcidump
from pymes_jax.util.observability import RunRecord

DATA = os.path.join(os.path.dirname(__file__), "data")


def test_run_record(tmp_path):
    n_elec, nb, e_core, e_orb, h_pq, V_pqrs = fcidump.read(
        os.path.join(DATA, "FCIDUMP.LiH.321g"))
    no = n_elec // 2
    fock = hf.construct_hf_matrix(no, h_pq, V_pqrs)
    res = ccd.CCD(no).solve(fock, V_pqrs)

    rec = RunRecord(str(tmp_path / "runs.jsonl"))
    rec.log("ccd", system="LiH/3-21G", result=res, wall_s=1.23)
    rows = rec.read()
    assert len(rows) == 1
    assert rows[0]["solver"] == "ccd"
    assert abs(rows[0]["ccd e"] - res["ccd e"]) < 1e-14
    assert rows[0]["iterations"] == len(res["e history"])
    # monotone-ish convergence recorded
    hist = np.asarray(rows[0]["e_history"])
    assert abs(hist[-1] - res["ccd e"]) < 1e-12
