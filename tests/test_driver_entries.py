"""Entry points must keep working: bench.py main() produces the JSON line
(its schema smoke mode, on the CPU), entry() compiles, dryrun_multichip(8)
executes."""

import io
import json
import sys

import jax
import numpy as np
import pytest


@pytest.mark.slow
def test_bench_main_emits_json(capsys, monkeypatch):
    import bench

    # schema smoke: one timed solve, no nP=219 secondary (the full
    # driver protocol costs ~25 min on CPU)
    monkeypatch.setattr(bench, "SMOKE", True)
    bench.main()
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 1
    rec = json.loads(out[0])
    assert {"metric", "value", "unit", "vs_baseline"} <= set(rec)
    assert set(rec) <= {"metric", "value", "unit", "vs_baseline",
                        "secondary", "method", "converged_ms_iter",
                        "converged_ms_iter_max", "setup_s", "warmup_s",
                        "warmup_cache_state", "program_hlo_ops", "device"}
    assert rec["device"]["count"] >= 1 and rec["device"]["kind"]
    assert rec["value"] > 0 and rec["vs_baseline"] > 0
    assert "secondary" not in rec           # smoke mode skips nP=219


def test_entry_compiles():
    import __graft_entry__ as g

    fn, args = g.entry()
    out = jax.jit(fn)(*args)
    jax.block_until_ready(out)
    assert np.isfinite(float(out[2]))


def test_dryrun_multichip():
    import __graft_entry__ as g

    g.dryrun_multichip(8)
