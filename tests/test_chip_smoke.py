"""``chip_smoke.py`` off the card: every phase at a small size on the CPU
(its oracle checks included), and the device gate that keeps ``main()``
from ever reporting success without a GPU."""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402


@pytest.fixture(scope="module")
def lih():
    return cs.phase_fcidump()


def test_phase_fcidump_lih(lih):
    assert lih["no"] == 2
    assert abs(lih["ccsd"]["ccsd e"] - cs.CCSD_LIH) < cs.TOL


def test_phase_excited_lih(lih):
    roots = cs.phase_excited(lih)
    np.testing.assert_allclose(roots, cs.EOM_LIH, atol=cs.EOM_TOL)


def test_phase_ueg_oracle_np57():
    out = cs.phase_ueg_oracle(cutoff=5, reps=1)
    assert abs(out["ccd"] - cs.CCD_UEG57) < cs.TOL
    assert abs(out["dcd"] - cs.DCD_UEG57) < cs.TOL
    assert set(out["ms_per_iter"]) == {"xla"}


def test_phase_full_width_small():
    out = cs.phase_full_width(cutoff=4, reps=1)
    assert set(out["ms_per_iter"]) == {"xla", "ozaki:7:6"}
    assert abs(out["ccsd"]["f32"] - out["ccsd"]["f64"]) < cs.TOL


def test_phase_sharded_virtual_devices():
    out = cs.phase_sharded(n_devices=4, cutoff=4)
    e_sh, e_one = out["ccd"]
    assert abs(e_sh - e_one) < cs.TOL


def test_check_raises_past_tolerance_and_on_nan(capsys):
    assert cs.check("x", 1.0 + 5e-9, 1.0, cs.TOL) < cs.TOL
    with pytest.raises(AssertionError):
        cs.check("x", 1.0 + 2e-8, 1.0, cs.TOL)
    with pytest.raises(AssertionError):
        cs.check("x", float("nan"), 1.0, cs.TOL)
    assert "|dev|" in capsys.readouterr().out


@pytest.mark.parametrize("argv", [[], ["--four-gpus"]])
def test_main_refuses_the_cpu(argv, capsys):
    with pytest.raises(SystemExit) as exc:
        cs.main(argv)
    assert exc.value.code not in (0, None)
    assert '"ok": true' not in capsys.readouterr().out


def test_script_alone_exits_nonzero(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    run = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert run.returncode != 0
    assert '"ok": true' not in run.stdout


@pytest.fixture
def nvidia_gpu():
    if shutil.which("nvidia-smi") is None:
        pytest.skip("needs an NVIDIA GPU")
    return {k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"}


@pytest.mark.gpu
def test_chip_smoke_on_the_gpu(nvidia_gpu):
    """The whole one-card smoke run, in its own process on the card."""
    run = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                         env=nvidia_gpu, capture_output=True, text=True,
                         timeout=1200)
    assert run.returncode == 0, run.stderr[-4000:]
    last = json.loads(run.stdout.strip().splitlines()[-1])
    assert last["ok"] is True and last["device"]["platform"] == "gpu"
