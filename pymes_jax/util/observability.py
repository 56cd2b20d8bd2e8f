"""Profiling and run-record observability.

The reference's only telemetry is wall-clock prints through the logger
(SURVEY §5.1).  Here:

* :func:`profile` — context manager around the JAX/XLA profiler
  (TensorBoard trace of device kernels, host callbacks, transfers);
* :class:`RunRecord` — structured per-solve metrics appended as JSON lines
  (system, solver settings, energies, iteration history, wall times);
  solvers expose their per-iteration energy history (``"e history"`` in
  result dicts) which slots in directly.
"""

import contextlib
import json
import os
import time

import numpy as np


@contextlib.contextmanager
def profile(log_dir="/tmp/pymes_jax_profile"):
    """Capture an XLA profiler trace for the enclosed block."""
    import jax

    os.makedirs(log_dir, exist_ok=True)
    jax.profiler.start_trace(log_dir)
    try:
        yield log_dir
    finally:
        jax.profiler.stop_trace()


class RunRecord:
    """Append structured solve records to a JSONL file."""

    def __init__(self, path):
        self.path = path
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)

    def log(self, solver, system=None, result=None, wall_s=None, **extra):
        rec = {"time": time.time(), "solver": solver}
        if system:
            rec["system"] = system
        if wall_s is not None:
            rec["wall_s"] = wall_s
        if result is not None:
            for key in ("ccd e", "ccsd e", "dE"):
                if key in result:
                    rec[key] = float(np.real(result[key]))
            if "e history" in result:
                rec["e_history"] = [float(x)
                                    for x in np.asarray(result["e history"])]
                rec["iterations"] = len(rec["e_history"])
        rec.update(extra)
        with open(self.path, "a") as f:
            f.write(json.dumps(rec) + "\n")
        return rec

    def read(self):
        with open(self.path) as f:
            return [json.loads(line) for line in f if line.strip()]
