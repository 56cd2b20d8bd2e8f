"""pymes_jax — a JAX many-electron (post-Hartree-Fock) framework.

A ground-up JAX/XLA rebuild with the capabilities of PyMES
(nickirk/pymes): MP2, (dr)CCD/DCD, CCSD/DCSD ground states with DIIS;
EOM-CCSD (Davidson), FEAST-EOM-CCSD (contour-integral energy filtering) and
CIF real-time EOM-CCSD excited-state dynamics; non-Hermitian transcorrelated
Hamiltonians with 3-body integral contractions; a 3D uniform-electron-gas
model Hamiltonian with plane-wave bases, correlators and twist averaging;
and FCIDUMP/TCDUMP interfaces.

Design (not a port):

* residual/sigma builders are pure jitted functions over named integral
  blocks; amplitude iterations are ``lax.while_loop`` fixed-point solves that
  carry the DIIS ring buffer on device;
* the distributed tensor role of CTF (C++/MPI) in the reference is played by
  ``jax.sharding`` meshes: V/T tensors sharded over virtual-orbital axes,
  contractions lowered to XLA collectives (NCCL over NVLink between GPUs;
  ``pymes_jax.parallel``);
* hot contractions run native f64 GEMMs through XLA, and the UEG ladder
  runs as momentum-block-diagonal sector GEMMs
  (``pymes_jax.ops.ueg_ladder``) that never hold the nv⁴ tensor; the
  Ozaki sliced engine (``pymes_jax.ops.ozaki``: mantissa slices in bf16,
  exact f32 accumulation) remains as an optional contraction mode.
"""

from pymes_jax import config  # noqa: F401  (side effect: enable x64)

__version__ = "0.1.0"
