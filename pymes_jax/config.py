"""Global numerical configuration for pymes_jax.

The reference code (nickirk/pymes) relies on numpy float64 throughout and its
test oracles require 1e-6..1e-8 Ha agreement (see BASELINE.md), so
``jax_enable_x64`` is switched on at import time: CPUs and GPUs both run
native float64.  ``PYMES_X32=1`` keeps JAX's single-precision default, for
speed experiments only.

Importing the package also points JAX's persistent compilation cache at
:data:`CACHE_DIR` unless ``JAX_COMPILATION_CACHE_DIR`` names another
directory, which JAX then uses as it is.

Nothing in the library should call ``jax.config.update`` after import —
flip :func:`enable_x64` before constructing arrays.
"""

import os

import jax

CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache")

_X64_ENABLED = False


def enable_x64() -> None:
    """Enable double precision globally (idempotent)."""
    global _X64_ENABLED
    if not _X64_ENABLED:
        jax.config.update("jax_enable_x64", True)
        _X64_ENABLED = True


def x64_enabled() -> bool:
    return bool(jax.config.jax_enable_x64)


# Unless explicitly disabled, the library runs in f64 — the correctness bar of
# the reference test-suite (1e-8 Ha) cannot be met in f32.
if os.environ.get("PYMES_X32", "0") != "1":
    enable_x64()

if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    jax.config.update("jax_compilation_cache_dir", CACHE_DIR)
