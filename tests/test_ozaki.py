"""Ozaki-split sliced matmul: accuracy and dispatch (VERDICT r1 task 1).

The engine must deliver genuine f64 (<= 1e-14 relative vs numpy) from
exact bf16 slice products accumulated in f32 — the property a
double-single scheme cannot reach (its f32 accumulation rounds per
product).
"""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest

from pymes_jax.ops import contract as ct
from pymes_jax.ops import ozaki


@pytest.mark.parametrize("shape", [(64, 300, 48), (128, 4096, 49),
                                   (7, 7, 7), (130, 129, 131)])
def test_matmul_full_f64_accuracy(shape):
    m, k, n = shape
    rng = np.random.default_rng(42)
    a = rng.standard_normal((m, k))
    b = rng.standard_normal((k, n))
    c0 = a @ b
    c = np.asarray(ozaki.matmul(jnp.asarray(a), jnp.asarray(b)))
    rel = np.linalg.norm(c - c0) / np.linalg.norm(c0)
    assert rel <= 1e-14


def test_matmul_extreme_dynamic_range():
    # lognormal spread over ~8 decades; error is bounded relative to
    # K * rowmax(A) * colmax(B), so measure against that scale
    m, k, n = 128, 4096, 49
    rng = np.random.default_rng(42)
    a = rng.standard_normal((m, k)) * np.exp(rng.standard_normal((m, k)) * 3)
    b = rng.standard_normal((k, n)) * np.exp(rng.standard_normal((k, n)) * 3)
    c0 = a @ b
    c = np.asarray(ozaki.matmul(jnp.asarray(a), jnp.asarray(b)))
    rel = np.linalg.norm(c - c0) / np.linalg.norm(c0)
    assert rel <= 1e-13


def test_matmul_reduced_tiers():
    rng = np.random.default_rng(3)
    a = rng.standard_normal((96, 2048))
    b = rng.standard_normal((2048, 64))
    c0 = a @ b
    scale = np.linalg.norm(c0)
    c76 = np.asarray(ozaki.matmul(jnp.asarray(a), jnp.asarray(b),
                                  n_slices=7, t_cutoff=6))
    c54 = np.asarray(ozaki.matmul(jnp.asarray(a), jnp.asarray(b),
                                  n_slices=5, t_cutoff=4))
    assert np.linalg.norm(c76 - c0) / scale < 1e-8
    assert np.linalg.norm(c54 - c0) / scale < 1e-5
    # tiers are ordered: more slices => closer
    assert (np.linalg.norm(c76 - c0) < np.linalg.norm(c54 - c0))


def test_matmul_edge_cases():
    # zero rows/cols (scale guard) and exact powers of two
    a = np.zeros((8, 16))
    a[0] = 2.0 ** np.arange(-8, 8)
    b = np.ones((16, 4))
    c = np.asarray(ozaki.matmul(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_allclose(c, a @ b, rtol=1e-15, atol=0)

    # huge-K chunked path: force k_chunk < k via a large K
    rng = np.random.default_rng(7)
    a = rng.standard_normal((4, 70000))
    b = rng.standard_normal((70000, 4))
    c = np.asarray(ozaki.matmul(jnp.asarray(a), jnp.asarray(b)))
    rel = np.abs(c - a @ b).max() / np.abs(a @ b).max()
    assert rel < 1e-13


@pytest.mark.parametrize("spec,sha,shb", [
    ("abcd,cdij->abij", (6, 6, 10, 10), (10, 10, 4, 4)),
    ("klcd,adkj->alcj", (4, 4, 10, 10), (10, 10, 4, 4)),
    ("acik,cbkj->abij", (10, 10, 4, 4), (10, 10, 4, 4)),
    ("adkl,lkdc->ac", (10, 10, 4, 4), (4, 4, 10, 10)),
    ("aij,ajk->aik", (3, 5, 6), (3, 6, 7)),       # batch dim
    ("ab,bc->ac", (5, 6), (6, 7)),
])
def test_einsum2_matches_numpy(spec, sha, shb):
    rng = np.random.default_rng(11)
    a = rng.standard_normal(sha)
    b = rng.standard_normal(shb)
    r0 = np.einsum(spec, a, b)
    r1 = np.asarray(ozaki.einsum2(spec, jnp.asarray(a), jnp.asarray(b)))
    assert np.abs(r1 - r0).max() <= 1e-13 * max(np.abs(r0).max(), 1.0)


def test_contract_dispatch():
    rng = np.random.default_rng(5)
    a = jnp.asarray(rng.standard_normal((64, 4096)))
    b = jnp.asarray(rng.standard_normal((4096, 64)))
    small = jnp.asarray(rng.standard_normal((4, 4)))
    assert ct.get_mode() == "xla"
    try:
        ct.set_mode("ozaki")
        big = ct.contract("ik,kj->ij", a, b)       # routed through ozaki
        tiny = ct.contract("ik,kj->ij", small, small)  # stays on einsum
        ref = np.asarray(a) @ np.asarray(b)
        assert np.abs(np.asarray(big) - ref).max() <= 1e-12 * np.abs(ref).max()
        np.testing.assert_allclose(np.asarray(tiny),
                                   np.asarray(small) @ np.asarray(small),
                                   rtol=1e-12)
        with pytest.raises(ValueError):
            ct.set_mode("nope")
    finally:
        ct.set_mode("xla")


def test_contract_mulsum_lowering():
    """Skinny shapes (short K / small output / outer / batched) go through
    ``contract`` as plain ``jnp.einsum`` in every mode — they sit below
    the ozaki gate — and match np.einsum to f64 rounding."""
    rng = np.random.default_rng(9)
    cases = [
        # short contracted axis (K=7)
        ("ak,kbij->abij", (40, 7), (7, 41, 6, 5)),
        # small output over big K
        ("bj,ajib->ai", (50, 6), (40, 6, 5, 50)),
        ("ck,ikjc->ij", (50, 6), (6, 6, 7, 50)),
        # outer product (no contraction)
        ("ai,bj->abij", (9, 5), (8, 6)),
        # batch index present
        ("kab,kbc->kac", (3, 10, 7), (3, 7, 9)),
    ]
    for (spec, sha, shb), mode in itertools.product(cases,
                                                     ("xla", "ozaki:7:6")):
        a = rng.standard_normal(sha)
        b = rng.standard_normal(shb)
        r0 = np.einsum(spec, a, b)
        aj, bj = jnp.asarray(a), jnp.asarray(b)
        r1 = np.asarray(ct.contract(spec, aj, bj, mode=mode))
        np.testing.assert_array_equal(r1, np.asarray(jnp.einsum(spec, aj,
                                                                bj)))
        assert np.abs(r1 - r0).max() <= 1e-12 * max(np.abs(r0).max(), 1.0), \
            spec
