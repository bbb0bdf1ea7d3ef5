"""Variable-site mask parity (ref test.py:19-35, SURVEY.md Appendix A)."""

import jax.numpy as jnp
import numpy as np
import pytest

from weightedld.core.encode import encode_alignment
from weightedld.core.sites import compute_variable_sites

from .fixtures import ALL_FASTAS, GOLDEN, T6_VARSITES_HK_LD, random_alignment
from .oracle import oracle_variable_sites


def _encode(seqs):
    return encode_alignment([s.encode() for s in seqs])


@pytest.mark.parametrize("name", sorted(GOLDEN))
def test_golden_masks(name):
    aln = _encode(ALL_FASTAS[name])
    hk, ld = compute_variable_sites(jnp.asarray(aln), 0.8, 0.02)
    assert np.asarray(hk).astype(int).tolist() == GOLDEN[name]["hk"]
    assert np.asarray(ld).astype(int).tolist() == GOLDEN[name]["ld"]


def test_t6_high_variability():
    # min_variability=0.2 drops site 1 (minor frac 0.1) that HK keeps
    # (ref test.py:28-35).
    aln = _encode(T6_VARSITES_HK_LD)
    hk, ld = compute_variable_sites(jnp.asarray(aln), 0.8, 0.2)
    assert np.asarray(hk).astype(int).tolist() == [1, 1, 1, 1]
    assert np.asarray(ld).astype(int).tolist() == [1, 0, 0, 0]


def test_rust_variant_filter():
    from weightedld.core.sites import compute_variable_sites_rust

    # t1: cols 0-1 fail coverage; cols 2-6 have maj=2, dom-minor=2 ->
    # frac 0.5, kept at default thresholds (<= max_minor 0.5 inclusive).
    aln = _encode(ALL_FASTAS["t1"])
    mask = compute_variable_sites_rust(jnp.asarray(aln), 0.8, 0.02)
    assert np.asarray(mask).astype(int).tolist() == [0, 0, 1, 1, 1, 1, 1]
    # Dominant-minor semantics differ from Python's all-minor: a site with
    # counts {A:6, C:2, T:2} has all-minor frac 0.4 but dominant frac 0.25.
    aln2 = _encode(["AC", "AC", "AT", "AT", "AA", "AA", "AA", "AA", "AA", "AA"])
    mask2 = compute_variable_sites_rust(jnp.asarray(aln2), 0.0, 0.3)
    assert np.asarray(mask2).astype(int).tolist() == [0, 0]
    _, ld_py = compute_variable_sites(jnp.asarray(aln2), 0.0, 0.3)
    assert np.asarray(ld_py).astype(int).tolist() == [0, 1]  # 0.4 >= 0.3


@pytest.mark.parametrize("min_acgt,min_var", [(0.8, 0.02), (0.5, 0.1), (0.0, 0.0)])
def test_masks_match_oracle(rng, min_acgt, min_var):
    aln = random_alignment(rng, n_seqs=37, n_sites=53)
    hk_o, ld_o = oracle_variable_sites(aln, min_acgt, min_var)
    hk, ld = compute_variable_sites(jnp.asarray(aln), min_acgt, min_var)
    np.testing.assert_array_equal(np.asarray(hk), hk_o)
    np.testing.assert_array_equal(np.asarray(ld), ld_o)
