"""Henikoff weighting parity (ref test.py:37-67, SURVEY.md Appendix A)."""

import jax.numpy as jnp
import numpy as np
import pytest

from weightedld.core.encode import encode_alignment
from weightedld.core.henikoff import henikoff_weights
from weightedld.core.sites import compute_variable_sites

from .fixtures import ALL_FASTAS, GOLDEN, random_alignment
from .oracle import oracle_henikoff


def _encode(seqs):
    return encode_alignment([s.encode() for s in seqs])


@pytest.mark.parametrize("name", sorted(GOLDEN))
def test_golden_weights(name):
    # CLI-path convention: weights computed on the LD-masked alignment
    # (WeightedLD.py:303,397).
    aln = _encode(ALL_FASTAS[name])
    _, ld = compute_variable_sites(jnp.asarray(aln), 0.8, 0.02)
    trimmed = aln[:, np.asarray(ld)]
    w = np.asarray(henikoff_weights(jnp.asarray(trimmed)))
    np.testing.assert_allclose(w, GOLDEN[name]["weights"], atol=2e-4)


def test_paper_example():
    # Henikoff & Henikoff 1994 example -> [0.5, 0.5, 0.5, 0.5, 1.0]
    # (ref test.py:37-47).
    aln = _encode(["AAAAA", "AAAAA", "CCCCC", "CCCCC", "TTTTT"])
    w = np.asarray(henikoff_weights(jnp.asarray(aln)))
    np.testing.assert_allclose(w, [0.5, 0.5, 0.5, 0.5, 1.0], atol=1e-6)


def test_most_unique_gets_max_weight():
    # The most divergent sequence (indel-bearing) weighs exactly 1.0
    # (ref test.py:49-67).
    for name in ("t2", "t3"):
        aln = _encode(ALL_FASTAS[name])
        w = np.asarray(henikoff_weights(jnp.asarray(aln)))
        assert w.max() == pytest.approx(1.0)


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_weights_match_oracle(seed):
    rng = np.random.default_rng(seed)
    aln = random_alignment(rng, n_seqs=23, n_sites=31)
    # Guard against all-ambiguous columns (oracle divides by zero there,
    # mirroring the reference's NaN behaviour) — masked inputs in practice.
    aln[0] = np.where((aln < 5).sum(axis=0) == 0, 0, aln[0])
    w_o = oracle_henikoff(aln)
    w = np.asarray(henikoff_weights(jnp.asarray(aln)))
    np.testing.assert_allclose(w, w_o, rtol=2e-5, atol=2e-6)


def test_paper_variant_divergence_demo():
    # SURVEY.md A.9: on the full example.fasta the Python and Rust formulas
    # genuinely diverge — the ambiguous-base sequence flips from lowest to
    # highest weight.  Our paper-variant reproduces the Rust column.
    from weightedld.core.henikoff import henikoff_weights_paper

    aln = _encode(ALL_FASTAS["example"])
    py = np.asarray(henikoff_weights(jnp.asarray(aln)))
    paper = np.asarray(henikoff_weights_paper(jnp.asarray(aln)))
    np.testing.assert_allclose(
        py, [1.0, 0.4758, 0.4758, 0.4758, 0.9597,
             0.3548, 0.3548, 0.3548, 0.3548, 0.3548], atol=2e-4)
    np.testing.assert_allclose(
        paper, [0.633, 0.3119, 0.3119, 0.3119, 0.4954,
                0.2661, 0.2661, 0.2661, 0.2661, 1.0], atol=2e-4)


def test_chunked_large_path_matches():
    from weightedld.core.henikoff import (
        henikoff_weights_large,
        henikoff_weights_paper,
    )

    rng = np.random.default_rng(9)
    aln = random_alignment(rng, 50, 300)
    aln[0] = np.where((aln < 5).sum(axis=0) == 0, 0, aln[0])
    ref = np.asarray(henikoff_weights(jnp.asarray(aln)))
    got = np.asarray(henikoff_weights_large(aln, site_chunk=64))
    np.testing.assert_allclose(got, ref, rtol=2e-5, atol=2e-6)
    # Paper variant is per-site additive too, so chunking is exact there.
    ref_p = np.asarray(henikoff_weights_paper(jnp.asarray(aln)))
    got_p = np.asarray(
        henikoff_weights_large(aln, site_chunk=64, variant="paper"))
    np.testing.assert_allclose(got_p, ref_p, rtol=2e-5, atol=2e-6)


def test_ambiguous_mean_imputation():
    # A code-5 cell receives the site-mean contribution over concrete alleles
    # (WeightedLD.py:141-145).
    aln = _encode(["AC", "Ay", "TC"])
    w = np.asarray(henikoff_weights(jnp.asarray(aln)))
    w_o = oracle_henikoff(aln)
    np.testing.assert_allclose(w, w_o, rtol=1e-5)


def test_henikoff_site_major_matches_padded():
    # The session's on-device site-major variant must equal the [N, S]
    # formula on the unpadded matrix, for any padding amount.
    import jax.numpy as jnp
    import numpy as np

    from weightedld.core.henikoff import (
        henikoff_weights,
        henikoff_weights_site_major,
    )
    from weightedld.core.majmin import pad_alignment_site_major

    rng = np.random.default_rng(11)
    aln = rng.integers(0, 6, size=(37, 53)).astype(np.int8)
    want = np.asarray(henikoff_weights(jnp.asarray(aln)))
    codes_sm = pad_alignment_site_major(aln, tile=16, seq_chunk=64)
    got = np.asarray(
        henikoff_weights_site_major(jnp.asarray(codes_sm), 37)
    )
    np.testing.assert_allclose(got[:37], want, rtol=1e-6)
    np.testing.assert_array_equal(got[37:], 0.0)


def test_session_weights_none_matches_explicit():
    import jax.numpy as jnp
    import numpy as np

    from weightedld.core.henikoff import henikoff_weights
    from weightedld.runtime.driver import (
        DriverConfig,
        collect_ld_records,
        LdSession,
    )

    rng = np.random.default_rng(12)
    aln = rng.integers(0, 6, size=(30, 40)).astype(np.int8)
    sm = np.arange(40)
    w = np.asarray(henikoff_weights(jnp.asarray(aln)))

    for engine in ("xla", "auto"):
        cfg = DriverConfig(tile=16, engine=engine)
        sess = LdSession(aln, None, sm, cfg)
        # Same values up to f32 reduction order (the site-major variant
        # sums along the other axis)...
        np.testing.assert_allclose(sess.weights, w, rtol=1e-6)
        # ...and the records are exactly those of an explicit run with the
        # weights the session computed.
        want = collect_ld_records(aln, sess.weights, sm,
                                  DriverConfig(tile=16, engine=engine))
        got = collect_ld_records(aln, None, sm, DriverConfig(tile=16,
                                                             engine=engine))
        np.testing.assert_array_equal(got.pos_a, want.pos_a)
        np.testing.assert_array_equal(got.pos_b, want.pos_b)
        np.testing.assert_allclose(got.r2, want.r2, atol=1e-7)


def test_zero_concrete_site_does_not_nan_weights():
    # A site whose every cell is UNKNOWN (possible on the unmasked VCF
    # path) must contribute 0, not NaN-poison every weight through the
    # mean imputation (the reference NaN-poisons here).
    import jax.numpy as jnp
    import numpy as np

    from weightedld.core.henikoff import (
        henikoff_weights,
        henikoff_weights_large,
    )

    aln = np.array([[0, 5, 0], [3, 5, 0], [0, 5, 3]], dtype=np.int8)
    for fn in (henikoff_weights, henikoff_weights_large):
        w = np.asarray(fn(jnp.asarray(aln)) if fn is henikoff_weights
                       else fn(aln))
        assert np.isfinite(w).all(), fn.__name__
        assert w.max() == 1.0
