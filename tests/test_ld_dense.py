"""Dense LD engine parity: golden fixtures + random property tests vs the
float64 loop oracle (ref WeightedLD.py:154-284, SURVEY.md Appendix A)."""

import jax.numpy as jnp
import numpy as np
import pytest

from weightedld.core.encode import encode_alignment
from weightedld.core.ld_dense import extract_records, ld_all_pairs_dense
from weightedld.pipeline import WldConfig, prepare_fasta

from .fixtures import ALL_FASTAS, GOLDEN, random_alignment, write_fasta
from .oracle import oracle_ld


def _run_fixture(tmp_path, name):
    path = tmp_path / f"{name}.fasta"
    write_fasta(path, ALL_FASTAS[name])
    res = prepare_fasta(path, WldConfig())
    stats = ld_all_pairs_dense(jnp.asarray(res.alignment), jnp.asarray(res.weights))
    return extract_records(stats, res.site_map)


@pytest.mark.parametrize("name", sorted(GOLDEN))
def test_golden_pairs(tmp_path, name):
    rec = _run_fixture(tmp_path, name)
    golden = GOLDEN[name]["pairs"]
    got = {(int(a), int(b)): (d, dp, r2)
           for a, b, d, dp, r2 in zip(rec.pos_a, rec.pos_b, rec.d, rec.d_prime, rec.r2)}
    assert set(got) == {(a, b) for a, b, *_ in golden}, name
    for a, b, d, dp, r2 in golden:
        gd, gdp, gr2 = got[(a, b)]
        np.testing.assert_allclose([gd, gdp, gr2], [d, dp, r2], atol=2e-4,
                                   err_msg=f"{name} pair ({a},{b})")


@pytest.mark.parametrize("seed,n_seqs,n_sites", [
    (10, 16, 12), (11, 40, 20), (12, 9, 30), (13, 64, 17), (14, 128, 24),
])
def test_matches_oracle_random(seed, n_seqs, n_sites):
    rng = np.random.default_rng(seed)
    aln = random_alignment(rng, n_seqs, n_sites)
    weights = rng.random(n_seqs).astype(np.float64) + 0.05

    expected = oracle_ld(aln, weights)
    stats = ld_all_pairs_dense(jnp.asarray(aln), jnp.asarray(weights, dtype=jnp.float32))
    rec = extract_records(stats, np.arange(n_sites))

    got = {(int(a), int(b)): (d, dp, r2)
           for a, b, d, dp, r2 in zip(rec.pos_a, rec.pos_b, rec.d, rec.d_prime, rec.r2)}
    exp = {(a, b): v for a, b, *v in expected}
    assert set(got) == set(exp), "surviving pair sets differ"
    for key, (d, dp, r2) in exp.items():
        gd, gdp, gr2 = got[key]
        np.testing.assert_allclose(gd, d, rtol=2e-4, atol=1e-5, err_msg=f"D {key}")
        if np.isfinite(dp):
            np.testing.assert_allclose(gdp, dp, rtol=2e-3, atol=1e-4,
                                       err_msg=f"D' {key}")
        np.testing.assert_allclose(gr2, r2, rtol=5e-4, atol=1e-5, err_msg=f"r2 {key}")


def test_unweighted_matches_oracle(rng):
    aln = random_alignment(rng, 32, 16)
    weights = np.ones(32)
    expected = oracle_ld(aln, weights)
    stats = ld_all_pairs_dense(jnp.asarray(aln), jnp.ones(32, dtype=jnp.float32))
    rec = extract_records(stats, np.arange(16))
    assert len(rec) == len(expected)


def test_r2_threshold():
    # Rust-style strict r2 > threshold filtering (lib.rs:659-667).
    aln = encode_alignment([s.encode() for s in ALL_FASTAS["t1"]])[:, 2:]
    stats = ld_all_pairs_dense(
        jnp.asarray(aln), jnp.asarray([0.5, 0.5, 0.5, 0.5, 1.0], dtype=jnp.float32)
    )
    all_rec = extract_records(stats, np.arange(5))
    assert len(all_rec) == 10
    none_rec = extract_records(stats, np.arange(5), r2_threshold=1.0)
    assert len(none_rec) == 0  # r2 == 1.0 is not > 1.0


@pytest.mark.parametrize("name,gen", [
    # Tie-heavy: tiny alphabet + few sequences forces frequent count ties,
    # stressing the smallest-code tie-break in major/domMinor selection.
    ("ties", lambda rng: rng.integers(0, 2, size=(8, 40)).astype(np.int8)),
    # Gap-heavy: code 4 often IS the major allele.
    ("gaps", lambda rng: np.where(rng.random((30, 25)) < 0.5, 4,
                                  rng.integers(0, 4, (30, 25))).astype(np.int8)),
    # Unknown-heavy: most pairs lose most sequences to the code-5 filter.
    ("unknowns", lambda rng: np.where(rng.random((40, 20)) < 0.6, 5,
                                      rng.integers(0, 5, (40, 20))).astype(np.int8)),
    # Multi-allelic with near-equal counts: dominant-minor vs all-minor and
    # second-argmax tie-breaks.
    ("multiallelic", lambda rng: rng.integers(0, 5, size=(60, 30)).astype(np.int8)),
])
def test_adversarial_distributions_match_oracle(name, gen):
    # zlib.crc32, not hash(): PYTHONHASHSEED would make the data vary per run.
    import zlib

    rng = np.random.default_rng(zlib.crc32(name.encode()))
    aln = gen(rng)
    weights = rng.random(aln.shape[0]).astype(np.float64) + 0.01
    expected = oracle_ld(aln, weights)
    stats = ld_all_pairs_dense(jnp.asarray(aln),
                               jnp.asarray(weights, dtype=jnp.float32))
    rec = extract_records(stats, np.arange(aln.shape[1]))
    got = {(int(a), int(b)): (d, r2)
           for a, b, d, r2 in zip(rec.pos_a, rec.pos_b, rec.d, rec.r2)}
    exp = {(a, b): (d, r2) for a, b, d, dp, r2 in expected}
    assert set(got) == set(exp), f"{name}: surviving pair sets differ"
    for key, (d, r2) in exp.items():
        np.testing.assert_allclose(got[key][0], d, rtol=5e-4, atol=2e-5,
                                   err_msg=f"{name} D {key}")
        np.testing.assert_allclose(got[key][1], r2, rtol=1e-3, atol=2e-5,
                                   err_msg=f"{name} r2 {key}")
