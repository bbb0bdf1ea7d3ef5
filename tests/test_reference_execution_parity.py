"""Ultimate parity check: run the ACTUAL reference implementation
(/root/reference/WeightedLD.py, executed in-process with its BioPython
dependency stubbed and the removed np.bool8 alias restored) against this
framework on random inputs.

This is stronger than the hand-written oracle in ``oracle.py``: the
reference's own code produces the expected masks, weights, and LD rows.
Skipped when the reference checkout is absent.
"""

import io
import os
import sys
import types
from contextlib import redirect_stdout

import jax.numpy as jnp
import numpy as np
import pytest

from .fixtures import random_alignment

REFERENCE = "/root/reference"

pytestmark = pytest.mark.skipif(
    not os.path.exists(os.path.join(REFERENCE, "WeightedLD.py")),
    reason="reference checkout not available",
)


@pytest.fixture(scope="module")
def ref():
    """Import the reference module with compat shims (numpy 2, no BioPython)."""
    if not hasattr(np, "bool8"):
        np.bool8 = np.bool_  # removed in numpy 2; used at WeightedLD.py:190
    if "Bio" not in sys.modules:
        bio = types.ModuleType("Bio")
        bio.AlignIO = types.SimpleNamespace(read=None)  # unused in these tests
        sys.modules["Bio"] = bio
    sys.path.insert(0, REFERENCE)
    try:
        import WeightedLD as wld_ref
    finally:
        sys.path.remove(REFERENCE)
    return wld_ref


def _pair_has_count_tie(col_a, col_b) -> bool:
    """True when either site of the pair has a count tie among its top-3
    symbols AFTER the unknown filter.  There the reference's behavior is
    UNSPECIFIED: its per-pair ``np.argsort(-counts)`` uses numpy's
    unstable default quicksort, so the major/domMinor pick is content-
    and numpy-version-dependent (verified: counts [1,2,4,4] -> major is
    code 3, [2,4,4] -> code 2).  A top-2 tie only flips D's sign; a
    rank-2/3 tie changes the kept-sequence set entirely — so tie pairs
    are excluded from strict cross-implementation comparison (the
    framework itself is deterministic: smallest code, the Rust rule)."""
    keep = (col_a != 5) & (col_b != 5)
    for col in (col_a[keep], col_b[keep]):
        _u, c = np.unique(col, return_counts=True)
        cs = np.sort(c)
        if len(cs) >= 2 and (cs[-1] == cs[-2]
                             or (len(cs) >= 3 and cs[-2] == cs[-3])):
            return True
    return False


def _ref_ld_rows(ref, alignment, weights, site_map):
    buf = io.StringIO()
    with redirect_stdout(buf):
        ref.ld(alignment, weights, site_map)
    rows = {}
    for line in buf.getvalue().strip().split("\n")[1:]:
        if not line:
            continue
        a, b, d, dp, r2 = line.split("\t")
        rows[(int(a), int(b))] = (float(d), float(dp), float(r2))
    return rows


@pytest.mark.parametrize("seed,n_seqs,n_sites,kw", [
    (101, 24, 14, {}), (102, 50, 10, {}), (103, 12, 20, {}),
    (104, 80, 12, {}), (105, 9, 16, {}), (106, 120, 40, {}),
    # Adversarial mixes: gap-heavy (gaps count as alleles but not
    # coverage) and ambiguity-heavy (code-5 drops drive the per-pair
    # major/minor recomputation).
    (107, 40, 18, {"p_gap": 0.14, "p_unknown": 0.02}),
    (108, 40, 18, {"p_gap": 0.02, "p_unknown": 0.25}),
])
def test_masks_weights_ld_match_reference(ref, seed, n_seqs, n_sites, kw):
    from weightedld.core.henikoff import henikoff_weights
    from weightedld.core.ld_dense import extract_records, ld_all_pairs_dense
    from weightedld.core.sites import compute_variable_sites

    rng = np.random.default_rng(seed)
    aln = random_alignment(rng, n_seqs, n_sites, **kw)

    # Masks: bit-for-bit (host f64 twin, as used by the ingest pipeline).
    from weightedld.core.sites import compute_variable_sites_host

    hk_r, ld_r = ref.compute_variable_sites(aln, 0.8, 0.02)
    hk_o, ld_o = compute_variable_sites_host(aln, 0.8, 0.02)
    np.testing.assert_array_equal(hk_o, hk_r)
    np.testing.assert_array_equal(ld_o, ld_r)

    trimmed = aln[:, ld_r]
    if trimmed.shape[1] < 2:
        pytest.skip("degenerate draw: <2 LD sites")

    # Weights: float tolerance against the reference's float64.
    w_r = ref.henikoff_weighting(trimmed)
    w_o = np.asarray(henikoff_weights(jnp.asarray(trimmed)))
    np.testing.assert_allclose(w_o, w_r, rtol=3e-5, atol=3e-6)

    # LD rows: same surviving pairs; values to the reference's own 4-dp
    # rounding tolerance.
    site_map = np.where(ld_r)[0]
    expected = _ref_ld_rows(ref, trimmed, w_r, site_map)
    stats = ld_all_pairs_dense(jnp.asarray(trimmed),
                               jnp.asarray(w_r, dtype=jnp.float32))
    rec = extract_records(stats, site_map)
    got = {(int(a), int(b)): (float(d), float(dp), float(r2))
           for a, b, d, dp, r2 in zip(rec.pos_a, rec.pos_b,
                                      rec.d, rec.d_prime, rec.r2)}
    # Pairs with per-pair count ties are excluded: the reference's pick
    # there is unstable-argsort-arbitrary (see _pair_has_count_tie).
    pos_to_col = {int(p): i for i, p in enumerate(site_map)}
    tie = {key for key in set(got) | set(expected)
           if _pair_has_count_tie(trimmed[:, pos_to_col[key[0]]],
                                  trimmed[:, pos_to_col[key[1]]])}
    assert set(got) - tie == set(expected) - tie
    for key, (d, dp, r2) in expected.items():
        if key in tie:
            continue
        gd, gdp, gr2 = got[key]
        np.testing.assert_allclose(gd, d, atol=2e-4, err_msg=f"D {key}")
        if np.isfinite(dp) and np.isfinite(gdp):
            np.testing.assert_allclose(gdp, dp, atol=5e-4, err_msg=f"D' {key}")
        np.testing.assert_allclose(gr2, r2, atol=5e-4, err_msg=f"r2 {key}")


@pytest.mark.parametrize("seed", range(120, 150))
def test_host_f64_weights_bit_equal_to_reference(ref, seed):
    """The ingest path's f64 host twin must produce BIT-identical weights
    to the executed reference (WeightedLD.py:101-151) — not just
    tolerance-equal — so the weights TSV is unconditionally byte-equal.
    Randomized campaign over gap/ambiguity mixes."""
    from weightedld.core.henikoff import henikoff_weights_host

    rng = np.random.default_rng(seed)
    kw = {}
    if seed % 3 == 1:
        kw = {"p_gap": 0.2, "p_unknown": 0.1}
    elif seed % 3 == 2:
        kw = {"p_gap": 0.02, "p_unknown": 0.3}
    aln = random_alignment(rng, int(rng.integers(3, 60)),
                           int(rng.integers(2, 40)), **kw)
    # Guard the reference's NaN edge (site with zero concrete alleles):
    # our twin deliberately diverges there (imputes 0, documented).
    counts = np.stack([(aln == s).sum(axis=0) for s in range(5)])
    if (counts.sum(axis=0) == 0).any():
        aln[0] = 0
    w_r = ref.henikoff_weighting(aln)
    w_o = henikoff_weights_host(aln)
    assert w_o.dtype == np.float64
    np.testing.assert_array_equal(w_o, w_r)  # bitwise


def test_fixture_weights_tsv_bytes_match_reference(ref):
    """End-of-pipe check on every FASTA fixture: the weights TSV our writer
    emits from the ingest path equals the one written from the executed
    reference's float64 weights, byte for byte."""
    import io as _io

    from .fixtures import ALL_FASTAS

    from weightedld.core.encode import encode_alignment
    from weightedld.io.writer import write_weights
    from weightedld.pipeline import _weights_for

    for name, seqs in sorted(ALL_FASTAS.items()):
        aln = encode_alignment([s.encode() for s in seqs])
        _hk, ld_r = ref.compute_variable_sites(aln, 0.8, 0.02)
        trimmed = aln[:, ld_r]
        if trimmed.shape[1] < 1:
            continue
        w_r = ref.henikoff_weighting(trimmed)
        a, b = _io.StringIO(), _io.StringIO()
        write_weights(_weights_for(trimmed), a)
        write_weights(w_r, b)
        assert a.getvalue() == b.getvalue(), name


def test_fixture_fastas_match_reference_end_to_end(ref, tmp_path):
    from .fixtures import ALL_FASTAS

    from weightedld.core.henikoff import henikoff_weights
    from weightedld.core.ld_dense import extract_records, ld_all_pairs_dense
    from weightedld.core.encode import encode_alignment

    for name, seqs in sorted(ALL_FASTAS.items()):
        aln = encode_alignment([s.encode() for s in seqs])
        hk_r, ld_r = ref.compute_variable_sites(aln, 0.8, 0.02)
        trimmed = aln[:, ld_r]
        if trimmed.shape[1] < 2:
            continue
        w_r = ref.henikoff_weighting(trimmed)
        site_map = np.where(ld_r)[0]
        expected = _ref_ld_rows(ref, trimmed, w_r, site_map)
        stats = ld_all_pairs_dense(jnp.asarray(trimmed),
                                   jnp.asarray(w_r, dtype=jnp.float32))
        rec = extract_records(stats, site_map)
        got = {(int(a), int(b)) for a, b in zip(rec.pos_a, rec.pos_b)}
        assert got == set(expected), name


SAMPLES = 16
_VCF_HEADER = (
    "##fileformat=VCFv4.1\n"
    "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t"
    + "\t".join(f"s{i}" for i in range(SAMPLES))
)


def _vcf_row(pos, gts):
    return f"1\t{pos}\trs\tA\tT\t100\tPASS\t.\tGT\t" + "\t".join(gts)


@pytest.mark.parametrize("name,gts", [
    ("phased", ["0|1"] * 8 + ["1|1"] * 4 + ["0|0"] * 4),
    ("unphased", ["0/1"] * SAMPLES),                      # -> all missing
    ("half_call", [".|1"] * 8 + ["1|."] * 8),
    ("alt2", ["0|2", "2|1"] + ["0|0"] * (SAMPLES - 2)),
])
def test_vcf_matches_reference_execution(ref, tmp_path, name, gts):
    """Run the ACTUAL reference handle_vcf on synthetic files (POS < 256 so
    its uint8 wrap is the identity and it survives modern numpy) and demand
    bit-exact alignment/site_map parity from our reader."""
    from weightedld.io.vcf import read_vcf

    path = tmp_path / f"{name}.vcf"
    path.write_text(
        _VCF_HEADER + "\n" + _vcf_row(100, gts)
        + "\n" + _vcf_row(200, list(reversed(gts))) + "\n"
    )
    aln_r, sm_r = ref.handle_vcf(str(path))
    aln_o, sm_o = read_vcf(path)
    np.testing.assert_array_equal(aln_o, aln_r.astype(np.int8))
    np.testing.assert_array_equal(sm_o, sm_r)


def test_vcf_fully_missing_call_is_extension(ref, tmp_path):
    """Documented divergence: a fully-missing diploid call '.|.' matches the
    reference's non-digit-pipe strip regex (WeightedLD.py:352) and crashes
    it with an empty token; we decode it as two missing haplotypes."""
    from weightedld.io.vcf import read_vcf

    gts = [".|."] * 4 + ["0|1"] * (SAMPLES - 4)
    path = tmp_path / "missing.vcf"
    path.write_text(_VCF_HEADER + "\n" + _vcf_row(100, gts) + "\n")
    with pytest.raises(ValueError):
        ref.handle_vcf(str(path))
    aln, _ = read_vcf(path)
    assert int((aln == 4).sum()) == 8  # 4 calls x 2 haplotypes


def test_zero_weight_corner_documented_divergence(ref):
    """Zero weights are not a supported exclusion mechanism: when a pair's
    only surviving major carrier has weight exactly 0.0, the reference
    prints an r2 = 0/0 = NaN row (PA is an unmasked 0.0).  The f64 audit
    engine keeps that behaviour; the XLA engine skips the pair (documented
    in paircore.finalize_pair_tile).  Pin both."""
    import io
    import warnings
    from contextlib import redirect_stdout

    import jax.numpy as jnp

    from weightedld.core.ld_dense import extract_records, ld_all_pairs_dense
    from weightedld.core.reference_impl import reference_pair

    # Site pair where seq 0 is the sole major-at-A carrier surviving the
    # second filter; its weight is 0.  A: 0 x3 / 1 x3 -> tie, major = 0.
    # B: all kept.  Seqs 1,2 carry allele 2 at B (3rd symbol) -> dropped.
    col_a = np.array([0, 0, 0, 1, 1, 1], dtype=np.int8)
    col_b = np.array([0, 2, 2, 0, 1, 1], dtype=np.int8)
    w = np.array([0.0, 1.0, 1.0, 1.0, 1.0, 1.0])
    aln = np.stack([col_a, col_b], axis=1)

    buf = io.StringIO()
    with redirect_stdout(buf), warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ref.ld(aln, w, np.array([0, 1]))
    rows = [ln for ln in buf.getvalue().strip().split("\n")[1:] if ln]
    assert len(rows) == 1 and rows[0].split("\t")[4] == "nan"  # NaN row

    res = reference_pair(col_a, col_b, w)          # audit engine: NaN row
    assert res is not None and np.isnan(res[2])

    dense = extract_records(                        # XLA engine: skipped
        ld_all_pairs_dense(jnp.asarray(aln),
                           jnp.asarray(w, dtype=jnp.float32)),
        np.arange(2),
    )
    assert len(dense.r2) == 0


def test_crash_pairs_are_skipped_exactly(ref):
    """The reference CRASHES (TypeError on a masked ``round(PA, 1)``,
    WeightedLD.py:227-235) whenever the count-major allele at either site
    retains zero weight after the second filter — it defines no output for
    such pairs.  Our engines skip them.  Demand exact kept-set equality on
    adversarial tiny alignments by running the reference per pair and
    treating a crash as "skipped"."""
    import io
    import warnings
    from contextlib import redirect_stdout

    import jax.numpy as jnp

    from weightedld.core.ld_dense import extract_records, ld_all_pairs_dense

    n_crashes = 0
    for seed in range(24):
        r = np.random.default_rng(seed)
        aln = r.integers(0, 6, size=(6, 8)).astype(np.int8)
        w = (r.random(6) + 0.05).astype(np.float64)

        expected = {}
        for a in range(8):
            for b in range(a + 1, 8):
                buf = io.StringIO()
                try:
                    with redirect_stdout(buf), warnings.catch_warnings():
                        warnings.simplefilter("ignore")
                        ref.ld(aln[:, [a, b]], w, np.array([a, b]))
                except TypeError:
                    n_crashes += 1  # masked PA/PB -> no defined output
                    continue
                for line in buf.getvalue().strip().split("\n")[1:]:
                    if line:
                        pa, pb, d, dp, r2 = line.split("\t")
                        expected[(int(pa), int(pb))] = float(r2)

        dense = extract_records(
            ld_all_pairs_dense(jnp.asarray(aln),
                               jnp.asarray(w, dtype=jnp.float32)),
            np.arange(8),
        )
        got = {(int(a), int(b)): float(r2)
               for a, b, r2 in zip(dense.pos_a, dense.pos_b, dense.r2)}
        assert set(got) == set(expected), seed
        assert np.isfinite(dense.r2).all(), seed
        for key, r2_ref in expected.items():
            np.testing.assert_allclose(got[key], r2_ref, atol=5e-4,
                                       err_msg=str((seed, key)))
    assert n_crashes > 0, "fuzz never hit a reference-crash pair"


@pytest.mark.parametrize("min_acgt,min_var", [(0.5, 0.1), (0.0, 0.0), (0.9, 0.3)])
def test_mask_parameter_sweep_matches_reference(ref, min_acgt, min_var):
    # The host f64 masks (used by the ingest pipeline) must be bit-exact
    # even at threshold boundaries like 36/40 == 0.9 (where the jitted f32
    # version can legitimately differ — see compute_variable_sites_host).
    from weightedld.core.sites import compute_variable_sites_host

    rng = np.random.default_rng(200)
    aln = random_alignment(rng, 40, 30)
    hk_r, ld_r = ref.compute_variable_sites(aln, min_acgt, min_var)
    hk_o, ld_o = compute_variable_sites_host(aln, min_acgt, min_var)
    np.testing.assert_array_equal(hk_o, hk_r)
    np.testing.assert_array_equal(ld_o, ld_r)


def test_pa_095_boundary_pair_is_skipped(ref):
    """The reference's PA is a np.float64, and np.float64.__round__ scales
    by 10 before rounding — double(0.95) * 10 lands exactly on 9.5 and
    half-evens UP, so round(PA, 1) == 1.0 and the exact-boundary pair
    (PA = 19/20 under unit weights) is SKIPPED (WeightedLD.py:234-237).
    Note a Python-float reimplementation would flip this: decimal-correct
    round(0.95, 1) == 0.9 would KEEP the pair.  Executed here against the
    actual reference, the f64 audit engine, the dense engine, and the
    tiled integer engine."""
    # The two round() semantics really do disagree at this boundary.
    assert round(np.float64(0.95), 1) == 1.0
    assert round(0.95, 1) == 0.9

    from weightedld.core.ld_dense import extract_records, ld_all_pairs_dense
    from weightedld.core.reference_impl import reference_pair

    aln = np.zeros((20, 2), dtype=np.int8)
    aln[0, 0] = 1   # site 0: 19 x A, 1 x C  ->  PA = 19/20 = 0.95 exactly
    aln[0, 1] = 1   # site 1: same           ->  PB = 0.95 exactly
    w = np.ones(20, dtype=np.float64)

    assert _ref_ld_rows(ref, aln, w, np.arange(2)) == {}
    assert reference_pair(aln[:, 0], aln[:, 1], w) is None

    rec = extract_records(
        ld_all_pairs_dense(jnp.asarray(aln), jnp.ones(20, jnp.float32)),
        np.arange(2),
    )
    assert len(rec.pos_a) == 0, "engine kept the exact-0.95 boundary pair"

    from weightedld.runtime.driver import DriverConfig, LdSession

    session = LdSession(aln, np.ones(20, np.float32), np.arange(2),
                        DriverConfig(tile=8, seq_chunk=8))
    pal = [(int(a), int(b))
           for _, r in session.stream() for a, b in zip(r.pos_a, r.pos_b)]
    assert pal == [], "tile engine kept the exact-0.95 boundary pair"

    # Sanity that the rule is not over-aggressive: PA = 18/20 = 0.9 is kept
    # by the reference and by every engine.
    aln2 = np.zeros((20, 2), dtype=np.int8)
    aln2[:2, 0] = 1
    aln2[:2, 1] = 1
    expected = _ref_ld_rows(ref, aln2, w, np.arange(2))
    assert (0, 1) in expected
    rec2 = extract_records(
        ld_all_pairs_dense(jnp.asarray(aln2), jnp.ones(20, jnp.float32)),
        np.arange(2),
    )
    assert [(int(a), int(b)) for a, b in zip(rec2.pos_a, rec2.pos_b)] \
        == [(0, 1)]
    np.testing.assert_allclose(
        (rec2.d[0], rec2.d_prime[0], rec2.r2[0]), expected[(0, 1)],
        atol=5e-4)


def test_auto_config_session_matches_reference(ref):
    # The PRODUCTION driver path with every knob auto-resolved (the
    # integer tile engine; tile and seq_chunk from the auto rules) against the executed reference — guards the
    # auto policies themselves, not just hand-picked tiny tile configs.
    from weightedld.core.sites import compute_variable_sites_host
    from weightedld.runtime.driver import DriverConfig, LdSession

    rng = np.random.default_rng(990)
    aln = random_alignment(rng, 60, 30, p_gap=0.08, p_unknown=0.08)
    _hk, ld = compute_variable_sites_host(aln, 0.8, 0.02)
    trimmed = aln[:, ld]
    assert trimmed.shape[1] >= 2
    w = ref.henikoff_weighting(trimmed)
    site_map = np.where(ld)[0]
    expected = _ref_ld_rows(ref, trimmed, w, site_map)

    sess = LdSession(trimmed, np.asarray(w, np.float32), site_map,
                     DriverConfig())
    assert sess.cfg.tile == 128 and sess.cfg.seq_chunk == 128  # auto rules
    got = {}
    for _, r in sess.stream():
        for a, b, d, dp, r2 in zip(r.pos_a, r.pos_b, r.d, r.d_prime, r.r2):
            got[(int(a), int(b))] = (float(d), float(dp), float(r2))
    pos_to_col = {int(p): i for i, p in enumerate(site_map)}
    tie = {key for key in set(got) | set(expected)
           if _pair_has_count_tie(trimmed[:, pos_to_col[key[0]]],
                                  trimmed[:, pos_to_col[key[1]]])}
    assert set(got) - tie == set(expected) - tie
    for key, (d, dp, r2) in expected.items():
        if key in tie:
            continue
        np.testing.assert_allclose(got[key][0], d, atol=2e-4,
                                   err_msg=f"D {key}")
        if np.isfinite(dp) and np.isfinite(got[key][1]):
            np.testing.assert_allclose(got[key][1], dp, atol=5e-4,
                                       err_msg=f"D' {key}")
        np.testing.assert_allclose(got[key][2], r2, atol=5e-4,
                                   err_msg=f"r2 {key}")


def test_unstable_argsort_tie_only_flips_d_sign(ref):
    # The case the extended parity campaign discovered: per-pair counts
    # [1,2,4,4] at one site.  numpy's unstable argsort makes the
    # reference's major/domMinor pick arbitrary there; the framework picks
    # the smallest code deterministically.  Whatever the reference picks,
    # |D|, D' and r2 must agree — a top-2 relabeling can only flip D's
    # sign.
    from weightedld.core.ld_dense import (extract_records,
                                              ld_all_pairs_dense)

    col_a = np.array([1, 4, 2, 1, 1, 1, 1, 1, 1, 1, 1], dtype=np.int8)
    col_b = np.array([2, 1, 2, 3, 1, 0, 2, 3, 2, 3, 3], dtype=np.int8)
    assert _pair_has_count_tie(col_a, col_b)
    aln = np.stack([col_a, col_b], axis=1)
    w = np.ones(11, dtype=np.float64)

    expected = _ref_ld_rows(ref, aln, w, np.arange(2))
    assert (0, 1) in expected
    d_ref, dp_ref, r2_ref = expected[(0, 1)]

    rec = extract_records(
        ld_all_pairs_dense(jnp.asarray(aln), jnp.asarray(w, jnp.float32)),
        np.arange(2),
    )
    assert len(rec.pos_a) == 1
    np.testing.assert_allclose(abs(float(rec.d[0])), abs(d_ref), atol=2e-4)
    np.testing.assert_allclose(float(rec.d_prime[0]), dp_ref, atol=5e-4)
    np.testing.assert_allclose(float(rec.r2[0]), r2_ref, atol=5e-4)


def test_vcf_info_pipe_crashes_reference_we_parse(ref, tmp_path):
    # INFO fields containing digit|digit (e.g. allele-specific annotations
    # like 'AF=1|2') survive the reference's pipe-cleanup regexes
    # (WeightedLD.py:350-353 delete only [^0-9]|[^0-9]), so its '|'->tab
    # split shifts the column indexing and int('GT') raises ValueError —
    # the reference defines no output for such files.  The column-wise
    # reader parses them correctly (io/vcf.py 'Extensions').
    from weightedld.io.vcf import read_vcf

    hdr = ("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t"
           + "\t".join(f"s{i}" for i in range(14)))
    gts = "\t".join(["0|1"] * 14)
    body = "\n".join([
        "##x", hdr,
        f"1\t7\trs\tA\tT\t100\tPASS\tAF=1|2\tGT\t{gts}",
        f"1\t9\trs\tA\tT\t100\tPASS\tAF=1|2\tGT\t{gts}",
        "",
    ])
    f = tmp_path / "info_pipe.vcf"
    f.write_text(body)

    with pytest.raises(ValueError):
        ref.handle_vcf(str(f))

    aln, sm = read_vcf(f)
    assert aln.shape == (28, 2) and sm.tolist() == [7, 9]
    assert set(np.unique(aln)) <= {0, 1}


@pytest.mark.parametrize("seed,n_seqs,n_sites,window", [
    (501, 40, 36, 12), (502, 28, 44, 16), (503, 60, 30, 10),
])
def test_windowed_packed_session_matches_reference(ref, seed, n_seqs,
                                                   n_sites, window):
    """Round-5 windowed unsafe-site packing vs the EXECUTED reference:
    the packed windowed session's records must equal the reference's full
    all-pairs output restricted to kept-index distance <= window (the
    window semantics), with the usual count-tie exclusion."""
    from weightedld.core.henikoff import henikoff_weights
    from weightedld.core.sites import compute_variable_sites_host
    from weightedld.runtime.driver import DriverConfig, LdSession

    rng = np.random.default_rng(seed)
    aln = random_alignment(rng, n_seqs, n_sites, p_gap=0.05, p_unknown=0.0)
    # Sparse scattered dirt: few enough sites that the packing gate
    # (2 * n_dirty <= window) passes.
    for s in rng.choice(n_sites, size=3, replace=False):
        aln[rng.integers(n_seqs), s] = 5

    hk_r, ld_r = ref.compute_variable_sites(aln, 0.8, 0.02)
    trimmed = aln[:, ld_r]
    if trimmed.shape[1] < 4:
        pytest.skip("degenerate draw: <4 LD sites")
    w_r = ref.henikoff_weighting(trimmed)
    site_map = np.where(ld_r)[0]
    expected_full = _ref_ld_rows(ref, trimmed, w_r, site_map)
    pos_to_col = {int(p): i for i, p in enumerate(site_map)}
    expected = {k: v for k, v in expected_full.items()
                if pos_to_col[k[1]] - pos_to_col[k[0]] <= window}

    ses = LdSession(trimmed, np.asarray(w_r, np.float32), site_map,
                    DriverConfig(tile=8, seq_chunk=16, r2_threshold=None,
                                 max_site_distance=window))
    dirty_kept = int(((trimmed == 5).any(axis=0)).sum())
    if dirty_kept:
        assert ses._windowed_packed, "packing did not engage"
    got = {}
    for _, rec in ses.stream():
        for a, b, d, dp, r2 in zip(rec.pos_a, rec.pos_b, rec.d,
                                   rec.d_prime, rec.r2):
            got[(int(a), int(b))] = (float(d), float(dp), float(r2))

    tie = {key for key in set(got) | set(expected)
           if _pair_has_count_tie(trimmed[:, pos_to_col[key[0]]],
                                  trimmed[:, pos_to_col[key[1]]])}
    assert set(got) - tie == set(expected) - tie
    for key, (d, dp, r2) in expected.items():
        if key in tie:
            continue
        gd, gdp, gr2 = got[key]
        np.testing.assert_allclose(gd, d, atol=2e-4, err_msg=f"D {key}")
        if np.isfinite(dp) and np.isfinite(gdp):
            np.testing.assert_allclose(gdp, dp, atol=5e-4,
                                       err_msg=f"D' {key}")
        np.testing.assert_allclose(gr2, r2, atol=5e-4, err_msg=f"r2 {key}")
