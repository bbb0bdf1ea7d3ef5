"""End-to-end pipeline parity: full FASTA/VCF runs vs golden TSV rows."""

import io
import os

import numpy as np
import pytest

from weightedld.io.writer import PAIR_HEADER, write_pairs
from weightedld.pipeline import WldConfig, run

from .fixtures import (
    ALL_FASTAS,
    GOLDEN,
    T7_GOLDEN,
    T7_PATH,
    synthetic_t7_path,
    write_fasta,
)


@pytest.mark.parametrize("name", ["example", "t3", "t4"])
def test_end_to_end_fasta(tmp_path, name):
    path = tmp_path / f"{name}.fasta"
    write_fasta(path, ALL_FASTAS[name])
    res = run(path)
    got = {
        (int(a), int(b)): (round(float(d), 4), round(float(dp), 4), round(float(r2), 4))
        for a, b, d, dp, r2 in zip(
            res.records.pos_a, res.records.pos_b,
            res.records.d, res.records.d_prime, res.records.r2,
        )
    }
    exp = {(a, b): (d, dp, r2) for a, b, d, dp, r2 in GOLDEN[name]["pairs"]}
    assert set(got) == set(exp)
    for k in exp:
        np.testing.assert_allclose(got[k], exp[k], atol=2e-4)


def test_unweighted_flag(tmp_path):
    path = tmp_path / "t5.fasta"
    write_fasta(path, ALL_FASTAS["t5"])
    res = run(path, WldConfig(unweighted=True))
    assert (res.weights == 1.0).all()
    # t5 is flat-weight by design, so results match the weighted run.
    assert round(float(res.records.d[0]), 4) == -0.25


def test_writer_format(tmp_path):
    path = tmp_path / "t5.fasta"
    write_fasta(path, ALL_FASTAS["t5"])
    res = run(path)
    buf = io.StringIO()
    write_pairs(res.records, buf)
    lines = buf.getvalue().strip().split("\n")
    assert lines[0] == PAIR_HEADER
    assert lines[1].split("\t")[:2] == ["0", "1"]
    # Python round()-style shortest repr: "-0.25", not "-0.2500".
    assert lines[1].split("\t")[2] == "-0.25"


@pytest.mark.skipif(not os.path.exists(T7_PATH), reason="reference fixture absent")
def test_end_to_end_t7_vcf():
    res = run(T7_PATH)
    got = {
        (int(a), int(b)): (round(float(d), 4), round(float(dp), 4), round(float(r2), 4))
        for a, b, d, dp, r2 in zip(
            res.records.pos_a, res.records.pos_b,
            res.records.d, res.records.d_prime, res.records.r2,
        )
    }
    exp = {(a, b): (d, dp, r2) for a, b, d, dp, r2 in T7_GOLDEN["pairs"]}
    assert set(got) == set(exp)
    for k in exp:
        np.testing.assert_allclose(got[k], exp[k], atol=2e-4)


# ---------------------------------------------------------------------------
# Sample subsetting + region (capabilities beyond the reference): the subset
# pipeline must equal running the full pipeline machinery on a pre-sliced
# alignment (subsetting happens BEFORE masking and weighting).


def test_fasta_keep_exclude_equals_row_slice(tmp_path):
    from weightedld.core.henikoff import henikoff_weights_host
    from weightedld.core.sites import compute_variable_sites_host
    from weightedld.io.fasta import read_fasta_with_names
    from weightedld.pipeline import prepare

    path = tmp_path / "e.fasta"
    write_fasta(path, ["ATAA", "TAAA", "TAAA", "TAAA", "T-AA",
                       "TTAA", "TTAA", "TTAA", "TTAA", "TTAY"])
    al, names = read_fasta_with_names(path)
    assert names == [f"seq{i}" for i in range(10)]

    res = prepare(path, WldConfig(keep_samples=tuple(names[2:9]),
                                  exclude_samples=(names[3],)))
    rows = [2, 4, 5, 6, 7, 8]
    sub = al[rows]
    hk, ld = compute_variable_sites_host(sub, 0.8, 0.02, 1.0)
    np.testing.assert_array_equal(res.alignment, sub[:, ld])
    np.testing.assert_allclose(res.weights, henikoff_weights_host(sub[:, ld]))


def test_vcf_keep_samples_row_mapping():
    from weightedld.io.vcf import read_vcf, vcf_sample_names
    from weightedld.pipeline import prepare

    full, _ = read_vcf(synthetic_t7_path())
    names = vcf_sample_names(synthetic_t7_path())
    res = prepare(synthetic_t7_path(), WldConfig(keep_samples=tuple(names[:5])))
    # Alignment row k belongs to sample (n_haps-1-k)//2 (rot90 order):
    # the first 5 samples are the LAST 10 rows.
    n = full.shape[0]
    rows = [k for k in range(n) if (n - 1 - k) // 2 < 5]
    assert res.alignment.shape[0] == 10
    np.testing.assert_array_equal(res.alignment, full[rows])


def test_subset_errors():
    from weightedld.pipeline import prepare

    with pytest.raises(ValueError, match="unknown sample name"):
        prepare(synthetic_t7_path(), WldConfig(keep_samples=("NOPE1", "HG00096")))
    with pytest.raises(ValueError, match="fewer than 2"):
        prepare(synthetic_t7_path(), WldConfig(keep_samples=("HG00096",),
                                   exclude_samples=("HG00096",)))
    with pytest.raises(ValueError, match="mutually exclusive"):
        prepare(synthetic_t7_path(), WldConfig(chrom="19", region="19:1-2"))


def test_region_fasta_rejected(tmp_path):
    from weightedld.pipeline import prepare, site_stats

    path = tmp_path / "e.fasta"
    write_fasta(path, ["ATAA", "TAAA", "TTAA", "TTAA"])
    with pytest.raises(ValueError, match="region only applies to VCF"):
        prepare(path, WldConfig(region="chr1:1-2"))
    with pytest.raises(ValueError, match="region only applies to VCF"):
        site_stats(path, WldConfig(region="chr1:1-2"))


def test_region_pipeline_and_site_stats():
    from weightedld.io.vcf import read_vcf
    from weightedld.pipeline import prepare, site_stats

    lo, hi = 44890100, 44890180
    full, sm = read_vcf(synthetic_t7_path())
    sel = (sm >= lo) & (sm <= hi)
    res = prepare(synthetic_t7_path(), WldConfig(region=f"19:{lo}-{hi}"))
    assert res.site_map.tolist() == sm[sel].tolist()
    np.testing.assert_array_equal(res.alignment, full[:, sel])
    # Weights recomputed on the region slice (not sliced from full weights).
    from weightedld.core.henikoff import henikoff_weights_host

    np.testing.assert_allclose(res.weights,
                               henikoff_weights_host(full[:, sel]))
    stats = site_stats(synthetic_t7_path(), WldConfig(region=f"19:{lo}-{hi}"))
    assert stats["site"].tolist() == sm[sel].tolist()


def test_site_stats_respects_sample_subset(tmp_path):
    from weightedld.pipeline import site_stats

    path = tmp_path / "e.fasta"
    write_fasta(path, ["AAAA", "AAAA", "ATAA", "ATAA"])
    full = site_stats(path, WldConfig())
    sub = site_stats(path, WldConfig(keep_samples=("seq0", "seq1", "seq2")))
    # Site 1 minor fraction: 2/4 full, 1/3 after dropping one T-carrier.
    assert full["minor_fraction"][1] == pytest.approx(0.5)
    assert sub["minor_fraction"][1] == pytest.approx(1 / 3)


def test_rust_reader_subsetting(tmp_path):
    from weightedld.io.fasta import read_fasta_rust_with_names
    from weightedld.pipeline import prepare

    path = tmp_path / "e.fasta"
    path.write_text(">a\nACGT\n>b\nACGA\n>c\nACGA\n>d\nTCGA\n")
    al, names = read_fasta_rust_with_names(path)
    assert names == ["a", "b", "c", "d"]
    res = prepare(path, WldConfig(fasta_reader="rust",
                                  exclude_samples=("a",)))
    assert res.alignment.shape[0] == 3


def test_haploid_vcf_sample_subsetting(tmp_path):
    """Haploid records (one GT allele per sample): row k maps to sample
    n_haps-1-k — the second _vcf_row_names branch."""
    from weightedld.io.vcf import read_vcf
    from weightedld.pipeline import prepare

    names = [f"h{i}" for i in range(14)]
    header = ("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t"
              + "\t".join(names))
    gts1 = "\t".join(["0"] * 7 + ["1"] * 7)
    gts2 = "\t".join(["1"] * 7 + ["0"] * 7)
    f = tmp_path / "hap.vcf"
    f.write_text(header + f"\nchrX\t100\t.\tA\tT\t.\t.\t.\tGT\t{gts1}"
                 + f"\nchrX\t200\t.\tA\tT\t.\t.\t.\tGT\t{gts2}\n")
    full, _ = read_vcf(f)
    assert full.shape == (14, 2)
    res = prepare(f, WldConfig(keep_samples=("h0", "h1", "h13")))
    # rot90 order: alignment row k is sample 13-k -> kept rows 0, 12, 13.
    np.testing.assert_array_equal(res.alignment, full[[0, 12, 13]])


def test_mixed_ploidy_subsetting_rejected(tmp_path):
    from weightedld.pipeline import prepare

    names = [f"m{i}" for i in range(13)]
    header = ("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t"
              + "\t".join(names))
    # 12 diploid + 1 haploid sample -> 25 haplotypes: no consistent map.
    gts = "\t".join(["0|1"] * 12 + ["1"])
    f = tmp_path / "mixed.vcf"
    f.write_text(header + f"\n1\t100\t.\tA\tT\t.\t.\t.\tGT\t{gts}"
                 + f"\n1\t200\t.\tA\tT\t.\t.\t.\tGT\t{gts}\n")
    with pytest.raises(ValueError, match="mixed ploidy"):
        prepare(f, WldConfig(keep_samples=("m0",)))
    # Without subsetting the same file is fine (reference semantics).
    res = prepare(f, WldConfig())
    assert res.alignment.shape[0] == 25


@pytest.mark.parametrize("seed", [3, 9])
def test_region_subset_window_composition(tmp_path, seed):
    """Interaction coverage: --region + --keep-samples + --max-distance-bp
    together must equal manually slicing the full matrix and running the
    dense engine on the slice with the same window filter."""
    import jax.numpy as jnp

    from weightedld.core.henikoff import henikoff_weights_host
    from weightedld.core.ld_dense import (
        extract_records,
        ld_all_pairs_dense,
    )
    from weightedld.io.vcf import read_vcf
    from weightedld.pipeline import prepare
    from weightedld.runtime.driver import DriverConfig, collect_ld_records

    rng = np.random.default_rng(seed)
    n_samp = 14
    names = [f"s{i}" for i in range(n_samp)]
    header = ("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t"
              + "\t".join(names))
    rows = []
    pos = 100
    for i in range(30):
        pos += int(rng.integers(5, 60))
        gts = "\t".join(f"{rng.integers(0, 2)}|{rng.integers(0, 2)}"
                        for _ in range(n_samp))
        rows.append(f"chr3\t{pos}\trs{i}\tA\tT\t.\t.\t.\tGT\t{gts}")
    f = tmp_path / "c.vcf"
    f.write_text(header + "\n" + "\n".join(rows) + "\n")

    keep = tuple(names[:9])
    lo, hi = 150, pos - 40
    res = prepare(f, WldConfig(region=f"chr3:{lo}-{hi}", keep_samples=keep))

    # Oracle: full read -> manual column+row slice -> dense engine.
    full, sm = read_vcf(f)
    col = (sm >= lo) & (sm <= hi)
    n = full.shape[0]
    rows_keep = [k for k in range(n) if (n - 1 - k) // 2 < 9]
    sub = full[np.ix_(rows_keep, np.flatnonzero(col))]
    w = henikoff_weights_host(sub)
    np.testing.assert_array_equal(res.alignment, sub)
    np.testing.assert_allclose(res.weights, w)

    W = 120
    stats = ld_all_pairs_dense(jnp.asarray(sub), jnp.asarray(w))
    oracle = extract_records(stats, sm[col], None)
    om = (np.asarray(oracle.pos_b) - np.asarray(oracle.pos_a)) <= W
    want = sorted(zip(np.asarray(oracle.pos_a)[om].tolist(),
                      np.asarray(oracle.pos_b)[om].tolist(),
                      np.round(np.asarray(oracle.r2)[om], 5).tolist()))

    rec = collect_ld_records(res.alignment, res.weights, res.site_map,
                             DriverConfig(engine="xla", tile=8,
                                          max_bp_distance=W))
    got = sorted(zip(rec.pos_a.tolist(), rec.pos_b.tolist(),
                     np.round(rec.r2, 5).tolist()))
    assert len(got) == len(want) > 0
    for g, o in zip(got, want):
        assert g[:2] == o[:2] and abs(g[2] - o[2]) < 1e-4, (g, o)
