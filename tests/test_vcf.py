"""VCF ingestion parity (ref WeightedLD.py:311-379, SURVEY.md A.8)."""

import os

import jax.numpy as jnp
import numpy as np
import pytest

from weightedld.core.henikoff import henikoff_weights
from weightedld.io.vcf import VcfError, read_vcf

from .fixtures import (
    SYN7_IDS,
    SYN7_SAMPLES,
    T7_GOLDEN,
    T7_PATH,
    synthetic_t7_path,
)

SAMPLES = 16

HEADER = (
    "##fileformat=VCFv4.1\n"
    "##contig=<ID=1>\n"
    "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t"
    + "\t".join(f"s{i}" for i in range(SAMPLES))
)


def _mk_vcf(tmp_path, rows):
    path = tmp_path / "x.vcf"
    path.write_text(HEADER + "\n" + "\n".join(rows) + "\n")
    return path


def _row(pos, gts):
    return f"1\t{pos}\trs{pos}\tA\tT\t100\tPASS\t.\tGT\t" + "\t".join(gts)


def test_basic_phased(tmp_path):
    gts = ["0|1"] * 8 + ["1|1"] * 4 + ["0|0"] * 4
    path = _mk_vcf(tmp_path, [_row(1000, gts), _row(2000, list(reversed(gts)))])
    aln, site_map = read_vcf(path)
    assert aln.shape == (2 * SAMPLES, 2)
    assert site_map.tolist() == [1000, 2000]
    # rot90 parity: first row is the LAST haplotype (sample 15, second allele).
    assert aln[0, 0] == 0 and aln[-1, 0] == 0
    assert int((aln[:, 0] == 1).sum()) == 8 + 8  # eight 0|1 + four 1|1


def test_unphased_becomes_missing(tmp_path):
    gts = ["0/1"] * SAMPLES
    path = _mk_vcf(tmp_path, [_row(5, gts)])
    aln, _ = read_vcf(path)
    assert (aln == 4).all()  # WeightedLD.py:355


def test_half_call_keeps_known_allele(tmp_path):
    gts = [".|1"] * SAMPLES
    path = _mk_vcf(tmp_path, [_row(5, gts)])
    aln, _ = read_vcf(path)
    assert int((aln == 4).sum()) == SAMPLES
    assert int((aln == 1).sum()) == SAMPLES


def test_format_subfields_ignored(tmp_path):
    gts = ["0|1:35:99"] * SAMPLES
    path = _mk_vcf(tmp_path, [_row(5, gts)])
    aln, _ = read_vcf(path)
    assert int((aln == 1).sum()) == SAMPLES


def test_large_positions_no_overflow(tmp_path):
    # The reference crashes here on numpy >= 1.24 (uint8 overflow on POS,
    # WeightedLD.py:372); we parse POS separately.
    gts = ["0|1"] * SAMPLES
    path = _mk_vcf(tmp_path, [_row(44890030, gts)])
    _, site_map = read_vcf(path)
    assert site_map.tolist() == [44890030]


def test_no_header_rejected(tmp_path):
    path = tmp_path / "bad.vcf"
    path.write_text("1\t5\t.\tA\tT\t.\t.\t.\tGT\t0|1\n")
    with pytest.raises(VcfError, match="#CHROM"):
        read_vcf(path)


def test_too_few_samples_rejected(tmp_path):
    path = tmp_path / "small.vcf"
    path.write_text(
        "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\ts0\n"
        "1\t5\t.\tA\tT\t.\t.\t.\tGT\t0|1\n"
    )
    with pytest.raises(VcfError, match="multi-sample"):
        read_vcf(path)


@pytest.mark.skipif(not os.path.exists(T7_PATH), reason="reference fixture absent")
class TestT7:
    def test_shape_and_sitemap(self):
        aln, site_map = read_vcf(T7_PATH)
        assert aln.shape == T7_GOLDEN["shape"]
        assert site_map.tolist() == T7_GOLDEN["site_map"]
        assert set(np.unique(aln)).issubset({0, 1})

    def test_weights(self):
        aln, _ = read_vcf(T7_PATH)
        w = np.asarray(henikoff_weights(jnp.asarray(aln)))
        # Dead reference test t7 assertion: mean rounds to 0.002 (test.py:159).
        assert round(float(w.mean()), 3) == T7_GOLDEN["weights_mean"]
        assert w.max() == pytest.approx(T7_GOLDEN["weights_max"])
        assert round(float(w.min()), 5) == pytest.approx(T7_GOLDEN["weights_min"], abs=1e-5)


def test_allele_out_of_alphabet_rejected(tmp_path):
    # ALT6+ would alias arbitrary codes and silently corrupt weights
    # (the reference crashes with IndexError); we fail fast.
    gts = ["0|6"] + ["0|1"] * (SAMPLES - 1)
    path = _mk_vcf(tmp_path, [_row(5, gts)])
    with pytest.raises(VcfError, match="allele index 6"):
        read_vcf(path)


def test_chrom_filter(tmp_path):
    from weightedld.io.vcf import VcfError, read_vcf

    header = ("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t"
              + "\t".join(f"s{i}" for i in range(14)))
    gts = "\t".join(["0|1"] * 14)
    body = "\n".join([
        header,
        f"chr1\t100\t.\tA\tT\t.\t.\t.\tGT\t{gts}",
        f"chr1\t200\t.\tA\tT\t.\t.\t.\tGT\t{gts}",
        f"chr2\t50\t.\tA\tT\t.\t.\t.\tGT\t{gts}",   # POS resets!
        f"chr2\t150\t.\tA\tT\t.\t.\t.\tGT\t{gts}",
        "",  # trailing line (the reference drops the last line)
    ])
    f = tmp_path / "wg.vcf"
    f.write_text(body)

    # Unfiltered: reference semantics — CHROM ignored, POS axis mixed.
    aln, sm = read_vcf(f)
    assert sm.tolist() == [100, 200, 50, 150]
    # Filtered: one chromosome, monotonic positions.
    aln1, sm1 = read_vcf(f, chrom="chr1")
    assert sm1.tolist() == [100, 200]
    assert aln1.shape == (28, 2)
    aln2, sm2 = read_vcf(f, chrom="chr2")
    assert sm2.tolist() == [50, 150]
    with pytest.raises(VcfError, match="chr9"):
        read_vcf(f, chrom="chr9")


def test_list_chromosomes(tmp_path, capsys):
    from weightedld.cli import main
    from weightedld.io.vcf import list_chromosomes

    header = ("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t"
              + "\t".join(f"s{i}" for i in range(14)))
    gts = "\t".join(["0|1"] * 14)
    body = "\n".join([
        header,
        f"chr2\t100\t.\tA\tT\t.\t.\t.\tGT\t{gts}",   # first-appearance order,
        f"chr1\t200\t.\tA\tT\t.\t.\t.\tGT\t{gts}",   # not sorted
        f"chr2\t300\t.\tA\tT\t.\t.\t.\tGT\t{gts}",
        f"chr3\t50\t.\tA\tT\t.\t.\t.\tGT\t{gts}",    # ONLY on the last line
    ])  # no trailing newline: the reference's line-drop quirk eats chr3
    f = tmp_path / "wg.vcf"
    f.write_text(body)
    # chr3's only record falls to the reference's trailing-line drop: it
    # must NOT be listed (read_vcf(chrom="chr3") would raise).
    assert list_chromosomes(f) == ["chr2", "chr1"]
    # t7-shaped fixture: single chromosome.
    assert list_chromosomes(synthetic_t7_path()) == ["19"]

    # CLI query mode: prints one CHROM per line, runs no analysis.
    assert main(["--file", str(f), "--list-chroms"]) == 0
    assert capsys.readouterr().out.splitlines() == ["chr2", "chr1"]
    # FASTA input refused.
    fa = tmp_path / "x.fasta"
    fa.write_text(">a\nACGT\n")
    assert main(["--file", str(fa), "--list-chroms"]) == 2
    assert "VCF" in capsys.readouterr().err


def test_chrom_flag_cli(tmp_path, capsys):
    from weightedld.cli import main

    header = ("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t"
              + "\t".join(f"s{i}" for i in range(14)))
    # Deterministic polymorphic GT pattern -> every within-chromosome pair
    # survives at r2 == 1.0 (identical columns).
    gts = "\t".join(["0|1"] * 7 + ["1|0"] * 7)
    rows = []
    for chrom, pos0 in (("chr1", 100), ("chr2", 10)):
        for k in range(4):
            rows.append(f"{chrom}\t{pos0 + 37 * k}\t.\tA\tT\t.\t.\t.\tGT\t{gts}")
    f = tmp_path / "wg.vcf"
    f.write_text(header + "\n" + "\n".join(rows) + "\n")

    # Whole-genome decay refuses (POS resets mid-file)...
    assert main(["--file", str(f), "--ld-decay", "0,50,200"]) == 2
    capsys.readouterr()
    # ...but per-chromosome decay works.  chr1 sites sit at 100/137/174/211,
    # so pair distances are 37 x3 and 74 x2, 111 x1: bins split 3/3.
    rc = main(["--file", str(f), "--chrom", "chr1", "--ld-decay", "0,50,200"])
    out = capsys.readouterr().out
    assert rc == 0
    import json as _json

    decay = _json.loads(out.strip().splitlines()[-1])
    assert decay["n_pairs"] == [3, 3]
    assert decay["r2_mean"] == [pytest.approx(1.0, abs=1e-5)] * 2
    # --chrom is VCF-only.
    assert main(["--file", str(f), "--chrom", "chr1"]) == 0
    capsys.readouterr()
    fa = tmp_path / "x.fasta"
    fa.write_text(">a\nACGT\n>b\nACGA\n")
    assert main(["--file", str(fa), "--chrom", "chr1"]) == 2


# ---------------------------------------------------------------------------
# Region filtering + sample identity (capabilities beyond the reference).


def test_parse_region_forms():
    from weightedld.io.vcf import parse_region

    assert parse_region("chr19") == ("chr19", None)
    assert parse_region("19:100-200") == ("19", (100, 200))
    assert parse_region("chr1:0-0") == ("chr1", (0, 0))
    # A range needs a full numeric START-END tail; anything else is a name.
    assert parse_region("HLA-A*01:01") == ("HLA-A*01:01", None)
    assert parse_region("19:150") == ("19:150", None)
    with pytest.raises(VcfError):
        parse_region(":100-200")
    with pytest.raises(VcfError):
        parse_region("19:200-100")


def test_read_vcf_pos_range_is_a_column_slice():
    full, sm = read_vcf(synthetic_t7_path())
    lo, hi = 44890100, 44890180
    sub, sm_sub = read_vcf(synthetic_t7_path(), pos_range=(lo, hi))
    sel = (sm >= lo) & (sm <= hi)
    assert sm_sub.tolist() == sm[sel].tolist()
    np.testing.assert_array_equal(sub, full[:, sel])
    # Composes with the chrom filter.
    both, sm_both = read_vcf(synthetic_t7_path(), chrom="19", pos_range=(lo, hi))
    np.testing.assert_array_equal(both, sub)


def test_pos_range_no_records_is_clean_error():
    with pytest.raises(VcfError, match="POS range 1-2"):
        read_vcf(synthetic_t7_path(), pos_range=(1, 2))
    from weightedld.io.vcf import scan_vcf

    with pytest.raises(VcfError, match="POS range 1-2"):
        scan_vcf(synthetic_t7_path(), pos_range=(1, 2))


def test_scan_and_site_major_respect_pos_range():
    from weightedld.io.vcf import read_vcf_site_major, scan_vcf

    lo, hi = 44890100, 44890180
    n_haps, sm = scan_vcf(synthetic_t7_path(), pos_range=(lo, hi))
    assert n_haps == 2 * SYN7_SAMPLES
    assert sm.tolist() == [44890114, 44890164, 44890171]
    codes, sm2, n2 = read_vcf_site_major(synthetic_t7_path(), pos_range=(lo, hi))
    assert n2 == n_haps and sm2.tolist() == sm.tolist()
    row_major, _ = read_vcf(synthetic_t7_path(), pos_range=(lo, hi))
    # codes[s, k] == alignment[k, s] (the rot90 reversal is baked into the
    # site-major column order — read_vcf_site_major docstring).
    np.testing.assert_array_equal(codes.T, row_major)


def test_vcf_sample_names_t7():
    from weightedld.io.vcf import vcf_sample_names

    names = vcf_sample_names(synthetic_t7_path())
    assert len(names) == SYN7_SAMPLES
    assert names[0] == "HG00096" and names[-1] == "HG00159"


def test_vcf_sample_names_errors(tmp_path):
    from weightedld.io.vcf import vcf_sample_names

    f = tmp_path / "nohdr.vcf"
    f.write_text("##fileformat=VCFv4.1\n")
    with pytest.raises(VcfError, match="#CHROM"):
        vcf_sample_names(f)
    f2 = tmp_path / "nosamp.vcf"
    f2.write_text("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\n")
    with pytest.raises(VcfError, match="no sample columns"):
        vcf_sample_names(f2)


def test_site_annotations_alignment_with_site_map():
    from weightedld.io.vcf import read_vcf, site_annotations

    pos, chroms, ids = site_annotations(synthetic_t7_path())
    _, sm = read_vcf(synthetic_t7_path())
    assert pos.tolist() == sm.tolist()
    assert chroms == ["19"] * 5
    assert ids == SYN7_IDS
    # Filters keep the annotation set aligned with the filtered readers.
    pos2, _, ids2 = site_annotations(synthetic_t7_path(), chrom="19",
                                     pos_range=(44890100, 44890180))
    assert pos2.tolist() == [44890114, 44890164, 44890171]
    assert ids2[0] == "rs73934845"
    with pytest.raises(VcfError, match="no variant records"):
        site_annotations(synthetic_t7_path(), chrom="nope")


def test_parse_region_open_ends_and_commas():
    from weightedld.io.vcf import parse_region

    assert parse_region("chr1:44,890,000-44,890,200") == \
        ("chr1", (44890000, 44890200))
    c, (lo, hi) = parse_region("chr1:100-")
    assert c == "chr1" and lo == 100 and hi >= (1 << 61)
    assert parse_region("chr1:-200") == ("chr1", (0, 200))
