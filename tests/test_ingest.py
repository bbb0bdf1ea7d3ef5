"""Streaming VCF ingest: the two-pass site-major reader must be a drop-in
replacement for the row-list reader (same record set, same codes, rot90
parity — ref ``WeightedLD.py:311-379``) with bounded host memory, and the
end-to-end session must emit identical LD records."""

import gzip

import numpy as np
import pytest

from weightedld.core.encode import UNKNOWN
from weightedld.core.henikoff import (
    henikoff_weights_host,
    henikoff_weights_host_site_major,
)
from weightedld.core.sites import (
    site_histogram_host,
    site_histogram_host_site_major,
)
from weightedld.io.vcf import (
    read_vcf,
    read_vcf_python,
    read_vcf_site_major,
    scan_vcf,
)
from weightedld.runtime.driver import DriverConfig, LdSession, SiteMajorCodes
from weightedld.runtime.ingest import prepare_vcf_streamed, session_from_vcf

from .fixtures import ALL_FASTAS, synthetic_t7_path, write_fasta

SAMPLES = 12

HEADER = (
    "##fileformat=VCFv4.1\n"
    "##contig=<ID=1>\n"
    "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t"
    + "\t".join(f"s{i}" for i in range(SAMPLES))
)


def _mk_vcf(tmp_path, rows, name="x.vcf", trailing_newline=True):
    path = tmp_path / name
    body = HEADER + "\n" + "\n".join(rows)
    if trailing_newline:
        body += "\n"
    path.write_text(body)
    return path


def _random_rows(rng, n_records, chrom="1", start=100):
    rows = []
    for i in range(n_records):
        gts = []
        for _ in range(SAMPLES):
            if rng.random() < 0.1:
                gts.append(".|.")
            elif rng.random() < 0.1:
                gts.append(f"{rng.integers(0, 2)}/{rng.integers(0, 2)}")
            else:
                gts.append(f"{rng.integers(0, 3)}|{rng.integers(0, 3)}")
        rows.append(
            f"{chrom}\t{start + 7 * i}\trs{i}\tA\tT,G\t100\tPASS\t.\tGT\t"
            + "\t".join(gts)
        )
    return rows


def _assert_streamed_matches(path, chrom=None, s_pad=None, n_pad=None):
    aln, sm = read_vcf(path, chrom=chrom)
    codes, sm2, n_haps = read_vcf_site_major(
        path, chrom=chrom, s_pad=s_pad, n_pad=n_pad
    )
    np.testing.assert_array_equal(sm, sm2)
    assert n_haps == aln.shape[0]
    s = len(sm)
    # Contract: codes[s, k] == alignment[k, s] (rot90 order folded in).
    np.testing.assert_array_equal(codes[:s, :n_haps], aln.T)
    # Padding is UNKNOWN everywhere past the valid region.
    assert (codes[s:] == UNKNOWN).all()
    assert (codes[:, n_haps:] == UNKNOWN).all()
    return codes, sm2, n_haps


def test_site_major_matches_row_list_random(tmp_path):
    rng = np.random.default_rng(7)
    path = _mk_vcf(tmp_path, _random_rows(rng, 23))
    _assert_streamed_matches(path, s_pad=32, n_pad=64)


def test_site_major_t7_fixture():
    _assert_streamed_matches(synthetic_t7_path())


def test_trailing_line_quirk_matches(tmp_path):
    """A file WITHOUT a trailing newline silently drops its last record in
    the reference (WeightedLD.py:365); both readers must agree."""
    rng = np.random.default_rng(8)
    rows = _random_rows(rng, 6)
    with_nl = _mk_vcf(tmp_path, rows, name="a.vcf", trailing_newline=True)
    without_nl = _mk_vcf(tmp_path, rows, name="b.vcf",
                         trailing_newline=False)
    _, sm_with = read_vcf(with_nl)
    _, sm_without = read_vcf(without_nl)
    assert len(sm_with) == 6 and len(sm_without) == 5
    _assert_streamed_matches(with_nl)
    _assert_streamed_matches(without_nl)


def test_gzip_streamed_identical(tmp_path):
    rng = np.random.default_rng(9)
    path = _mk_vcf(tmp_path, _random_rows(rng, 17))
    gz = tmp_path / "x.vcf.gz"
    gz.write_bytes(gzip.compress(path.read_bytes()))
    a = read_vcf_site_major(path)
    b = read_vcf_site_major(gz)
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])


def test_chrom_filter_streamed(tmp_path):
    rng = np.random.default_rng(10)
    rows = _random_rows(rng, 8, chrom="1") + _random_rows(
        rng, 5, chrom="2", start=900
    )
    path = _mk_vcf(tmp_path, rows)
    _assert_streamed_matches(path, chrom="2")


def test_scan_vcf_matches_reader(tmp_path):
    rng = np.random.default_rng(11)
    path = _mk_vcf(tmp_path, _random_rows(rng, 9))
    n_haps, sm = scan_vcf(path)
    aln, sm2 = read_vcf_python(path)
    assert n_haps == aln.shape[0]
    np.testing.assert_array_equal(sm, sm2)


def test_padding_too_small_rejected(tmp_path):
    rng = np.random.default_rng(12)
    path = _mk_vcf(tmp_path, _random_rows(rng, 9))
    with pytest.raises(ValueError, match="padding smaller"):
        read_vcf_site_major(path, s_pad=4)


def test_site_histogram_site_major_matches(tmp_path):
    rng = np.random.default_rng(13)
    path = _mk_vcf(tmp_path, _random_rows(rng, 15))
    aln, sm = read_vcf(path)
    codes, _, n = read_vcf_site_major(path, s_pad=64, n_pad=48)
    a = site_histogram_host(aln)
    b = site_histogram_host_site_major(codes, len(sm), n, row_chunk=4)
    np.testing.assert_array_equal(a, b)


def test_henikoff_site_major_f64_close(tmp_path):
    rng = np.random.default_rng(14)
    path = _mk_vcf(tmp_path, _random_rows(rng, 40))
    aln, sm = read_vcf(path)
    codes, _, n = read_vcf_site_major(path, s_pad=64, n_pad=32)
    w_ref = henikoff_weights_host(aln)
    w_sm = henikoff_weights_host_site_major(codes, len(sm), n, row_chunk=7)
    # Same f64 arithmetic; only the summation grouping differs (chunked).
    np.testing.assert_allclose(w_sm, w_ref, rtol=1e-12)
    # Identical at the 6-dp weights-TSV floor.
    assert [round(float(x), 6) for x in w_sm] == [
        round(float(x), 6) for x in w_ref
    ]


def _records_map(rec):
    return {
        (int(a), int(b)): (float(d), float(dp), float(r2))
        for a, b, d, dp, r2 in zip(
            rec.pos_a, rec.pos_b, rec.d, rec.d_prime, rec.r2
        )
    }


def test_session_from_vcf_matches_standard_path():
    """End-to-end: the streamed session's records equal the standard
    (row-list ingest + f64 weights) tiled session's on the t7-shaped VCF."""
    import weightedld as wld

    vcf = synthetic_t7_path()
    cfg = DriverConfig(tile=8, seq_chunk=8)
    res = wld.prepare(vcf)
    ses_std = LdSession(res.alignment, res.weights, res.site_map, cfg)
    std = [r for _, r in ses_std.stream()]

    ses_stream = session_from_vcf(vcf, cfg=cfg)
    got = [r for _, r in ses_stream.stream()]

    m_std = {}
    for r in std:
        m_std.update(_records_map(r))
    m_got = {}
    for r in got:
        m_got.update(_records_map(r))
    assert set(m_got) == set(m_std) and len(m_std) == 10
    for k in m_std:
        np.testing.assert_allclose(m_got[k], m_std[k], rtol=0, atol=2e-7)
    # Weights agree to f64-summation-order noise.
    np.testing.assert_allclose(ses_stream.weights, ses_std.weights,
                               rtol=1e-6)


def test_site_major_session_runs_the_matrix_engine():
    """A SiteMajorCodes (streamed-ingest) session compiles exactly the
    engine a matrix session does on the same input: same engine, same
    factorized form, same planes and weight mode — the same cached runner."""
    import weightedld as wld

    vcf = synthetic_t7_path()
    cfg = DriverConfig(tile=8, seq_chunk=8)
    res = wld.prepare(vcf)
    ses_std = LdSession(res.alignment, res.weights, res.site_map, cfg)
    ses_stream = session_from_vcf(vcf, cfg=cfg)
    assert ses_stream.engine == ses_std.engine == "int8"
    assert ses_stream._majmin and ses_std._majmin
    assert ses_stream.runner is ses_std.runner
    assert ses_stream.cfg == ses_std.cfg


def test_prepare_vcf_streamed_padding_contract():
    sm, site_map = prepare_vcf_streamed(
        synthetic_t7_path(), cfg=DriverConfig(tile=8, seq_chunk=8)
    )
    want = LdSession.required_padding(
        sm.n_seqs, sm.n_sites,
        DriverConfig(tile=8, seq_chunk=8),
    )
    assert tuple(sm.codes.shape) == want
    # A mismatched session config must be rejected loudly.
    with pytest.raises(ValueError, match="resolved padding"):
        LdSession(sm, None, site_map,
                  DriverConfig(tile=16, seq_chunk=8))


def test_site_major_buffer_must_match_resolved_padding(tmp_path):
    """A SiteMajorCodes buffer sized exactly by required_padding feeds the
    session; one padded for another tile (larger or smaller) is refused
    loudly instead of sweeping dead rows or desyncing the weights."""
    rng = np.random.default_rng(16)
    # 17 records: cdiv(17, 8)*8 = 24 != cdiv(17, 16)*16 = 32.
    path = _mk_vcf(tmp_path, _random_rows(rng, 17))
    cfg = DriverConfig(tile=8, seq_chunk=8)
    sm_exact, site_map = prepare_vcf_streamed(path, cfg=cfg)
    ses_exact = LdSession(sm_exact, None, site_map, cfg)
    assert ses_exact.cfg.tile == 8
    exact = {}
    for _, r in ses_exact.stream():
        exact.update(_records_map(r))
    assert len(exact) > 0
    codes, sm2, n_haps = read_vcf_site_major(path, s_pad=32, n_pad=24)
    for rows in (32, 16):
        with pytest.raises(ValueError, match="resolved padding"):
            LdSession(SiteMajorCodes(codes=codes[:rows], n_seqs=n_haps,
                                     n_sites=len(sm2)), None, sm2, cfg)
    # The exactly-sized buffer from the same reader gives the same records.
    ses = LdSession(SiteMajorCodes(codes=np.ascontiguousarray(codes[:24]),
                                   n_seqs=n_haps, n_sites=len(sm2)),
                    None, sm2, cfg)
    got = {}
    for _, r in ses.stream():
        got.update(_records_map(r))
    assert got == exact


def test_session_site_major_unweighted_prune_and_maf():
    """The SiteMajorCodes session must support the analyses that used to
    need the host [N, S] matrix (prune -> MAF from the site-major
    histogram)."""
    vcf = synthetic_t7_path()
    cfg = DriverConfig(tile=8, seq_chunk=8)
    ses = session_from_vcf(vcf, cfg=cfg, unweighted=True)
    assert (ses.weights == 1.0).all()
    kept = ses.prune(0.013)
    res = __import__("weightedld").prepare(vcf)
    ses_std = LdSession(res.alignment, np.ones(res.alignment.shape[0],
                                               np.float32),
                        res.site_map, cfg)
    np.testing.assert_array_equal(kept, ses_std.prune(0.013))


def test_cli_stream_ingest_golden(capsys):
    # Streamed ingest through the CLI prints the float64 reference's 4-dp
    # rows, in tile order (one tile here, row-major).
    from weightedld.cli import main

    from .fixtures import synthetic_t7_reference_pairs

    rc = main(["--file", synthetic_t7_path(), "--stream-ingest", "--tile",
               "8", "--seq-chunk", "8"])
    out = capsys.readouterr().out
    assert rc == 0
    lines = [ln for ln in out.strip().split("\n") if ln][1:]
    want = [
        f"{a}\t{b}\t{round(d, 4)!r}\t{round(dp, 4)!r}\t{round(r2, 4)!r}"
        for (a, b), (d, dp, r2) in sorted(
            synthetic_t7_reference_pairs().items())
    ]
    assert lines == want


def test_cli_stream_ingest_fasta(tmp_path, capsys):
    """--stream-ingest streams FASTA too (default framing only)."""
    from weightedld.cli import main

    ex = tmp_path / "example.fasta"
    write_fasta(ex, ALL_FASTAS["example"])
    ex = str(ex)
    assert main(["--file", ex, "--engine", "tiled"]) == 0
    batch = capsys.readouterr().out
    assert main(["--file", ex, "--engine", "tiled", "--stream-ingest"]) == 0
    assert capsys.readouterr().out == batch
    # Rust framing and hk weight-mask need the row-major reader.
    assert main(["--file", ex, "--stream-ingest", "--engine", "tiled",
                 "--fasta-reader", "rust"]) == 2
    assert "FASTA framing" in capsys.readouterr().err
    assert main(["--file", ex, "--stream-ingest", "--engine", "tiled",
                 "--weight-mask", "hk"]) == 2
    assert "row-major reader" in capsys.readouterr().err


def test_cli_stream_ingest_rejects_save_prepared(tmp_path, capsys):
    from weightedld.cli import main

    rc = main(["--file", synthetic_t7_path(), "--stream-ingest",
               "--save-prepared", str(tmp_path / "p.npz")])
    assert rc == 2
    assert "--save-prepared" in capsys.readouterr().err


def test_file_changed_between_passes_detected(tmp_path):
    """Pass 2 re-validates every record against pass 1's site map."""
    rng = np.random.default_rng(15)
    rows = _random_rows(rng, 6)
    path = _mk_vcf(tmp_path, rows)
    n_haps, sm = scan_vcf(path)
    # Simulate a concurrent modification: different positions.
    _mk_vcf(tmp_path, _random_rows(rng, 6, start=5000))
    with pytest.raises(Exception, match="changed between ingest passes"):
        read_vcf_site_major(path, scan=(n_haps, sm + 1))


# ---------------------------------------------------------------------------
# Streaming FASTA ingest (round 5): scan_fasta / read_fasta_site_major /
# prepare_fasta_streamed must be a drop-in for the batch pipeline.


def _write_fasta(tmp_path, text, name="x.fasta"):
    p = tmp_path / name
    p.write_text(text)
    return p


def test_scan_fasta_matches_batch_reader(tmp_path):
    from weightedld.io.fasta import read_fasta_with_names, scan_fasta

    # Wrapped records, blank lines, ambiguity, gaps.
    p = _write_fasta(tmp_path,
                     ">a\nAC\nGT\n\n>b\nACGA\n>c desc\nTC\nGA\n>d\nAYG-\n")
    al, names = read_fasta_with_names(p)
    n, s, counts, _ = scan_fasta(p)
    assert (n, s) == al.shape
    np.testing.assert_array_equal(counts, site_histogram_host(al))


def test_scan_fasta_error_parity(tmp_path):
    from weightedld.io.fasta import scan_fasta

    with pytest.raises(ValueError, match="ragged alignment: sequence 1"):
        scan_fasta(_write_fasta(tmp_path, ">a\nACGT\n>b\nACG\n"))
    with pytest.raises(ValueError, match="before first '>'"):
        scan_fasta(_write_fasta(tmp_path, "ACGT\n>a\nACGT\n", "y.fasta"))
    with pytest.raises(ValueError, match="no sequences found"):
        scan_fasta(_write_fasta(tmp_path, ">a\n>b\n", "z.fasta"))


def test_prepare_fasta_streamed_matches_pipeline(tmp_path):
    from weightedld.pipeline import WldConfig, prepare
    from weightedld.runtime.ingest import prepare_fasta_streamed

    # t1 has junk columns (UNKNOWN-heavy) that the masks drop.
    for name in ("t1", "example"):
        fixture = tmp_path / f"{name}.fasta"
        write_fasta(fixture, ALL_FASTAS[name])
        res = prepare(fixture, WldConfig())
        smc, site_map, hk, ld = prepare_fasta_streamed(fixture)
        assert site_map.tolist() == res.site_map.tolist()
        np.testing.assert_array_equal(hk, res.hk_mask)
        np.testing.assert_array_equal(ld, res.ld_mask)
        np.testing.assert_array_equal(
            smc.codes[:smc.n_sites, :smc.n_seqs].T, res.alignment)
        # Padding is UNKNOWN by the SiteMajorCodes contract.
        assert (smc.codes[smc.n_sites:] == UNKNOWN).all()
        w = henikoff_weights_host_site_major(smc.codes, smc.n_sites,
                                             smc.n_seqs)
        np.testing.assert_allclose(w, res.weights, rtol=1e-12)


def test_streamed_fasta_session_matches_standard(tmp_path):
    import jax

    from weightedld.parallel.sharded import default_mesh
    from weightedld.runtime.driver import collect_ld_records
    from weightedld.runtime.ingest import prepare_fasta_streamed

    rng = np.random.default_rng(11)
    rows = []
    for i in range(20):
        seq = rng.choice(list("ACGT-"), size=40,
                         p=[0.3, 0.28, 0.2, 0.2, 0.02])
        if i % 7 == 0:  # sprinkle ambiguity -> hybrid/general path
            seq[rng.integers(40)] = "N"
        rows.append(">s%d\n%s" % (i, "".join(seq)))
    p = _write_fasta(tmp_path, "\n".join(rows) + "\n")

    from weightedld.pipeline import WldConfig, prepare

    res = prepare(p, WldConfig())
    mesh = default_mesh(jax.devices()[:2])
    cfg = DriverConfig(tile=16, seq_chunk=128, tiles_per_shard_batch=2)
    smc, site_map, _, _ = prepare_fasta_streamed(p, cfg=cfg)
    w = henikoff_weights_host_site_major(smc.codes, smc.n_sites, smc.n_seqs)
    rec_s = collect_ld_records(smc, w, site_map, cfg, mesh=mesh)
    rec_b = collect_ld_records(res.alignment, res.weights, res.site_map,
                               cfg, mesh=mesh)
    a = sorted(zip(rec_s.pos_a.tolist(), rec_s.pos_b.tolist(),
                   np.round(rec_s.r2, 5).tolist()))
    b = sorted(zip(rec_b.pos_a.tolist(), rec_b.pos_b.tolist(),
                   np.round(rec_b.r2, 5).tolist()))
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x[:2] == y[:2] and abs(x[2] - y[2]) < 2e-4


def test_streamed_fasta_gzip_and_file_changed(tmp_path):
    from weightedld.io.fasta import read_fasta_site_major, scan_fasta
    from weightedld.runtime.ingest import prepare_fasta_streamed

    text = ">a\nACGT\n>b\nACGA\n>c\nTCGA\n>d\nAAGA\n"
    p = _write_fasta(tmp_path, text)
    gz = tmp_path / "x.fasta.gz"
    with gzip.open(gz, "wt") as fh:
        fh.write(text)
    smc_p, sm_p, _, _ = prepare_fasta_streamed(p)
    smc_g, sm_g, _, _ = prepare_fasta_streamed(gz)
    np.testing.assert_array_equal(smc_p.codes, smc_g.codes)
    assert sm_p.tolist() == sm_g.tolist()
    # Pass-2 drift detection.
    n, s, counts, _ = scan_fasta(p)
    p.write_text(text + ">e\nGGGG\n")
    with pytest.raises(ValueError, match="changed between ingest passes"):
        read_fasta_site_major(p, np.ones(s, bool), scan=(n, s))


def test_session_from_fasta_matches_standard(tmp_path):
    import jax

    from weightedld.parallel.sharded import default_mesh
    from weightedld.pipeline import WldConfig, prepare
    from weightedld.runtime.ingest import session_from_fasta

    ex = tmp_path / "example.fasta"
    write_fasta(ex, ALL_FASTAS["example"])
    cfg = DriverConfig(tile=16, seq_chunk=128, tiles_per_shard_batch=2)
    mesh = default_mesh(jax.devices()[:2])
    s = session_from_fasta(ex, cfg=cfg, mesh=mesh)
    got = {}
    for _, r in s.stream():
        got.update(_records_map(r))
    assert set(got) == {(0, 1)}
    d, dp, r2 = got[(0, 1)]
    assert (round(d, 4), round(dp, 4), round(r2, 4)) == \
        (0.1029, 0.3429, 0.2236)  # SURVEY A.1 golden
    # Weights equal the pipeline's (f64, chunked-summation order).
    res = prepare(ex, WldConfig())
    np.testing.assert_allclose(s.weights, res.weights, rtol=1e-6)


def test_streamed_fasta_sample_subsetting(tmp_path, capsys):
    """Streamed FASTA subsetting equals the batch pipeline's (subset
    before masks/weights), including under wrapped records and gzip."""
    from weightedld.cli import main
    from weightedld.pipeline import WldConfig, prepare
    from weightedld.runtime.ingest import prepare_fasta_streamed

    rows = ["ATAA", "TAAA", "TAAA", "TAAA", "T-AA",
            "TTAA", "TTAA", "TTAA", "TTAA", "TTAY"]
    path = tmp_path / "e.fasta"
    path.write_text("".join(f">seq{i}\n{r[:2]}\n{r[2:]}\n"
                            for i, r in enumerate(rows)))
    keep = tuple(f"seq{i}" for i in range(1, 9))
    res = prepare(path, WldConfig(keep_samples=keep))
    smc, site_map, hk, ld = prepare_fasta_streamed(path, keep_samples=keep)
    assert site_map.tolist() == res.site_map.tolist()
    np.testing.assert_array_equal(
        smc.codes[:smc.n_sites, :smc.n_seqs].T, res.alignment)
    np.testing.assert_allclose(
        henikoff_weights_host_site_major(smc.codes, smc.n_sites,
                                         smc.n_seqs),
        res.weights, rtol=1e-12)
    # Typo safety survives streaming.
    with pytest.raises(ValueError, match="unknown sample name"):
        prepare_fasta_streamed(path, keep_samples=("nope",))
    # CLI byte parity, batch vs streamed, with the subset applied.
    spec = ",".join(keep)
    assert main(["--file", str(path), "--engine", "tiled",
                 "--keep-samples", spec]) == 0
    batch = capsys.readouterr().out
    assert main(["--file", str(path), "--engine", "tiled",
                 "--keep-samples", spec, "--stream-ingest"]) == 0
    assert capsys.readouterr().out == batch



def test_streamed_vcf_sample_subsetting():
    """Streamed VCF subsetting: buffer equals the batch pipeline's subset
    alignment (rot90-aware mapping), weights match."""
    from weightedld.io.vcf import vcf_sample_names
    from weightedld.pipeline import WldConfig, prepare

    vcf = synthetic_t7_path()
    names = vcf_sample_names(vcf)
    keep = tuple(names[:40])
    res = prepare(vcf, WldConfig(keep_samples=keep))
    sm, site_map = prepare_vcf_streamed(
        vcf, cfg=DriverConfig(tile=8, seq_chunk=8),
        keep_samples=keep)
    assert sm.n_seqs == 80 and site_map.tolist() == res.site_map.tolist()
    np.testing.assert_array_equal(
        sm.codes[:sm.n_sites, :sm.n_seqs].T, res.alignment)
    w = henikoff_weights_host_site_major(sm.codes, sm.n_sites, sm.n_seqs)
    np.testing.assert_allclose(w, res.weights, rtol=1e-12)
    with pytest.raises(ValueError, match="unknown sample name"):
        prepare_vcf_streamed(vcf, keep_samples=("NOPE",),
                             cfg=DriverConfig(tile=8, seq_chunk=8))


def test_streamed_fasta_subset_drift_detected(tmp_path):
    """Records appended between passes under subsetting: pass 2 refuses
    with the clean 'file changed' error (not an IndexError)."""
    from weightedld.io.fasta import read_fasta_site_major, scan_fasta

    text = ">a\nACGT\n>b\nACGA\n>c\nTCGA\n"
    p = tmp_path / "x.fasta"
    p.write_text(text)
    n, s, counts, row_mask = scan_fasta(p, keep_samples=("a", "b"))
    assert n == 2 and row_mask.tolist() == [True, True, False]
    p.write_text(text + ">d\nGGGG\n")
    with pytest.raises(ValueError, match="changed between ingest passes"):
        read_fasta_site_major(p, np.ones(s, bool), scan=(n, s),
                              row_mask=row_mask)
