"""CLI surface tests (flag union of WeightedLD.py argparse + Rust structopt)."""

import json

import numpy as np
import pytest

from weightedld.cli import main

from .fixtures import ALL_FASTAS, GOLDEN, write_fasta


def _run(capsys, *argv):
    rc = main(list(argv))
    out = capsys.readouterr()
    return rc, out.out


def test_default_stdout(tmp_path, capsys):
    f = tmp_path / "t5.fasta"
    write_fasta(f, ALL_FASTAS["t5"])
    rc, out = _run(capsys, "--file", str(f))
    assert rc == 0
    lines = out.strip().split("\n")
    assert lines[0] == "posa\tposb\tD\tD'\tR2"
    assert lines[1] == "0\t1\t-0.25\t0.5\t1.0"


def test_pair_output_file(tmp_path, capsys):
    f = tmp_path / "t3.fasta"
    write_fasta(f, ALL_FASTAS["t3"])
    out_file = tmp_path / "pairs.tsv"
    rc, _ = _run(capsys, "--file", str(f), "--pair-output", str(out_file))
    assert rc == 0
    lines = out_file.read_text().strip().split("\n")
    assert len(lines) == 1 + len(GOLDEN["t3"]["pairs"])


def test_weights_output(tmp_path, capsys):
    f = tmp_path / "t1.fasta"
    write_fasta(f, ALL_FASTAS["t1"])
    wf = tmp_path / "weights.tsv"
    rc, _ = _run(capsys, "--file", str(f), "--weights-output", str(wf))
    rows = wf.read_text().strip().split("\n")
    assert rows[0] == "sequence\tweight"
    weights = [float(r.split("\t")[1]) for r in rows[1:]]
    np.testing.assert_allclose(weights, GOLDEN["t1"]["weights"], atol=1e-4)


def test_unweighted(tmp_path, capsys):
    f = tmp_path / "t5.fasta"
    write_fasta(f, ALL_FASTAS["t5"])
    rc, out = _run(capsys, "--file", str(f), "--unweighted")
    assert "0\t1\t-0.25\t0.5\t1.0" in out


def test_r2_threshold_excludes(tmp_path, capsys):
    f = tmp_path / "t5.fasta"
    write_fasta(f, ALL_FASTAS["t5"])
    rc, out = _run(capsys, "--file", str(f), "--r2-threshold", "1.0")
    assert out.strip() == "posa\tposb\tD\tD'\tR2"  # r2==1.0 not > 1.0


def test_tiled_engine_matches_dense(tmp_path, capsys):
    f = tmp_path / "t3.fasta"
    write_fasta(f, ALL_FASTAS["t3"])
    _, dense_out = _run(capsys, "--file", str(f), "--engine", "dense")
    _, tiled_out = _run(capsys, "--file", str(f), "--engine", "tiled",
                        "--tile", "16")
    assert sorted(dense_out.strip().split("\n")) == sorted(tiled_out.strip().split("\n"))


def test_stats_only(tmp_path, capsys):
    f = tmp_path / "t1.fasta"
    write_fasta(f, ALL_FASTAS["t1"])
    rc, out = _run(capsys, "--file", str(f), "--stats-only")
    stats = json.loads(out)
    assert stats["n_pairs"] == 10
    assert stats["r2_max"] == pytest.approx(1.0, abs=1e-5)


def test_invariant_input(tmp_path, capsys):
    f = tmp_path / "flat.fasta"
    write_fasta(f, ["AAAA", "AAAA", "AAAA"])
    rc, out = _run(capsys, "--file", str(f))
    assert rc == 0
    assert out.strip() == "posa\tposb\tD\tD'\tR2"


def test_min_variability_flag(tmp_path, capsys):
    f = tmp_path / "t6.fasta"
    write_fasta(f, ALL_FASTAS["t6"])
    _, out_default = _run(capsys, "--file", str(f))
    _, out_strict = _run(capsys, "--file", str(f), "--min-variability", "0.2")
    assert len(out_default.strip().split("\n")) == 2   # pair (0,1)
    assert len(out_strict.strip().split("\n")) == 1    # only site 0 survives


def test_sorted_tiled_matches_dense_order(tmp_path, capsys):
    f = tmp_path / "t3.fasta"
    write_fasta(f, ALL_FASTAS["t3"])
    _, dense_out = _run(capsys, "--file", str(f), "--engine", "dense")
    _, sorted_out = _run(capsys, "--file", str(f), "--engine", "tiled",
                         "--tile", "16", "--sort")
    assert dense_out == sorted_out


def test_max_distance_flag(tmp_path, capsys):
    f = tmp_path / "t1.fasta"
    write_fasta(f, ALL_FASTAS["t1"])
    _, full = _run(capsys, "--file", str(f), "--engine", "tiled", "--tile", "16",
                   "--sort")
    _, win = _run(capsys, "--file", str(f), "--tile", "16", "--sort",
                  "--max-distance", "1")
    full_rows = full.strip().split("\n")[1:]
    win_rows = win.strip().split("\n")[1:]
    assert len(full_rows) == 10
    # t1 kept sites are 2..6; distance<=1 keeps only adjacent pairs (4 of 10).
    assert len(win_rows) == 4
    assert set(win_rows).issubset(set(full_rows))


def test_devices_flag(tmp_path, capsys):
    f = tmp_path / "t3.fasta"
    write_fasta(f, ALL_FASTAS["t3"])
    _, all_dev = _run(capsys, "--file", str(f), "--engine", "tiled",
                      "--tile", "16", "--sort")
    _, two_dev = _run(capsys, "--file", str(f), "--engine", "tiled",
                      "--tile", "16", "--sort", "--devices", "2")
    assert all_dev == two_dev


def test_compat_rust_preset(tmp_path, capsys):
    f = tmp_path / "t1.fasta"
    write_fasta(f, ALL_FASTAS["t1"])
    _, out = _run(capsys, "--file", str(f), "--compat", "rust")
    rows = out.strip().split("\n")[1:]
    # Rust semantics on t1: same 10 pairs (r2=1.0 > 0.1), 3-dp formatting.
    assert len(rows) == 10
    assert rows[0].split("\t")[2:] == ["-0.25", "0.5", "1.0"]
    # Weights use the paper formula under the preset.
    wf = tmp_path / "w.tsv"
    _run(capsys, "--file", str(f), "--compat", "rust",
         "--weights-output", str(wf))
    w = [float(r.split("\t")[1]) for r in wf.read_text().strip().split("\n")[1:]]
    np.testing.assert_allclose(w, [0.5, 0.5, 0.5, 0.5, 1.0], atol=1e-4)


def test_reference_engine(tmp_path, capsys):
    f = tmp_path / "t3.fasta"
    write_fasta(f, ALL_FASTAS["t3"])
    _, ref_out = _run(capsys, "--file", str(f), "--engine", "reference")
    _, dense_out = _run(capsys, "--file", str(f), "--engine", "dense")
    assert ref_out == dense_out  # f64 audit engine agrees at 4 dp


def test_gzip_pair_and_weights_output(tmp_path):
    import gzip

    src = tmp_path / "e.fasta"
    write_fasta(src, ALL_FASTAS["example"])
    plain = tmp_path / "p.tsv"
    gz = tmp_path / "p.tsv.gz"
    wgz = tmp_path / "w.tsv.gz"
    assert main(["--file", str(src), "--pair-output", str(plain)]) == 0
    assert main(["--file", str(src), "--pair-output", str(gz),
                 "--weights-output", str(wgz)]) == 0
    assert gzip.open(gz, "rt").read() == plain.read_text()
    assert gzip.open(wgz, "rt").read().startswith("sequence\tweight\n")


def test_gzip_checkpoint_resume_byte_exact(tmp_path):
    """Checkpointed .gz output: per-segment gzip members let resume
    truncate at a member boundary; the resumed file byte-equals an
    uninterrupted checkpointed run, and decompresses to the plain TSV."""
    import gzip

    from weightedld.runtime import driver as drv
    from weightedld.runtime.driver import DriverConfig, run_to_tsv

    from .fixtures import random_alignment

    rng = np.random.default_rng(0)
    aln = random_alignment(rng, 24, 64)
    w = np.ones(24, np.float32)
    sm = np.arange(64)
    cfg = DriverConfig(tile=16, tiles_per_shard_batch=1)

    plain = tmp_path / "x.tsv"
    n_plain = run_to_tsv(aln, w, sm, plain, cfg, checkpoint=False)
    full_gz = tmp_path / "full.tsv.gz"
    n_full = run_to_tsv(aln, w, sm, full_gz, cfg, checkpoint=True)
    assert n_full == n_plain
    assert gzip.open(full_gz, "rt").read() == plain.read_text()

    # Interrupt after 2 batches, then resume with the same command.
    part = tmp_path / "part.tsv.gz"

    class Stop(Exception):
        pass

    calls = {"n": 0}
    orig = drv.LdSession.stream

    def limited_stream(*args, **kwargs):
        for item in orig(*args, **kwargs):
            yield item
            calls["n"] += 1
            if calls["n"] >= 2 and not kwargs.get("start_batch"):
                raise Stop

    drv.LdSession.stream = limited_stream
    try:
        with pytest.raises(Stop):
            run_to_tsv(aln, w, sm, part, cfg, checkpoint=True)
    finally:
        drv.LdSession.stream = orig
    ckpt = part.with_suffix(part.suffix + ".ckpt.json")
    assert ckpt.exists()
    n_resumed = run_to_tsv(aln, w, sm, part, cfg, checkpoint=True)
    assert not ckpt.exists()
    assert n_resumed == n_full
    assert part.read_bytes() == full_gz.read_bytes()


def test_gzip_output_deterministic(tmp_path):
    from .fixtures import ALL_FASTAS, write_fasta

    src = tmp_path / "e.fasta"
    write_fasta(src, ALL_FASTAS["example"])
    a, b = tmp_path / "a.tsv.gz", tmp_path / "b.tsv.gz"
    assert main(["--file", str(src), "--pair-output", str(a)]) == 0
    assert main(["--file", str(src), "--pair-output", str(b)]) == 0
    # Byte-identical across runs and names (no mtime/filename in header).
    assert a.read_bytes() == b.read_bytes()


def test_gzip_checkpoint_cli_accepted(tmp_path, capsys):
    """--checkpoint + .gz --pair-output now compose (gzip members)."""
    import gzip

    from .fixtures import ALL_FASTAS, write_fasta

    src = tmp_path / "e.fasta"
    write_fasta(src, ALL_FASTAS["example"])
    gz = tmp_path / "x.tsv.gz"
    plain = tmp_path / "x.tsv"
    assert main(["--file", str(src), "--pair-output", str(plain)]) == 0
    rc = main(["--file", str(src), "--pair-output", str(gz),
               "--checkpoint"])
    assert rc == 0
    assert gzip.open(gz, "rt").read() == plain.read_text()


def test_matrix_output_few_sites(tmp_path):
    # <2 surviving sites must still produce the requested .npz (not a
    # stray pair header).
    src = tmp_path / "flat.fasta"
    write_fasta(src, ["AAAA"] * 6)  # no variable sites
    out = tmp_path / "m.npz"
    assert main(["--file", str(src), "--matrix-output", str(out)]) == 0
    z = np.load(out)
    assert z["keep"].shape == (0, 0)


def test_top_k(tmp_path, capsys):
    # --top K = the K strongest pairs by r2, descending, threshold-free.
    f = tmp_path / "t3.fasta"
    write_fasta(f, ALL_FASTAS["t3"])
    rc, full = _run(capsys, "--file", str(f))
    assert rc == 0
    rows = [ln.split("\t") for ln in full.strip().split("\n")[1:]]
    want = sorted((float(r[4]) for r in rows), reverse=True)[:3]

    for engine in ("dense", "tiled"):
        rc, out = _run(capsys, "--file", str(f), "--top", "3",
                       "--engine", engine, "--tile", "16")
        assert rc == 0
        got = [float(ln.split("\t")[4])
               for ln in out.strip().split("\n")[1:]]
        assert got == pytest.approx(want, abs=1e-4), engine
        assert got == sorted(got, reverse=True)

    # K beyond the record count returns everything; bad K is a usage error.
    rc, out = _run(capsys, "--file", str(f), "--top", "999",
                   "--engine", "tiled", "--tile", "16")
    assert rc == 0
    assert len(out.strip().split("\n")) - 1 == len(rows)
    assert main(["--file", str(f), "--top", "0"]) == 2


def test_ld_decay_cli(tmp_path, capsys):
    # LD-decay curve on the real t7 VCF: distances in bp (site_map = POS).
    import shutil

    src = "/root/reference/tests/t7_1000genome.vcf"
    import os
    if not os.path.exists(src):
        pytest.skip("reference fixture unavailable")
    f = tmp_path / "t7.vcf"
    shutil.copy(src, f)
    rc, out = _run(capsys, "--file", str(f),
                   "--ld-decay", "0,100,200,1000", "--tile", "16")
    assert rc == 0
    decay = json.loads(out)
    # 10 surviving pairs total (SURVEY A.8); bin edges at bp distances.
    assert decay["edges"] == [0, 100, 200, 1000]
    assert sum(decay["n_pairs"]) == 10
    # Spot check vs the golden rows (SURVEY A.8): 7 pairs lie closer than
    # 100 bp, with r2 {.0148 x3, .0157, .0124, .0132 x2}.
    assert decay["n_pairs"][0] == 7
    assert decay["r2_mean"][0] == pytest.approx(
        (0.0148 * 3 + 0.0157 + 0.0124 + 0.0132 * 2) / 7, abs=2e-4)

    assert main(["--file", str(f), "--ld-decay", "nope"]) == 2
    assert main(["--file", str(f), "--ld-decay", "5,5"]) == 2


def test_max_distance_bp_cli(tmp_path, capsys):
    # bp window on the real t7 VCF: of the 10 golden pairs (SURVEY A.8),
    # exactly 7 span <= 100 bp — the same population --ld-decay's [0,100)
    # bin counts.
    import os
    import shutil

    src = "/root/reference/tests/t7_1000genome.vcf"
    if not os.path.exists(src):
        pytest.skip("reference fixture unavailable")
    f = tmp_path / "t7.vcf"
    shutil.copy(src, f)
    rc, out = _run(capsys, "--file", str(f), "--max-distance-bp", "100",
                   "--tile", "16")
    assert rc == 0
    rows = [ln.split("\t") for ln in out.strip().split("\n")[1:]]
    assert len(rows) == 7
    assert all(int(b) - int(a) <= 100 for a, b, *_ in rows)
    # Composes with pruning: within the window no surviving pair may
    # exceed the threshold among kept sites.
    rc, out = _run(capsys, "--file", str(f), "--max-distance-bp", "100",
                   "--prune-r2", "0.013", "--tile", "16")
    assert rc == 0
    kept = {int(x) for x in out.split()}
    assert kept  # something survives
    # A decreasing site_map (multi-chromosome style) is refused early.
    two = tmp_path / "two.vcf"
    txt = f.read_text().split("\n")
    hdr_end = next(i for i, ln in enumerate(txt) if ln.startswith("#CHROM"))
    recs = [ln for ln in txt[hdr_end + 1:] if ln.strip()]
    two.write_text("\n".join(txt[:hdr_end + 1] + recs + recs[:1]) + "\n")
    assert main(["--file", str(two), "--max-distance-bp", "100"]) == 2


def test_prune_cli(tmp_path, capsys):
    f = tmp_path / "t3.fasta"
    write_fasta(f, ALL_FASTAS["t3"])
    # t3 has a perfect-LD pair (3,4) at r2=1.0: pruning at 0.9 must drop
    # one of the two and keep a conflict-free set.
    rc, out = _run(capsys, "--file", str(f), "--prune-r2", "0.9",
                   "--engine", "tiled", "--tile", "16")
    assert rc == 0
    kept = [int(x) for x in out.split()]
    assert not ({3, 4} <= set(kept))
    rc, full = _run(capsys, "--file", str(f))
    rows = [ln.split("\t") for ln in full.strip().split("\n")[1:]]
    for a, b, *_, r2 in rows:
        if int(a) in kept and int(b) in kept:
            assert float(r2) <= 0.9
    # Mutually exclusive output modes.
    assert main(["--file", str(f), "--prune-r2", "0.5", "--top", "2"]) == 2


def test_degenerate_single_site_modes(tmp_path, capsys):
    # One surviving LD site: each output mode keeps its own (empty) format.
    f = tmp_path / "one.fasta"
    # Site 0 variable, others invariant -> exactly one LD site.
    write_fasta(f, ["AAAA", "AAAA", "TAAA", "TAAA"])
    rc, out = _run(capsys, "--file", str(f))
    assert rc == 0 and out.strip() == "posa\tposb\tD\tD'\tR2"
    rc, out = _run(capsys, "--file", str(f), "--stats-only")
    assert rc == 0 and json.loads(out)["n_pairs"] == 0
    rc, out = _run(capsys, "--file", str(f), "--ld-decay", "0,10")
    assert rc == 0
    assert json.loads(out) == {"edges": [0, 10], "n_pairs": [0],
                               "r2_sum": [0.0], "r2_mean": [None],
                               "abs_d_prime_sum": [0.0],
                               "abs_d_prime_mean": [None],
                               "n_d_prime_finite": [0]}
    rc, out = _run(capsys, "--file", str(f), "--prune-r2", "0.5")
    assert rc == 0 and out.split() == ["0"]  # the lone site is kept
    assert main(["--file", str(f), "--ld-decay", "9,9"]) == 2


def test_prune_rejects_nan_and_duplicates(tmp_path, capsys):
    f = tmp_path / "t5.fasta"
    write_fasta(f, ALL_FASTAS["t5"])
    assert main(["--file", str(f), "--prune-r2", "nan"]) == 2


def test_r2_hist_cli(tmp_path, capsys):
    f = tmp_path / "t1.fasta"
    write_fasta(f, ALL_FASTAS["t1"])
    # t1: all 10 pairs at r2 == 1.0 exactly.
    rc, out = _run(capsys, "--file", str(f), "--r2-hist", "0,0.5,1.01",
                   "--engine", "tiled", "--tile", "16")
    assert rc == 0
    hist = json.loads(out)
    assert hist["n_pairs"] == [0, 10]
    assert main(["--file", str(f), "--r2-hist", "x"]) == 2
    assert main(["--file", str(f), "--r2-hist", "0,1", "--top", "2"]) == 2


def test_r2_hist_validates_before_session(tmp_path, capsys, monkeypatch):
    # Bad edge lists must exit 2 BEFORE the session pays the alignment
    # upload + kernel compile (the validate-before-compile contract that
    # --ld-decay already honors).
    import weightedld.cli as cli

    f = tmp_path / "t1.fasta"
    write_fasta(f, ALL_FASTAS["t1"])

    def boom(*a, **k):
        raise AssertionError("session built before --r2-hist validation")

    monkeypatch.setattr(cli, "_build_session", boom)
    for bad in ("0.5,0.1", "0.3", "a,b"):
        assert main(["--file", str(f), "--r2-hist", bad]) == 2
        assert "--r2-hist" in capsys.readouterr().err


def test_r2_hist_degenerate_single_site(tmp_path, capsys):
    f = tmp_path / "one.fasta"
    write_fasta(f, ["AAAA", "AAAA", "TAAA", "TAAA"])  # one LD site
    rc, out = _run(capsys, "--file", str(f), "--r2-hist", "0,0.5,1.01")
    assert rc == 0
    assert json.loads(out) == {"edges": [0.0, 0.5, 1.01], "n_pairs": [0, 0]}
    assert main(["--file", str(f), "--r2-hist", "1,0"]) == 2


def test_site_stats(tmp_path, capsys):
    # t1: columns 0-1 are ambiguous/gap junk (coverage fails), 2-6 the
    # Henikoff paper example (SURVEY Appendix B) -> hk [0,0,1,1,1,1,1].
    f = tmp_path / "t1.fasta"
    write_fasta(f, ALL_FASTAS["t1"])
    out_file = tmp_path / "sites.tsv"
    rc, _ = _run(capsys, "--file", str(f), "--site-stats", str(out_file))
    assert rc == 0
    lines = out_file.read_text().strip().split("\n")
    assert lines[0] == "site\tcoverage\tmajor_code\tminor_fraction\thk\tld"
    rows = [ln.split("\t") for ln in lines[1:]]
    assert len(rows) == 7                      # ALL original sites
    assert [r[4] for r in rows] == ["0", "0", "1", "1", "1", "1", "1"]
    assert [r[5] for r in rows] == [r[4] for r in rows]  # defaults: ld == hk
    # Column 0: G,b,z,p,M -> one concrete of 5 (coverage 0.2), major G=2,
    # minor fraction 0 (only G counts among codes 0-4).
    assert rows[0][:4] == ["0", "0.2", "2", "0.0"]
    # Paper column 2: A A C C T -> major A (code 0), minor 3/5.
    assert rows[2][1:4] == ["1.0", "0", "0.6"]

    # Oracle: values equal the host mask math on the same alignment.
    from weightedld.io.fasta import read_fasta
    from weightedld.pipeline import WldConfig, site_stats

    stats = site_stats(f, WldConfig())
    aln = read_fasta(f)
    from weightedld.core.sites import compute_variable_sites_host

    hk, ld = compute_variable_sites_host(aln, 0.8, 0.02)
    np.testing.assert_array_equal(stats["hk"], hk)
    np.testing.assert_array_equal(stats["ld"], ld)

    # stdout mode + mutual exclusion + prepared-cache refusal.
    rc, out = _run(capsys, "--file", str(f), "--site-stats", "-")
    assert rc == 0 and out.startswith("site\t")
    assert main(["--file", str(f), "--site-stats", "-", "--stats-only"]) == 2
    assert main(["--site-stats", "-"]) == 2  # no --file


def test_site_stats_vcf(tmp_path, capsys):
    # VCF rows keyed by POS; masks are informational (never applied on the
    # VCF path) but still computed from the same thresholds.
    from .fixtures import synthetic_t7_path

    vcf = synthetic_t7_path()

    rc, out = _run(capsys, "--file", vcf, "--site-stats", "-")
    assert rc == 0
    lines = out.strip().split("\n")
    assert len(lines) == 6
    assert lines[1].split("\t")[0] == "44890030"
    # Binary SNPs with full coverage... coverage counts ACGT-coded alleles
    # (REF=0/ALT=1 alias A/C), so it is 1.0 here and every site is variable.
    for ln in lines[1:]:
        cols = ln.split("\t")
        assert cols[1] == "1.0" and cols[2] == "0"
        assert 0.0 < float(cols[3]) < 0.5


def test_ingest_errors_are_clean(tmp_path, capsys):
    # Malformed inputs exit 2 with a one-line error, not a traceback.
    ragged = tmp_path / "ragged.fasta"
    ragged.write_text(">a\nACGT\n>b\nACG\n")
    assert main(["--file", str(ragged)]) == 2
    err = capsys.readouterr().err
    assert err.startswith("error:") and "ragged" in err

    bad = tmp_path / "bad.vcf"
    bad.write_text("no header\n1\t2\n")
    assert main(["--file", str(bad)]) == 2
    assert "#CHROM" in capsys.readouterr().err

    assert main(["--file", str(ragged), "--site-stats", "-"]) == 2
    assert "ragged" in capsys.readouterr().err


def test_query_mode_flag_combinations(tmp_path, capsys):
    # --list-chroms joins the mutually-exclusive mode list, and the
    # pre-analysis query modes refuse --save-prepared (they never ingest,
    # so the cache would silently not be written).
    f = tmp_path / "t5.fasta"
    write_fasta(f, ALL_FASTAS["t5"])
    assert main(["--file", str(f), "--list-chroms", "--stats-only"]) == 2
    assert "mutually exclusive" in capsys.readouterr().err
    assert main(["--file", str(f), "--list-chroms",
                 "--save-prepared", str(tmp_path / "p.npz")]) == 2
    assert "--save-prepared" in capsys.readouterr().err
    # Missing files exit 2 with a one-line error on every entry path.
    for extra in ([], ["--list-chroms"], ["--site-stats", "-"]):
        assert main(["--file", str(tmp_path / "nope.vcf")] + extra) == 2
        assert capsys.readouterr().err.startswith("error:")


def test_progress_bar_rendering():
    """Unit: TTY renders in place with \\r and finishes with a newline;
    non-TTY emits one line per update."""
    import io

    from weightedld.io.progressbar import ProgressBar
    from weightedld.runtime.driver import Progress

    class Tty(io.StringIO):
        def isatty(self):
            return True

    tty = Tty()
    bar = ProgressBar(tty)
    bar(Progress(pairs_done=50, pairs_total=100, records_emitted=3,
                 elapsed_s=1.0))
    bar(Progress(pairs_done=100, pairs_total=100, records_emitted=7,
                 elapsed_s=2.0))
    out = tty.getvalue()
    assert out.startswith("\r[")
    assert " 50.0%" in out and "100.0%" in out
    assert "eta 00:01" in out            # 50 pairs left at 50/s
    assert out.endswith("\n")            # completed bar terminates the line
    bar(Progress(pairs_done=100, pairs_total=100, records_emitted=7,
                 elapsed_s=2.0))
    assert tty.getvalue() == out         # no rendering after completion

    plain = io.StringIO()
    bar2 = ProgressBar(plain)
    bar2(Progress(pairs_done=10, pairs_total=100, records_emitted=0,
                  elapsed_s=0.0))        # zero elapsed -> unknown ETA
    line = plain.getvalue()
    assert line.endswith("\n") and "\r" not in line
    assert "eta --:--" in line

    # close() terminates a half-done TTY bar.
    tty2 = Tty()
    bar3 = ProgressBar(tty2)
    bar3(Progress(pairs_done=10, pairs_total=100, records_emitted=0,
                  elapsed_s=1.0))
    bar3.close()
    assert tty2.getvalue().endswith("\n")


def test_progress_bar_cli_smoke(tmp_path, capsys):
    f = tmp_path / "t3.fasta"
    write_fasta(f, ALL_FASTAS["t3"])
    rc = main(["--file", str(f), "--engine", "tiled", "--tile", "16",
               "--progress-bar"])
    captured = capsys.readouterr()
    assert rc == 0
    assert "100.0%" in captured.err and "eta" in captured.err


# ---------------------------------------------------------------------------
# --region / --keep-samples / --exclude-samples (round-5 capabilities).


def _t7_sliced(tmp_path, lo, hi):
    """Write a copy of the t7 fixture holding only records with
    lo <= POS <= hi (plus a trailing newline so no record is quirk-dropped)."""
    from .fixtures import synthetic_t7_path

    vcf = synthetic_t7_path()

    out = tmp_path / "slice.vcf"
    lines = []
    in_data = False
    for ln in open(vcf):
        body = ln.rstrip("\n")
        if not in_data:
            lines.append(body)
            if "#CHROM" in body:
                in_data = True
            continue
        if not body.strip():
            continue
        pos = int(body.split("\t", 2)[1])
        if lo <= pos <= hi:
            lines.append(body)
    out.write_text("\n".join(lines) + "\n")
    return out


def test_region_equals_presliced_file(tmp_path, capsys):
    from .fixtures import synthetic_t7_path

    vcf = synthetic_t7_path()

    lo, hi = 44890100, 44890180
    rc = main(["--file", vcf, "--region", f"19:{lo}-{hi}"])
    assert rc == 0
    region_out = capsys.readouterr().out
    sliced = _t7_sliced(tmp_path, lo, hi)
    assert main(["--file", str(sliced)]) == 0
    assert capsys.readouterr().out == region_out
    assert len(region_out.strip().splitlines()) == 4  # header + C(3,2) pairs
    # Bare-chromosome region == --chrom.
    assert main(["--file", vcf, "--region", "19"]) == 0
    bare = capsys.readouterr().out
    assert main(["--file", vcf, "--chrom", "19"]) == 0
    assert capsys.readouterr().out == bare


def test_region_cli_validation(tmp_path, capsys):
    from .fixtures import synthetic_t7_path

    vcf = synthetic_t7_path()

    # Mutually exclusive with --chrom.
    assert main(["--file", vcf, "--chrom", "19",
                 "--region", "19:1-2"]) == 2
    assert "mutually exclusive" in capsys.readouterr().err
    # VCF-only.
    fa = tmp_path / "x.fasta"
    fa.write_text(">a\nACGT\n>b\nACGA\n>c\nTCGA\n")
    assert main(["--file", str(fa), "--region", "chr1:1-2"]) == 2
    assert "--region only applies to VCF" in capsys.readouterr().err
    # Empty region -> clean error, not a crash.
    assert main(["--file", vcf, "--region", "19:1-2"]) == 2
    assert "POS range 1-2" in capsys.readouterr().err


def test_keep_exclude_samples_cli(tmp_path, capsys):
    path = tmp_path / "e.fasta"
    write_fasta(path, ["ATAA", "TAAA", "TAAA", "TAAA", "T-AA",
                       "TTAA", "TTAA", "TTAA", "TTAA", "TTAY"])
    # Excluding via @FILE == keeping the complement via a comma list.
    listfile = tmp_path / "drop.txt"
    listfile.write_text("# comment line\nseq0\n\nseq9\n")
    assert main(["--file", str(path), "--exclude-samples",
                 f"@{listfile}"]) == 0
    excl_out = capsys.readouterr().out
    keep = ",".join(f"seq{i}" for i in range(1, 9))
    assert main(["--file", str(path), "--keep-samples", keep]) == 0
    assert capsys.readouterr().out == excl_out
    # Unknown names are an error (typo safety).
    assert main(["--file", str(path), "--keep-samples", "seq1,sqe2"]) == 2
    assert "unknown sample name" in capsys.readouterr().err
    # Empty spec is an error.
    assert main(["--file", str(path), "--keep-samples", ",,"]) == 2
    assert "empty sample list" in capsys.readouterr().err
    # Subsetting changes the analysis (weights differ from the full run).
    assert main(["--file", str(path)]) == 0
    assert capsys.readouterr().out != excl_out


def test_stream_ingest_region_parity(tmp_path, capsys):
    from .fixtures import synthetic_t7_path

    vcf = synthetic_t7_path()

    lo, hi = 44890100, 44890200
    assert main(["--file", vcf, "--region", f"19:{lo}-{hi}",
                 "--engine", "tiled"]) == 0
    row_major = capsys.readouterr().out
    assert main(["--file", vcf, "--region", f"19:{lo}-{hi}",
                 "--engine", "tiled", "--stream-ingest"]) == 0
    assert capsys.readouterr().out == row_major
    # Sample subsetting composes with streamed VCF ingest (round 5):
    # byte parity against the row-major path under the same subset.
    from weightedld.io.vcf import vcf_sample_names

    keep = ",".join(vcf_sample_names(vcf)[:32])
    assert main(["--file", vcf, "--engine", "tiled",
                 "--keep-samples", keep]) == 0
    row_major_sub = capsys.readouterr().out
    assert main(["--file", vcf, "--engine", "tiled",
                 "--keep-samples", keep, "--stream-ingest"]) == 0
    assert capsys.readouterr().out == row_major_sub


# ---------------------------------------------------------------------------
# --out-format plink (round-5 capability).


def test_plink_format_vcf(tmp_path, capsys):
    from .fixtures import synthetic_t7_path

    vcf = synthetic_t7_path()

    assert main(["--file", vcf, "--out-format", "plink"]) == 0
    out = capsys.readouterr().out
    lines = out.strip().splitlines()
    assert lines[0] == "CHR_A\tBP_A\tSNP_A\tCHR_B\tBP_B\tSNP_B\tR2\tDP\tD"
    assert len(lines) == 11  # header + all 10 pairs
    first = lines[1].split("\t")
    # CHROM and the real rsIDs come from the VCF columns.
    assert first[:6] == ["19", "44890030", "rs189636588",
                         "19", "44890114", "rs73934845"]
    # Every pair matches the float64 reference at 4 dp.
    from .fixtures import synthetic_t7_reference_pairs

    ref = synthetic_t7_reference_pairs()
    for ln in lines[1:]:
        c = ln.split("\t")
        d, dp, r2 = ref[(int(c[1]), int(c[4]))]
        assert c[6:] == [repr(round(r2, 4)), repr(round(dp, 4)),
                         repr(round(d, 4))]
    # Stats are the same numbers as the default format, reordered R2/DP/D.
    assert main(["--file", vcf]) == 0
    ref = capsys.readouterr().out.strip().splitlines()[1].split("\t")
    assert first[6:] == [ref[4], ref[3], ref[2]]
    # Tiled streaming emits identical bytes (same tile order as tsv mode).
    assert main(["--file", vcf, "--out-format", "plink",
                 "--engine", "tiled"]) == 0
    assert capsys.readouterr().out == out


def test_plink_format_fasta_and_file_output(tmp_path, capsys):
    path = tmp_path / "e.fasta"
    write_fasta(path, ["ATAA", "TAAA", "TAAA", "TAAA", "T-AA",
                       "TTAA", "TTAA", "TTAA", "TTAA", "TTAY"])
    assert main(["--file", str(path), "--out-format", "plink"]) == 0
    out = capsys.readouterr().out
    assert out.strip().splitlines()[1].split("\t")[:6] == \
        ["0", "0", "site0", "0", "1", "site1"]
    # File output via run_to_tsv (tiled, unsorted) matches stdout rows.
    dst = tmp_path / "pairs.ld"
    assert main(["--file", str(path), "--out-format", "plink",
                 "--engine", "tiled", "--pair-output", str(dst)]) == 0
    capsys.readouterr()
    assert dst.read_text() == out


def test_plink_format_in_checkpoint_fingerprint(tmp_path):
    """A resume cannot silently mix tsv and plink rows in one file: the
    output format participates in run_to_tsv's checkpoint fingerprint
    (every other fingerprint input held identical)."""
    import numpy as np

    from weightedld.io.writer import PairAnnot
    from weightedld.runtime.driver import DriverConfig, run_to_tsv

    rng = np.random.default_rng(0)
    aln = (rng.integers(0, 2, size=(24, 32)) * 3).astype(np.int8)
    w = np.ones(24, np.float32)
    sm = np.arange(32, dtype=np.int64)
    cfg = DriverConfig(tile=16, tiles_per_shard_batch=1)
    part = tmp_path / "pairs.tsv"

    class Stop(Exception):
        pass

    import weightedld.runtime.driver as drv

    orig = drv.LdSession.stream

    def limited_stream(*args, **kwargs):
        for item in orig(*args, **kwargs):
            yield item
            if not kwargs.get("start_batch"):
                raise Stop

    drv.LdSession.stream = limited_stream
    try:
        with pytest.raises(Stop):
            run_to_tsv(aln, w, sm, part, cfg)
    finally:
        drv.LdSession.stream = orig
    assert part.with_suffix(part.suffix + ".ckpt.json").exists()

    annot = PairAnnot({int(p): "0" for p in sm},
                      {int(p): f"site{p}" for p in sm})
    with pytest.raises(RuntimeError, match="different run"):
        run_to_tsv(aln, w, sm, part, cfg, annot=annot)
    # Resuming in the ORIGINAL format still works and finishes the file.
    run_to_tsv(aln, w, sm, part, cfg)
    assert part.read_text().startswith("posa\tposb\t")
    # A fresh plink run writes the plink header and rows.
    dst = tmp_path / "pairs.ld"
    run_to_tsv(aln, w, sm, dst, cfg, annot=annot)
    body = dst.read_text()
    assert body.startswith("CHR_A\tBP_A\tSNP_A\t")
    assert "\tsite0\t" in body


def test_plink_duplicate_pos_conflict(tmp_path, capsys):
    header = ("##fileformat=VCFv4.1\n"
              "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t"
              + "\t".join(f"s{i}" for i in range(14)))
    gts = "\t".join(["0|1"] * 7 + ["1|0"] * 7)
    rows = [f"chr1\t100\trsA\tA\tT\t.\t.\t.\tGT\t{gts}",
            f"chr1\t200\trsA2\tA\tT\t.\t.\t.\tGT\t{gts}",
            f"chr2\t100\trsB\tA\tT\t.\t.\t.\tGT\t{gts}",
            f"chr2\t200\trsB2\tA\tT\t.\t.\t.\tGT\t{gts}"]
    f = tmp_path / "dup.vcf"
    f.write_text(header + "\n" + "\n".join(rows) + "\n")
    assert main(["--file", str(f), "--out-format", "plink"]) == 2
    err = capsys.readouterr().err
    assert "two chromosomes" in err and "--chrom/--region" in err
    # Per-chromosome runs are fine.
    assert main(["--file", str(f), "--out-format", "plink",
                 "--chrom", "chr2"]) == 0
    out = capsys.readouterr().out
    assert "chr2\t100\trsB" in out and "rsA" not in out
    # Same-chromosome ID collision (multi-allelic split, e.g. bcftools
    # norm -m-): plink output stays OBTAINABLE — first-seen id + warning.
    rows2 = [f"chr1\t100\trsSNP\tA\tT\t.\t.\t.\tGT\t{gts}",
             f"chr1\t100\trsINDEL\tA\tAT\t.\t.\t.\tGT\t{gts}",
             f"chr1\t200\trsC\tA\tT\t.\t.\t.\tGT\t{gts}"]
    f2 = tmp_path / "dupid.vcf"
    f2.write_text(header + "\n" + "\n".join(rows2) + "\n")
    assert main(["--file", str(f2), "--out-format", "plink"]) == 0
    captured = capsys.readouterr()
    assert "first-seen id" in captured.err
    assert "rsSNP" in captured.out and "rsINDEL" not in captured.out


def test_plink_mode_validations(tmp_path, capsys):
    from .fixtures import synthetic_t7_path

    vcf = synthetic_t7_path()

    assert main(["--file", vcf, "--out-format", "plink",
                 "--stats-only"]) == 2
    assert "only applies to pair-record" in capsys.readouterr().err
    assert main(["--load-prepared", str(tmp_path / "x.npz"),
                 "--out-format", "plink"]) == 2
    assert "needs --file" in capsys.readouterr().err
    # --top emits pair records: plink applies.
    assert main(["--file", vcf, "--out-format", "plink", "--top", "2"]) == 0
    out = capsys.readouterr().out
    assert out.startswith("CHR_A\t") and len(out.strip().splitlines()) == 3


# ---------------------------------------------------------------------------
# --cross-regions (rectangular / inter-region LD, round 5).


def test_cross_regions_t7_matches_triangle_rows(capsys):
    from .fixtures import synthetic_t7_path

    vcf = synthetic_t7_path()

    # A = the first two t7 sites, B = the last three: the cross output must
    # be EXACTLY the 6 corresponding rows of the full-triangle run (A u B
    # covers all 5 sites, so the combined Henikoff weights coincide).
    assert main(["--file", vcf]) == 0
    full = capsys.readouterr().out.strip().splitlines()
    assert main(["--file", vcf, "--cross-regions",
                 "19:44890000-44890120", "19:44890150-44890200"]) == 0
    cross = capsys.readouterr().out.strip().splitlines()
    a_pos = {"44890030", "44890114"}
    want = [ln for ln in full[1:]
            if ln.split("\t")[0] in a_pos
            and ln.split("\t")[1] not in a_pos]
    assert cross[0] == full[0]
    assert cross[1:] == want
    assert len(cross) == 7


def test_cross_regions_multichrom_plink(tmp_path, capsys):
    header = ("##fileformat=VCFv4.1\n"
              "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t"
              + "\t".join(f"s{i}" for i in range(14)))
    gts = "\t".join(["0|1"] * 7 + ["1|0"] * 7)
    # chr1 and chr2 SHARE POS values — per-endpoint identity maps must keep
    # them apart (CHR_A=chr1, CHR_B=chr2 on every row).
    rows = [f"chr1\t100\trsA1\tA\tT\t.\t.\t.\tGT\t{gts}",
            f"chr1\t200\trsA2\tA\tT\t.\t.\t.\tGT\t{gts}",
            f"chr2\t100\trsB1\tA\tT\t.\t.\t.\tGT\t{gts}",
            f"chr2\t200\trsB2\tA\tT\t.\t.\t.\tGT\t{gts}"]
    f = tmp_path / "two.vcf"
    f.write_text(header + "\n" + "\n".join(rows) + "\n")
    assert main(["--file", str(f), "--cross-regions", "chr1", "chr2",
                 "--out-format", "plink"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 5  # header + 2x2 rectangle
    for ln in lines[1:]:
        c = ln.split("\t")
        assert c[0] == "chr1" and c[3] == "chr2"
        assert c[2].startswith("rsA") and c[5].startswith("rsB")
    # Identical GT columns -> every cross pair at r2 == 1.
    assert all(ln.split("\t")[6] == "1.0" for ln in lines[1:])


def test_cross_regions_validations(tmp_path, capsys):
    from .fixtures import synthetic_t7_path

    vcf = synthetic_t7_path()

    # Overlap refused.
    assert main(["--file", vcf, "--cross-regions",
                 "19:1-100", "19:50-200"]) == 2
    assert "overlap" in capsys.readouterr().err
    # Same chromosome unbounded overlaps itself.
    assert main(["--file", vcf, "--cross-regions", "19", "19"]) == 2
    assert "overlap" in capsys.readouterr().err
    # Engine dense refused.
    assert main(["--file", vcf, "--cross-regions",
                 "19:1-2", "19:3-4", "--engine", "dense"]) == 2
    assert "tiled engine" in capsys.readouterr().err
    # Window flags refused.
    assert main(["--file", vcf, "--cross-regions",
                 "19:1-2", "19:3-4", "--max-distance", "5"]) == 2
    assert "exclusive" in capsys.readouterr().err
    # FASTA refused.
    fa = tmp_path / "x.fasta"
    fa.write_text(">a\nACGT\n>b\nACGA\n>c\nTCGA\n")
    assert main(["--file", str(fa), "--cross-regions", "a:1-2", "b:3-4"]) == 2
    assert "VCF" in capsys.readouterr().err
    # Empty region -> clean error.
    assert main(["--file", vcf, "--cross-regions",
                 "19:1-2", "19:44890150-44890200"]) == 2
    assert "no variant records" in capsys.readouterr().err
    # Cross-chromosome decay refused (POS distance is meaningless there).
    assert main(["--file", vcf, "--cross-regions", "18", "19",
                 "--ld-decay", "0,100,1000"]) == 2
    assert "ONE chromosome" in capsys.readouterr().err


def test_cross_regions_stats_and_top(capsys):
    from .fixtures import synthetic_t7_path

    vcf = synthetic_t7_path()

    args = ["--file", vcf, "--cross-regions",
            "19:44890000-44890120", "19:44890150-44890200"]
    assert main(args + ["--stats-only"]) == 0
    import json as _json

    summ = _json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summ["n_pairs"] == 6
    assert main(args + ["--top", "2"]) == 0
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 3
    for ln in out[1:]:
        pa, pb = (int(x) for x in ln.split("\t")[:2])
        assert pa <= 44890120 < pb


def test_dash_output_means_stdout(tmp_path, capsys, monkeypatch):
    monkeypatch.chdir(tmp_path)
    path = tmp_path / "e.fasta"
    write_fasta(path, ["ATAA", "TAAA", "TTAA", "TTAA"])
    assert main(["--file", str(path), "--weights-output", "-",
                 "--pair-output", "-"]) == 0
    out = capsys.readouterr().out
    assert out.startswith("sequence\tweight\n")
    assert "posa\tposb" in out
    assert not (tmp_path / "-").exists()


def test_streamed_fasta_monomorphic_matches_batch(tmp_path, capsys):
    """Fully conserved alignment: streamed FASTA must exit like the batch
    path (header only), not crash in the majmin verdict on 0 kept sites."""
    path = tmp_path / "mono.fasta"
    write_fasta(path, ["AAAA"] * 6)
    assert main(["--file", str(path), "--engine", "tiled"]) == 0
    batch = capsys.readouterr().out
    assert main(["--file", str(path), "--engine", "tiled",
                 "--stream-ingest"]) == 0
    assert capsys.readouterr().out == batch


def test_checkpoint_rejects_stdout_output(tmp_path, capsys):
    path = tmp_path / "e.fasta"
    write_fasta(path, ["ATAA", "TAAA", "TTAA", "TTAA"])
    assert main(["--file", str(path), "--engine", "tiled",
                 "--pair-output", "-", "--checkpoint"]) == 2
    assert "real --pair-output file" in capsys.readouterr().err


def test_version_flag(capsys):
    with pytest.raises(SystemExit) as e:
        main(["--version"])
    assert e.value.code == 0
    out = capsys.readouterr().out
    import weightedld

    assert weightedld.__version__ in out


def test_prune_plink_emits_snp_ids(capsys):
    from .fixtures import (
        SYN7_IDS,
        SYN7_POS,
        synthetic_t7_path,
        synthetic_t7_reference_pairs,
    )

    vcf = synthetic_t7_path()
    # Reference check of the expectation: every pair conflicts at 0.013
    # and site 1 has the highest minor-allele frequency, so the greedy
    # MAF sweep keeps exactly that hub.
    ref = synthetic_t7_reference_pairs()
    assert len(ref) == 10 and min(v[2] for v in ref.values()) > 0.013
    from weightedld.io.vcf import read_vcf

    aln, _sm = read_vcf(vcf)
    maf = np.minimum((aln == 1).mean(axis=0), (aln == 0).mean(axis=0))
    assert int(np.argmax(maf)) == 1
    assert main(["--file", vcf, "--prune-r2", "0.013"]) == 0
    assert capsys.readouterr().out.strip() == str(SYN7_POS[1])
    assert main(["--file", vcf, "--prune-r2", "0.013",
                 "--out-format", "plink"]) == 0
    out = capsys.readouterr()
    assert out.out.strip() == SYN7_IDS[1]  # plink --extract file format
    assert "ignored" not in out.err  # no spurious auto-engine warning


def test_cross_regions_matrix_output(tmp_path, capsys):
    from .fixtures import synthetic_t7_path

    vcf = synthetic_t7_path()

    dst = tmp_path / "m.npz"
    assert main(["--file", vcf, "--cross-regions",
                 "19:44890000-44890120", "19:44890150-44890200",
                 "--matrix-output", str(dst)]) == 0
    capsys.readouterr()
    z = np.load(dst)
    keep = z["keep"]
    assert keep.shape == (5, 5)
    ij = np.argwhere(keep)
    # Rectangle: rows from block A (sites 0-1), cols from block B (2-4).
    assert len(ij) == 6
    assert (ij[:, 0] < 2).all() and (ij[:, 1] >= 2).all()
    assert np.isfinite(z["r2"][keep]).all()
    assert np.isnan(z["r2"][~keep]).all()


def test_cross_prune_plink_ids_cover_both_blocks(tmp_path, capsys):
    """Pruned survivors from block B keep their SNP ids (regression:
    the prune output consulted only the block-A identity map)."""
    header = ("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t"
              + "\t".join(f"s{i}" for i in range(14)))
    gts1 = "\t".join(["0|1"] * 7 + ["1|0"] * 7)
    gts2 = "\t".join(["1|0"] * 7 + ["0|1"] * 7)
    rows = [f"chr1\t100\trsA1\tA\tT\t.\t.\t.\tGT\t{gts1}",
            f"chr1\t200\trsA2\tA\tT\t.\t.\t.\tGT\t{gts2}",
            f"chr1\t600\trsB1\tA\tT\t.\t.\t.\tGT\t{gts1}",
            f"chr1\t700\trsB2\tA\tT\t.\t.\t.\tGT\t{gts2}"]
    f = tmp_path / "x.vcf"
    f.write_text(header + "\n" + "\n".join(rows) + "\n")
    assert main(["--file", str(f), "--cross-regions", "chr1:1-300",
                 "chr1:500-800", "--prune-r2", "1.01",
                 "--out-format", "plink"]) == 0
    ids = set(capsys.readouterr().out.split())
    # Threshold above 1: no conflicts, every site survives WITH its id.
    assert ids == {"rsA1", "rsA2", "rsB1", "rsB2"}


def test_plink_header_on_empty_result(tmp_path, capsys):
    """<2 surviving sites in plink mode emits the PLINK header, not tsv."""
    path = tmp_path / "mono.fasta"
    write_fasta(path, ["AAAA"] * 6)
    assert main(["--file", str(path), "--out-format", "plink"]) == 0
    assert capsys.readouterr().out == \
        "CHR_A\tBP_A\tSNP_A\tCHR_B\tBP_B\tSNP_B\tR2\tDP\tD\n"


def test_cross_regions_rejects_site_stats(capsys):
    from .fixtures import synthetic_t7_path

    vcf = synthetic_t7_path()

    assert main(["--file", vcf, "--cross-regions", "19:1-2", "19:3-4",
                 "--site-stats", "-"]) == 2
    assert "--site-stats" in capsys.readouterr().err


def test_site_annotations_multi_one_pass():
    from .fixtures import synthetic_t7_path

    vcf = synthetic_t7_path()
    from weightedld.io.vcf import (
        VcfError,
        site_annotations,
        site_annotations_multi,
    )

    a, b = site_annotations_multi(
        vcf, [("19", (44890000, 44890120)), ("19", (44890150, 44890200))])
    sa = site_annotations(vcf, "19", (44890000, 44890120))
    sb = site_annotations(vcf, "19", (44890150, 44890200))
    assert a[0].tolist() == sa[0].tolist() and a[2] == sa[2]
    assert b[0].tolist() == sb[0].tolist() and b[2] == sb[2]
    with pytest.raises(VcfError, match="no variant records"):
        site_annotations_multi(vcf, [("19", (1, 2))])
