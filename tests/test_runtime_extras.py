"""Session summarize, prepared-input cache, profiling, fast VCF parsing."""

import json

import numpy as np
import pytest

from weightedld.cli import main
from weightedld.runtime.driver import DriverConfig, LdSession

from .fixtures import ALL_FASTAS, random_alignment, write_fasta


def test_session_summarize_matches_dense(rng):
    import jax.numpy as jnp

    from weightedld.core.ld_dense import ld_all_pairs_dense

    aln = random_alignment(rng, 32, 64)
    w = np.ones(32, dtype=np.float32)
    sess = LdSession(aln, w, np.arange(64),
                     DriverConfig(tile=16, r2_threshold=0.2))
    summary = sess.summarize()

    stats = ld_all_pairs_dense(jnp.asarray(aln), jnp.asarray(w))
    keep = np.triu(np.asarray(stats.keep), k=1)
    r2 = np.asarray(stats.r2)
    assert summary["n_pairs"] == int(keep.sum())
    assert summary["n_over_threshold"] == int((keep & (r2 > 0.2)).sum())
    np.testing.assert_allclose(
        summary["r2_sum_over_threshold"], r2[keep & (r2 > 0.2)].sum(),
        rtol=1e-5,
    )
    np.testing.assert_allclose(summary["r2_max"], r2[keep].max(), rtol=1e-6)


def test_prepared_cache_roundtrip(tmp_path, capsys):
    f = tmp_path / "t3.fasta"
    write_fasta(f, ALL_FASTAS["t3"])
    npz = tmp_path / "prep.npz"

    rc = main(["--file", str(f), "--save-prepared", str(npz)])
    direct = capsys.readouterr().out
    assert rc == 0 and npz.exists()

    rc = main(["--load-prepared", str(npz)])
    cached = capsys.readouterr().out
    assert rc == 0
    assert cached == direct


def test_cli_stats_only_tiled(tmp_path, capsys):
    f = tmp_path / "t1.fasta"
    write_fasta(f, ALL_FASTAS["t1"])
    rc, out = main(["--file", str(f), "--stats-only", "--engine", "tiled",
                    "--tile", "16"]), capsys.readouterr().out
    stats = json.loads(out)
    assert stats["n_pairs"] == 10
    assert stats["r2_max"] == pytest.approx(1.0, abs=1e-5)


def test_stage_timer():
    from weightedld.runtime.profiling import StageTimer

    t = StageTimer()
    with t.stage("a"):
        pass
    with t.stage("b"):
        pass
    assert set(t.spans) == {"a", "b"}
    assert "total" in t.report()


def test_multihost_single_process_noop():
    from weightedld.parallel.multihost import (
        global_mesh,
        initialize_distributed,
        is_output_process,
    )

    initialize_distributed()  # must not raise in single-process mode
    assert is_output_process()
    mesh = global_mesh()
    assert mesh.devices.size >= 1


def test_fast_gt_block_parser():
    from weightedld.io.vcf import _fast_parse_gt_block

    row = _fast_parse_gt_block("0|1\t.|.\t1/0\t5|0")
    assert row is not None
    assert row.tolist() == [0, 1, 4, 4, 4, 4, 5, 0]
    # Fallback cases: out-of-range alleles, multi-digit, FORMAT subfields,
    # haploid
    assert _fast_parse_gt_block("9|0\t0|1") is None
    assert _fast_parse_gt_block("10|2\t0|1") is None
    assert _fast_parse_gt_block("0|1:35\t0|1:12") is None
    assert _fast_parse_gt_block("0\t1") is None


def test_fast_and_slow_vcf_paths_agree(tmp_path):
    from weightedld.io.vcf import read_vcf

    header = ("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t"
              + "\t".join(f"s{i}" for i in range(14)))
    gts_fast = ["0|1"] * 7 + [".|."] * 3 + ["1/1"] * 4
    gts_slow = [g + ":99" for g in gts_fast]  # FORMAT subfield -> slow path
    body_f = "1\t100\t.\tA\tT\t.\t.\t.\tGT\t" + "\t".join(gts_fast)
    body_s = "1\t100\t.\tA\tT\t.\t.\t.\tGT:GQ\t" + "\t".join(gts_slow)

    pf = tmp_path / "fast.vcf"
    pf.write_text(header + "\n" + body_f + "\n")
    ps = tmp_path / "slow.vcf"
    ps.write_text(header + "\n" + body_s + "\n")

    af, _ = read_vcf(pf)
    asl, _ = read_vcf(ps)
    np.testing.assert_array_equal(af, asl)


def test_checkpoint_fingerprint_mismatch_refused(rng, tmp_path):
    from weightedld.runtime.driver import run_to_tsv

    aln = random_alignment(rng, 20, 48)
    w = np.ones(20, dtype=np.float32)
    sm = np.arange(48)
    out = tmp_path / "x.tsv"
    # Plant a checkpoint from a "different run".
    run_to_tsv(aln, w, sm, out, DriverConfig(tile=16))
    out.with_suffix(".tsv.ckpt.json").write_text(
        '{"next_batch": 1, "byte_offset": 10, "n_records": 1, '
        '"fingerprint": "deadbeef"}'
    )
    with pytest.raises(RuntimeError, match="different run"):
        run_to_tsv(aln, w, sm, out, DriverConfig(tile=16))


def test_load_prepared_flag_mismatch_warns(tmp_path, capsys):
    from .fixtures import ALL_FASTAS, write_fasta as _wf

    f = tmp_path / "t5.fasta"
    _wf(f, ALL_FASTAS["t5"])
    npz = tmp_path / "prep.npz"
    assert main(["--file", str(f), "--save-prepared", str(npz)]) == 0
    capsys.readouterr()
    assert main(["--load-prepared", str(npz), "--unweighted"]) == 0
    err = capsys.readouterr().err
    assert "ignores preparation flags" in err and "unweighted" in err


def test_resolve_tile_auto():
    # Explicit tile always wins; auto resolves to TILE_AUTO for every
    # engine and input (no device-dependent rule).
    import numpy as np

    from weightedld.runtime.driver import TILE_AUTO, resolve_tile

    aln = np.zeros((4, 8), dtype=np.int8)
    assert resolve_tile(64) == 64
    assert resolve_tile(None) == TILE_AUTO
    # A session records the resolved tile on ITS OWN config copy; the
    # caller's config is never mutated (one DriverConfig can be reused
    # across sessions with different inputs).
    from weightedld.runtime.driver import DriverConfig, LdSession

    for engine in ("xla", "auto"):
        cfg = DriverConfig(engine=engine)
        sess = LdSession(aln, np.ones(4, np.float32), np.arange(8), cfg)
        assert sess.cfg.tile == TILE_AUTO
        assert cfg.tile is None
        assert cfg.tiles_per_shard_batch is None


def test_resolve_seq_chunk_auto():
    # The sequence axis pads to a multiple of DEFAULT_SEQ_CHUNK unless an
    # explicit multiple is given; the padded width is what the session's
    # weight rows and code buffer carry.
    from weightedld.core.majmin import DEFAULT_SEQ_CHUNK
    from weightedld.runtime.driver import resolve_seq_chunk

    assert resolve_seq_chunk(512) == 512         # explicit wins
    assert resolve_seq_chunk(None) == DEFAULT_SEQ_CHUNK
    # The session resolves seq_chunk onto its own config copy and pads N
    # to it.
    import numpy as np

    from weightedld.runtime.driver import DriverConfig, LdSession

    aln = np.zeros((4, 8), dtype=np.int8)
    aln[:2, 1] = 1
    cfg = DriverConfig()
    sess = LdSession(aln, np.ones(4, np.float32), np.arange(8), cfg)
    assert sess.cfg.seq_chunk == DEFAULT_SEQ_CHUNK
    assert cfg.seq_chunk is None
    assert sess.codes_dev.shape[1] == DEFAULT_SEQ_CHUNK
    assert sess.weights_dev.shape[-1] == DEFAULT_SEQ_CHUNK
    sess = LdSession(aln, np.ones(4, np.float32), np.arange(8),
                     DriverConfig(seq_chunk=16))
    assert sess.codes_dev.shape[1] == 16


def test_seq_chunk_invariance(rng):
    # The pair population and site indices must be IDENTICAL whatever the
    # sequence chunking (auto or explicit, single- or multi-chunk); the
    # f32 stats may differ in reduction order only, through the full
    # driver.
    aln = random_alignment(rng, 150, 40)
    w = (rng.random(150) + 0.05).astype(np.float32)
    sm = np.arange(40)

    def collect(sc):
        sess = LdSession(aln, w, sm, DriverConfig(
            tile=8, seq_chunk=sc))
        recs = [r for _, r in sess.stream()]
        return (
            np.concatenate([r.pos_a for r in recs]),
            np.concatenate([r.pos_b for r in recs]),
            np.concatenate([r.r2 for r in recs]),
        )

    base_a, base_b, base_r2 = collect(None)  # auto padding multiple
    for sc in (64, 128):                     # multi- and 2-chunk paths
        pa, pb, r2 = collect(sc)
        np.testing.assert_array_equal(pa, base_a)
        np.testing.assert_array_equal(pb, base_b)
        np.testing.assert_allclose(r2, base_r2, rtol=2e-6, atol=2e-7)


def test_checkpoint_refuses_weight_quant_switch(rng, tmp_path):
    # A resume must not silently mix quantized and exact r2 values in one
    # TSV: weight_quant is part of the run fingerprint.  Simulate an
    # interrupt after the first batch, then try to resume in a different
    # mode.
    from weightedld.runtime import driver as drv

    aln = random_alignment(rng, 20, 48)
    w = (rng.random(20) + 0.05).astype(np.float32)
    sm = np.arange(48)
    out = tmp_path / "switch.tsv"
    ck = out.with_suffix(".tsv.ckpt.json")

    orig = drv.LdSession.stream

    def one_batch_then_die(*a, **kw):
        for b, rec in orig(*a, **kw):
            yield b, rec
            raise KeyboardInterrupt

    drv.LdSession.stream = one_batch_then_die
    try:
        with pytest.raises(KeyboardInterrupt):
            drv.run_to_tsv(aln, w, sm, out,
                           DriverConfig(tile=16, weight_quant="int8"),
                           checkpoint=True)
    finally:
        drv.LdSession.stream = orig
    assert ck.exists(), "interrupted run should leave a checkpoint"

    # Cross-mode resume: refused.
    with pytest.raises(RuntimeError, match="different run"):
        drv.run_to_tsv(aln, w, sm, out, DriverConfig(tile=16),
                       checkpoint=True)
    # Same-mode resume: accepted, completes, and removes the checkpoint.
    n = drv.run_to_tsv(aln, w, sm, out,
                       DriverConfig(tile=16, weight_quant="int8"),
                       checkpoint=True)
    assert n >= 0 and not ck.exists()


def test_save_prepared_honors_exact_path(tmp_path):
    # np.savez_compressed(path) appends ".npz" to bare paths; save_prepared
    # must write the literal path so --save/--load round-trip.
    from .fixtures import ALL_FASTAS, write_fasta as _wf

    f = tmp_path / "t5.fasta"
    _wf(f, ALL_FASTAS["t5"])
    cache = tmp_path / "prep.cache"  # no .npz suffix
    assert main(["--file", str(f), "--save-prepared", str(cache)]) == 0
    assert cache.exists() and not (tmp_path / "prep.cache.npz").exists()
    assert main(["--load-prepared", str(cache)]) == 0


def test_multiprocess_env_heuristics(monkeypatch):
    from weightedld.parallel.multihost import _multiprocess_env

    for var in ("JAX_COORDINATOR_ADDRESS", "COORDINATOR_ADDRESS",
                "SLURM_NTASKS", "SLURM_PROCID", "SLURM_STEP_NUM_TASKS"):
        monkeypatch.delenv(var, raising=False)
    assert not _multiprocess_env()
    # sbatch batch step (no srun): NTASKS set but the step has one task —
    # must stay local, not hang at the coordinator barrier.
    monkeypatch.setenv("SLURM_NTASKS", "8")
    monkeypatch.setenv("SLURM_PROCID", "0")
    assert not _multiprocess_env()
    # srun-launched multi-task step: distributed.
    monkeypatch.setenv("SLURM_STEP_NUM_TASKS", "8")
    assert _multiprocess_env()
    monkeypatch.delenv("SLURM_STEP_NUM_TASKS")
    monkeypatch.setenv("JAX_COORDINATOR_ADDRESS", "h:1234")
    assert _multiprocess_env()


def test_vcf_negative_allele_rejected(tmp_path):
    import pytest

    from weightedld.io.vcf import VcfError, read_vcf

    header = ("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t"
              + "\t".join(f"s{i}" for i in range(12)))
    body = "1\t100\t.\tA\tT\t.\t.\t.\tGT\t" + "\t".join(["0|-1"] * 12)
    p = tmp_path / "neg.vcf"
    p.write_text(header + "\n" + body + "\n")
    with pytest.raises(VcfError, match="exceeds the supported alphabet"):
        read_vcf(p)


def test_prepared_cache_chrom_mismatch_warns(tmp_path, capsys):
    # chrom participates in the preparation fingerprint: loading a cache
    # prepared WITHOUT a chrom filter while asking for one must warn (and
    # a legacy cache with no 'chrom' key must behave as chrom=None).
    header = ("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t"
              + "\t".join(f"s{i}" for i in range(14)))
    gts = "\t".join(["0|1"] * 7 + ["1|0"] * 7)
    rows = [f"chr1\t{100 + 37 * k}\t.\tA\tT\t.\t.\t.\tGT\t{gts}"
            for k in range(3)]
    f = tmp_path / "c.vcf"
    f.write_text(header + "\n" + "\n".join(rows) + "\n")
    npz = tmp_path / "prep.npz"
    assert main(["--file", str(f), "--save-prepared", str(npz)]) == 0
    capsys.readouterr()

    assert main(["--load-prepared", str(npz), "--chrom", "chr1"]) == 0
    err = capsys.readouterr().err
    assert "ignores preparation flags" in err and "chrom" in err

    # Legacy cache (pre-chrom): strip the key; the warning must still fire
    # (absent keys default to what the old code effectively used: None).
    import json as _json

    data = dict(np.load(npz))
    prep = _json.loads(bytes(data["prep_config"]).decode())
    assert "chrom" in prep
    del prep["chrom"]
    data["prep_config"] = np.frombuffer(
        _json.dumps(prep).encode(), dtype=np.uint8)
    with open(npz, "wb") as fh:
        np.savez_compressed(fh, **data)
    assert main(["--load-prepared", str(npz), "--chrom", "chr1"]) == 0
    err = capsys.readouterr().err
    assert "ignores preparation flags" in err and "chrom" in err
