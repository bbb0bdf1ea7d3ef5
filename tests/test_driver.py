"""Tiled/sharded streaming driver: equality vs the dense engine, striping
properties, multi-device sharding on the virtual CPU mesh, and TSV
checkpoint/resume."""

import json

import jax
import numpy as np
import pytest

from weightedld.core.ld_dense import extract_records, ld_all_pairs_dense
from weightedld.parallel.triangle import plan_tiles, stripe
from weightedld.runtime.driver import (
    DriverConfig,
    LdSession,
    collect_ld_records,
    run_to_tsv,
)

from .fixtures import random_alignment

import jax.numpy as jnp


def _records_map(rec):
    return {
        (int(a), int(b)): (float(d), float(r2))
        for a, b, d, r2 in zip(rec.pos_a, rec.pos_b, rec.d, rec.r2)
    }


def _assert_same_records(got, want, atol=1e-5):
    gm, wm = _records_map(got), _records_map(want)
    assert set(gm) == set(wm)
    for k in wm:
        np.testing.assert_allclose(gm[k], wm[k], atol=atol, err_msg=str(k))


def test_plan_covers_triangle():
    plan = plan_tiles(100, 16)
    assert plan.s_pad == 112 and plan.grid == 7
    # every tile (i<=j) exactly once
    seen = set(zip(plan.tile_i.tolist(), plan.tile_j.tolist()))
    assert len(seen) == plan.n_tiles == 7 * 8 // 2
    assert all(i <= j for i, j in seen)


@pytest.mark.parametrize("n_shards", [1, 3, 8])
def test_stripe_partition(n_shards):
    plan = plan_tiles(333, 32)
    ti, tj, emit = stripe(plan, n_shards)
    assert len(ti) % n_shards == 0
    got = sorted(zip(ti[emit].tolist(), tj[emit].tolist()))
    want = sorted(zip(plan.tile_i.tolist(), plan.tile_j.tolist()))
    assert got == want


@pytest.mark.parametrize("tile,kps", [(16, 2), (32, 5), (128, 3)])
def test_tiled_matches_dense(rng, tile, kps):
    aln = random_alignment(rng, n_seqs=48, n_sites=70)
    w = (rng.random(48) + 0.05).astype(np.float32)
    site_map = np.arange(70)

    dense = extract_records(
        ld_all_pairs_dense(jnp.asarray(aln), jnp.asarray(w)), site_map
    )
    tiled = collect_ld_records(
        aln, w, site_map, DriverConfig(tile=tile, tiles_per_shard_batch=kps)
    )
    _assert_same_records(tiled, dense)


def test_sharded_uses_all_devices(rng):
    assert jax.device_count() == 8, "conftest should provide 8 virtual devices"
    aln = random_alignment(rng, n_seqs=32, n_sites=130)
    w = np.ones(32, dtype=np.float32)
    dense = extract_records(
        ld_all_pairs_dense(jnp.asarray(aln), jnp.asarray(w)), np.arange(130)
    )
    tiled = collect_ld_records(
        aln, w, np.arange(130), DriverConfig(tile=16, tiles_per_shard_batch=4)
    )
    _assert_same_records(tiled, dense)


def test_r2_threshold_stream(rng):
    aln = random_alignment(rng, n_seqs=40, n_sites=60)
    w = np.ones(40, dtype=np.float32)
    cfg = DriverConfig(tile=16, r2_threshold=0.3)
    recs = collect_ld_records(aln, w, np.arange(60), cfg)
    assert (recs.r2 > 0.3).all()
    dense = extract_records(
        ld_all_pairs_dense(jnp.asarray(aln), jnp.asarray(w)),
        np.arange(60),
        r2_threshold=0.3,
    )
    _assert_same_records(recs, dense)


def test_determinism_across_runs(rng):
    # XLA SPMD is data-race-free by construction (SURVEY.md §5 race row);
    # the determinism guarantee we keep instead: identical inputs produce
    # bit-identical records across independent sessions.
    aln = random_alignment(rng, 40, 96)
    w = (rng.random(40) + 0.05).astype(np.float32)
    cfg = DriverConfig(tile=16, tiles_per_shard_batch=3)
    a = collect_ld_records(aln, w, np.arange(96), cfg)
    b = collect_ld_records(aln, w, np.arange(96), cfg)
    np.testing.assert_array_equal(a.pos_a, b.pos_a)
    np.testing.assert_array_equal(a.pos_b, b.pos_b)
    np.testing.assert_array_equal(a.d, b.d)
    np.testing.assert_array_equal(a.d_prime, b.d_prime)
    np.testing.assert_array_equal(a.r2, b.r2)


def test_tsv_checkpoint_resume(rng, tmp_path):
    aln = random_alignment(rng, n_seqs=24, n_sites=64)
    w = np.ones(24, dtype=np.float32)
    sm = np.arange(64)
    cfg = DriverConfig(tile=16, tiles_per_shard_batch=1)

    full = tmp_path / "full.tsv"
    n_full = run_to_tsv(aln, w, sm, full, cfg)

    # Simulate an interrupted run: write a partial file by faking a checkpoint
    # after batch 0, then resume.
    part = tmp_path / "part.tsv"

    class Stop(Exception):
        pass

    calls = {"n": 0}
    orig = None
    import weightedld.runtime.driver as drv

    def limited_stream(*args, **kwargs):
        for item in orig(*args, **kwargs):
            yield item
            calls["n"] += 1
            if calls["n"] >= 2 and not kwargs.get("start_batch"):
                raise Stop

    orig, drv.LdSession.stream = drv.LdSession.stream, limited_stream
    try:
        with pytest.raises(Stop):
            run_to_tsv(aln, w, sm, part, cfg)
    finally:
        drv.LdSession.stream = orig

    ckpt = part.with_suffix(part.suffix + ".ckpt.json")
    assert ckpt.exists()
    state = json.loads(ckpt.read_text())
    assert state["next_batch"] == 2

    n_resumed = run_to_tsv(aln, w, sm, part, cfg)
    assert not ckpt.exists()
    assert n_resumed == n_full
    assert part.read_text() == full.read_text()


def test_checkpoint_refuses_any_single_byte_input_change(rng, tmp_path):
    """The fingerprint digests the FULL code matrix: flipping one cell in a
    row the old every-64th-row sampling would have skipped (row 1 at
    n_seqs=128 -> sample step 2) must refuse the resume."""
    aln = random_alignment(rng, n_seqs=128, n_sites=32)
    w = np.ones(128, dtype=np.float32)
    sm = np.arange(32)
    cfg = DriverConfig(tile=16, tiles_per_shard_batch=1)
    part = tmp_path / "part.tsv"

    class Stop(Exception):
        pass

    calls = {"n": 0}
    orig = None
    import weightedld.runtime.driver as drv

    def limited_stream(*args, **kwargs):
        for item in orig(*args, **kwargs):
            yield item
            calls["n"] += 1
            if not kwargs.get("start_batch"):
                raise Stop

    orig, drv.LdSession.stream = drv.LdSession.stream, limited_stream
    try:
        with pytest.raises(Stop):
            run_to_tsv(aln, w, sm, part, cfg)
    finally:
        drv.LdSession.stream = orig
    assert part.with_suffix(part.suffix + ".ckpt.json").exists()

    corrupted = aln.copy()
    corrupted[1, 17] = (corrupted[1, 17] + 1) % 4  # unsampled row under //64
    with pytest.raises(RuntimeError, match="different run"):
        run_to_tsv(corrupted, w, sm, part, cfg)


def test_windowed_ld(rng):
    # --max-distance: same records as a full scan filtered by |j - i| <= W.
    aln = random_alignment(rng, 30, 100)
    w = np.ones(30, dtype=np.float32)
    sm = np.arange(100)
    full = collect_ld_records(aln, w, sm, DriverConfig(tile=16))
    win = collect_ld_records(
        aln, w, sm, DriverConfig(tile=16, max_site_distance=20)
    )
    fm = {(int(a), int(b)): float(d)
          for a, b, d in zip(full.pos_a, full.pos_b, full.d)
          if b - a <= 20}
    wm = {(int(a), int(b)): float(d)
          for a, b, d in zip(win.pos_a, win.pos_b, win.d)}
    assert wm == fm


def test_matrices_match_dense(rng):
    # Square-matrix assembly equals the dense engine on the strict upper
    # triangle; below/at the diagonal and skipped pairs are NaN + keep=False.
    from weightedld.runtime.driver import LdSession

    aln = random_alignment(rng, 24, 70)
    w = (np.abs(rng.normal(size=24)) + 0.1).astype(np.float32)
    sm = np.arange(70)
    sess = LdSession(aln, w, sm, DriverConfig(tile=16))
    mats = sess.matrices()
    stats = ld_all_pairs_dense(jnp.asarray(aln), jnp.asarray(w))
    keep_dense = np.triu(np.asarray(stats.keep), k=1)
    np.testing.assert_array_equal(mats["keep"], keep_dense)
    for key, dense in (("d", stats.d), ("d_prime", stats.d_prime),
                       ("r2", stats.r2)):
        got = mats[key]
        assert np.isnan(got[~keep_dense]).all()
        np.testing.assert_allclose(
            got[keep_dense], np.asarray(dense)[keep_dense], atol=1e-5
        )


def test_wire_overflow_falls_back_byte_exact(rng):
    """A capacity overflow mid-scan (learned caps poisoned low) must fall
    back to the exact gather and still produce byte-identical TSV under
    decimals=4 (the overflow path ships exact f32, whose 4-dp rounding
    equals the wire quantizer by construction)."""
    import io

    from weightedld.io.writer import write_pairs
    from weightedld.runtime.driver import LdSession

    aln = random_alignment(rng, 30, 120)
    w = np.ones(30, np.float32)
    sess = LdSession(aln, w, np.arange(120),
                     DriverConfig(tile=16, tiles_per_shard_batch=2))

    def tsv(**kw):
        buf = io.StringIO()
        for _, rec in sess.stream(**kw):
            write_pairs(rec, buf, header=False)
        return buf.getvalue()

    base = tsv()
    got = tsv(decimals=4)
    # Poison the capacity memory: every batch claims ~zero records, so
    # fused programs run at minimum capacity and overflow on every
    # record-bearing batch.
    sess._batch_caps = {b: 0 for b in range(sess.n_batches)}
    sess._caps_thr = sess.cfg.r2_threshold
    assert tsv(decimals=4) == base == got


def test_batch_caps_invalidated_on_threshold_change(rng):
    from weightedld.runtime.driver import LdSession

    aln = random_alignment(rng, 24, 80)
    sess = LdSession(aln, np.ones(24, np.float32), np.arange(80),
                     DriverConfig(tile=16, tiles_per_shard_batch=2))
    n_all = sum(len(r) for _, r in sess.stream(r2_threshold=None))
    caps_all = dict(sess._batch_caps)
    assert caps_all and max(caps_all.values()) > 0
    n_high = sum(len(r) for _, r in sess.stream(r2_threshold=0.9))
    assert n_high < n_all  # memory re-learned for the new threshold
    assert sess._caps_thr == 0.9
    # Re-scan at the stricter threshold uses the smaller memory; records
    # must equal a fresh session's.
    n_high2 = sum(len(r) for _, r in sess.stream(r2_threshold=0.9))
    assert n_high2 == n_high


def test_gzip_member_writer_roundtrip(tmp_path):
    import gzip

    from weightedld.io.writer import GzipMemberWriter

    p = tmp_path / "m.gz"
    with GzipMemberWriter(p) as fh:
        fh.write("hello\n")
        fh.flush()
        off1 = fh.tell()
        fh.flush()            # empty segment writes no member
        assert fh.tell() == off1
        fh.write("world\n")
    assert gzip.open(p, "rt").read() == "hello\nworld\n"
    # Truncating at a member boundary and appending reproduces the bytes.
    full = p.read_bytes()
    with GzipMemberWriter(p, append_at=off1) as fh:
        fh.write("world\n")
    assert p.read_bytes() == full


def test_factorized_session_matches_general_all_weight_modes(rng):
    """The factorized major/dmin form must yield the same records as the
    forced general per-pair form, through the full session, across EVERY
    weight-arithmetic branch (each reads the weight rows differently): the
    int8x3 default, unit weights (no weighted pass), the lossy int8
    cascade, split_bf16, and a bf16-exact weight vector (drops the
    residual pass entirely)."""
    from dataclasses import replace

    from weightedld.runtime.driver import LdSession

    aln = rng.choice([0, 1, 2, 3], size=(20, 70)).astype(np.int8)
    sm = np.arange(70)
    w_f32 = (rng.random(20) * 0.9 + 0.1).astype(np.float32)
    # bf16-exact, non-unit: f32 -> bf16 -> f32 round-trip is idempotent.
    w_bf16 = np.asarray(jnp.asarray(w_f32).astype(jnp.bfloat16),
                        dtype=np.float32)
    cases = [
        (w_f32, "none"),            # int8x3 default
        (np.ones(20, np.float32), "none"),
        (w_f32, "int8"),
        (w_f32, "split_bf16"),
        (w_bf16, "none"),           # exact-bf16 branch
    ]
    for w, wq in cases:
        cfg = DriverConfig(tile=16, seq_chunk=8, weight_quant=wq)
        s_mm = LdSession(aln, w, sm, cfg)
        s_gen = LdSession(aln, w, sm, replace(cfg, kernel="general"))
        assert s_mm._majmin and not s_gen._majmin
        a = {}
        for _, r in s_mm.stream():
            a.update({(int(x), int(y)): (float(d), float(r2))
                      for x, y, d, r2 in zip(r.pos_a, r.pos_b, r.d, r.r2)})
        b = {}
        for _, r in s_gen.stream():
            b.update({(int(x), int(y)): (float(d), float(r2))
                      for x, y, d, r2 in zip(r.pos_a, r.pos_b, r.d, r.r2)})
        assert a == b and len(a) > 0, (wq, w is w_bf16)


def test_compact_slot_path_matches_sort(rng):
    """The popcount slot compaction (T >= 32) must reproduce the sort
    fallback's records exactly — same sites, values, and (tile, row, col)
    order — across densities, tiles, and the packed wire."""
    import weightedld.core.ld_tiled as lt
    from weightedld.core.paircore import PairStats

    for t, k, dens in ((64, 7, 0.3), (32, 5, 0.9), (64, 3, 0.0),
                       (128, 4, 0.01), (16, 6, 0.5), (16, 9, 0.04)):
        d = rng.normal(size=(k, t, t)).astype(np.float32)
        dp = rng.normal(size=(k, t, t)).astype(np.float32)
        r2 = rng.random((k, t, t)).astype(np.float32)
        keep = rng.random((k, t, t)) < dens
        ti = rng.integers(0, 50, k).astype(np.int32)
        tj = (ti + rng.integers(0, 5, k)).astype(np.int32)
        st = PairStats(d=jnp.asarray(d), d_prime=jnp.asarray(dp),
                       r2=jnp.asarray(r2), keep=jnp.asarray(keep))
        cap = int(keep.sum()) + 7
        args = (st, jnp.asarray(ti), jnp.asarray(tj), jnp.float32(0.2))
        cnt_a, s_a, v_a = lt.compact_tile_stats(*args, tile=t, capacity=cap)
        old = lt._SLOT_BYTES_CAP
        lt._SLOT_BYTES_CAP = 0          # force the sort fallback
        try:
            # capacity + 1: a distinct jit signature, so the static
            # module constant is re-read rather than cache-hit.
            cnt_b, s_b, v_b = lt.compact_tile_stats(*args, tile=t,
                                                    capacity=cap + 1)
        finally:
            lt._SLOT_BYTES_CAP = old
        n = int(cnt_a)
        assert int(cnt_b) == n
        np.testing.assert_array_equal(np.asarray(s_a)[:n],
                                      np.asarray(s_b)[:n])
        np.testing.assert_array_equal(np.asarray(v_a)[:n],
                                      np.asarray(v_b)[:n])
        _cnt, p_c = lt.compact_tile_stats(*args, tile=t, capacity=cap,
                                          wire_scale=10000)
        w0 = np.asarray(p_c)[:n, 0].astype(np.uint32)
        kt = (w0 >> 18).astype(int)
        gi = ti[kt] * t + ((w0 >> 9) & 511)
        gj = tj[kt] * t + (w0 & 511)
        np.testing.assert_array_equal(np.stack([gi, gj], 1),
                                      np.asarray(s_a)[:n])


def test_round_fixed_exact_parity():
    """The compressed-wire quantizer must equal CPython's round(x, d)
    byte-for-byte after formatting — adversarial sweep over exact decimal
    half-ties, near-ties at 1e-7/1e-9, tiny negatives (the -0.0 output
    class), and randoms, at every supported scale."""
    from weightedld.core.ld_tiled import round_fixed_exact

    rng = np.random.default_rng(0)
    for d in (0, 1, 2, 3, 4):
        scale = 10 ** d
        qs = rng.integers(-32000, 32000, size=8000)
        vals = [
            (qs + 0.5) / scale,
            (qs - 0.5) / scale,
            qs / scale + rng.normal(size=8000) * 1e-7,
            qs / scale + rng.normal(size=8000) * 1e-9,
            rng.normal(size=8000) * 0.3,
            np.array([0.0, -0.0, 1e-9, -1e-9, -4.9e-5, 4.9e-5, -5.1e-5,
                      0.95, -0.95, 0.00005, -0.00005, -0.055, -0.0005,
                      0.00065]),
        ]
        x = np.concatenate(vals).astype(np.float32)
        x = x[np.abs(x) * scale < 32000]
        q = np.asarray(round_fixed_exact(jnp.asarray(x), scale,
                                         neg_zero_sentinel=True))
        dec = np.where(q == -(1 << 15), np.float32(-0.0),
                       (q.astype(np.int64) / scale).astype(np.float32))
        bad = [i for i in range(len(x))
               if repr(round(float(dec[i]), d)) != repr(round(float(x[i]),
                                                             d))]
        assert not bad, (d, x[bad[0]], dec[bad[0]])


def test_stream_decimals_wire_byte_exact(rng):
    """stream(decimals=4)'s compressed 12-byte wire must produce
    BYTE-IDENTICAL TSV output to the default f32 records — across the
    8-shard mesh, capacity learning (first scan unfused, later scans
    fused), and repeated scans."""
    import io

    from weightedld.io.writer import write_pairs
    from weightedld.runtime.driver import LdSession

    aln = random_alignment(rng, 40, 200)
    w = (rng.random(40) * 0.9 + 0.1).astype(np.float32)
    sess = LdSession(aln, w, np.arange(200),
                     DriverConfig(tile=16, tiles_per_shard_batch=2))

    def tsv(**kw):
        buf = io.StringIO()
        n = 0
        for _, rec in sess.stream(**kw):
            write_pairs(rec, buf, header=False)
            n += len(rec)
        return buf.getvalue(), n

    base, n0 = tsv()
    for _ in range(2):  # fused path engages once capacity is learned
        got, n = tsv(decimals=4)
        assert n == n0 and got == base
    want3 = io.StringIO()
    for _, rec in sess.stream():
        write_pairs(rec, want3, header=False, ndigits=3)
    # 3-decimal wire vs 3-digit formatting of exact records.
    buf3 = io.StringIO()
    for _, rec in sess.stream(decimals=3):
        write_pairs(rec, buf3, header=False, ndigits=3)
    assert buf3.getvalue() == want3.getvalue()
    with pytest.raises(ValueError, match="decimals"):
        next(iter(sess.stream(decimals=7)))


def test_tile_pair_counts_and_shard_balance():
    """bench.py --pod's live load-balance accounting: per-tile true pair
    counts match brute force, and per-shard sums mirror stripe() exactly
    (summing to S(S-1)/2 for all-pairs plans)."""
    from weightedld.parallel.triangle import (
        pairs_per_shard,
        plan_tiles,
        stripe,
        tile_pair_counts,
    )

    p = plan_tiles(10, 4)
    counts = tile_pair_counts(p)
    for k in range(p.n_tiles):
        i0, j0 = int(p.tile_i[k]) * 4, int(p.tile_j[k]) * 4
        brute = sum(1 for a in range(i0, min(i0 + 4, 10))
                    for b in range(j0, min(j0 + 4, 10)) if a < b)
        assert counts[k] == brute
    for s, t in ((70, 16), (257, 32), (1000, 128)):
        plan = plan_tiles(s, t)
        assert int(tile_pair_counts(plan).sum()) == plan.n_pairs
        for m in (1, 3, 8):
            pps = pairs_per_shard(plan, m)
            assert int(pps.sum()) == plan.n_pairs
            # Mirror of stripe()'s shard-major emit layout.
            ti, tj, emit = stripe(plan, m)
            per = len(ti) // m
            c = tile_pair_counts(plan)
            tile_of = {(int(a), int(b)): int(v) for a, b, v in
                       zip(plan.tile_i, plan.tile_j, c)}
            for d in range(m):
                sl = slice(d * per, (d + 1) * per)
                want = sum(tile_of[(int(a), int(b))]
                           for a, b, e in zip(ti[sl], tj[sl], emit[sl])
                           if e)
                assert want == int(pps[d])


def test_matrices_reduced_precision(rng):
    """matrices(dtype=f16|bf16): identical keep/NaN structure, values
    within the dtype's relative precision of the f32 export (the device-
    side downcast halves the API's transport bytes — PERF.md)."""
    from weightedld.runtime.driver import LdSession

    aln = random_alignment(rng, 20, 60)
    w = (np.abs(rng.normal(size=20)) + 0.1).astype(np.float32)
    sess = LdSession(aln, w, np.arange(60), DriverConfig(tile=16))
    m32 = sess.matrices()
    with pytest.raises(ValueError, match="dtype"):
        sess.matrices(dtype=np.float64)
    for dt, tol in ((np.float16, 2.0 ** -10), (jnp.bfloat16, 2.0 ** -7)):
        m = sess.matrices(dtype=dt)
        np.testing.assert_array_equal(m["keep"], m32["keep"])
        for key in ("d", "d_prime", "r2"):
            assert m[key].dtype == np.dtype(dt)
            got = m[key].astype(np.float32)
            np.testing.assert_array_equal(np.isnan(got), np.isnan(m32[key]))
            np.testing.assert_allclose(
                got[m["keep"]], m32[key][m["keep"]],
                rtol=tol, atol=tol, equal_nan=True)


def test_matrix_output_cli(tmp_path, rng):
    from .fixtures import ALL_FASTAS, write_fasta
    from weightedld.cli import main as cli_main

    src = tmp_path / "e.fasta"
    write_fasta(src, ALL_FASTAS["example"])
    out = tmp_path / "m.npz"
    assert cli_main(["--file", str(src), "--matrix-output", str(out),
                     "--tile", "16"]) == 0
    z = np.load(out)
    assert set(z.files) == {"site_map", "d", "d_prime", "r2", "keep"}
    s = len(z["site_map"])
    assert z["r2"].shape == (s, s)
    # Golden pair (0,1) from SURVEY A.1.
    assert z["keep"][0, 1]
    assert round(float(z["r2"][0, 1]), 4) == 0.2236
    # Reduced-precision export: half the bytes, same structure.
    out16 = tmp_path / "m16.npz"
    assert cli_main(["--file", str(src), "--matrix-output", str(out16),
                     "--matrix-dtype", "float16", "--tile", "16"]) == 0
    z16 = np.load(out16)
    assert z16["r2"].dtype == np.float16
    np.testing.assert_array_equal(z16["keep"], z["keep"])
    assert abs(float(z16["r2"][0, 1]) - float(z["r2"][0, 1])) < 2 ** -10


def test_per_scan_threshold_override(rng):
    # A serving session scans at different r2 thresholds without recompiling;
    # each scan must match a session configured with that threshold.
    from weightedld.runtime.driver import LdSession

    aln = random_alignment(rng, 20, 60)
    w = np.ones(20, dtype=np.float32)
    sm = np.arange(60)
    sess = LdSession(aln, w, sm, DriverConfig(tile=16))  # default: emit all

    def collect(it):
        recs = [r for _, r in it]
        return {
            (int(a), int(b))
            for r in recs for a, b in zip(r.pos_a, r.pos_b)
        }

    all_pairs = collect(sess.stream())
    thr_pairs = collect(sess.stream(r2_threshold=0.3))
    fixed = LdSession(aln, w, sm, DriverConfig(tile=16, r2_threshold=0.3))
    assert thr_pairs == collect(fixed.stream())
    assert thr_pairs <= all_pairs
    # And the session default is untouched by the override.
    assert collect(sess.stream()) == all_pairs
    s_all = sess.summarize()
    s_thr = sess.summarize(r2_threshold=0.3)
    assert s_thr["n_over_threshold"] == len(thr_pairs)
    assert s_all["n_pairs"] == s_thr["n_pairs"] == len(all_pairs)


def test_kept_r2_always_finite_and_engines_agree(rng):
    # Pairs where the count-major allele retains zero post-filter weight
    # are reference-crash cases (masked PA/PB TypeError) and must be
    # SKIPPED — they are exactly the would-be r2 = 0/0 = NaN pairs.  Fuzz
    # adversarial tiny alignments (code-5-heavy, tie-heavy) and demand:
    # every dense record is finite-r2, the tiled engine emits the same
    # record set, and summarize moments stay finite.
    import jax.numpy as jnp

    from weightedld.core.ld_dense import extract_records, ld_all_pairs_dense
    from weightedld.runtime.driver import DriverConfig, LdSession

    for seed in (1, 7, 23, 42, 77):  # seed 1 is a known ex-NaN instance
        r = np.random.default_rng(seed)
        aln = r.integers(0, 6, size=(6, 8)).astype(np.int8)
        w = (r.random(6) + 0.05).astype(np.float32)
        dense = extract_records(
            ld_all_pairs_dense(jnp.asarray(aln), jnp.asarray(w)),
            np.arange(8),
        )
        assert np.isfinite(dense.r2).all(), seed
        sess = LdSession(aln, w, np.arange(8), DriverConfig(tile=8))
        rows = []
        for _, rec in sess.stream():
            rows += list(zip(rec.pos_a, rec.pos_b, rec.r2))
        got = sorted((int(a), int(b)) for a, b, _ in rows)
        want = sorted(zip(dense.pos_a.tolist(), dense.pos_b.tolist()))
        assert got == want, seed
        summ = sess.summarize()
        assert summ["n_pairs"] == len(dense.r2)
        assert np.isfinite(summ["r2_sum_over_threshold"])
        assert summ["r2_max"] is None or np.isfinite(summ["r2_max"])


def test_top_pairs_matches_full_scan(rng):
    from weightedld.runtime.driver import LdSession

    aln = random_alignment(rng, 30, 96)
    w = (rng.random(30) + 0.05).astype(np.float32)
    sm = np.arange(96)
    session = LdSession(aln, w, sm,
                        DriverConfig(tile=16, tiles_per_shard_batch=2))
    full = collect_ld_records(aln, w, sm, DriverConfig(tile=16))
    fm = {(int(a), int(b)): (float(d), float(dp), float(r2))
          for a, b, d, dp, r2 in zip(full.pos_a, full.pos_b, full.d,
                                     full.d_prime, full.r2)}

    top = session.top_pairs(10)
    assert len(top.r2) == 10
    # Values are the 10 largest r2 of the full scan, descending.
    want = np.sort(np.asarray(full.r2))[::-1][:10]
    np.testing.assert_allclose(np.asarray(top.r2), want, rtol=1e-6)
    # Every returned pair is a real record with matching D/D'/r2.
    for a, b, d, dp, r2 in zip(top.pos_a, top.pos_b, top.d, top.d_prime,
                               top.r2):
        fd, fdp, fr2 = fm[(int(a), int(b))]
        np.testing.assert_allclose((d, dp, r2), (fd, fdp, fr2), rtol=1e-6)

    # k beyond the population returns every surviving pair (pad slots
    # filtered), still descending.
    everything = session.top_pairs(10_000)
    assert len(everything.r2) == len(full.r2)
    np.testing.assert_allclose(np.asarray(everything.r2),
                               np.sort(np.asarray(full.r2))[::-1], rtol=1e-6)
    with pytest.raises(ValueError):
        session.top_pairs(0)


def test_bp_window_matches_brute_force(rng):
    # --max-distance-bp semantics: the windowed scan must equal a
    # brute-force bp filter of the full record set, exactly — both the
    # plan-level tile pruning and the in-tile mask (VCF-style irregular
    # positions spanning several tiles).
    from weightedld.runtime.driver import LdSession

    n_seqs, n_sites = 30, 96
    aln = random_alignment(rng, n_seqs, n_sites)
    w = (rng.random(n_seqs) + 0.05).astype(np.float32)
    # Irregular, clumpy positions (some gaps far beyond the window).
    sm = np.cumsum(rng.integers(1, 60, size=n_sites)).astype(np.int64)
    full = collect_ld_records(aln, w, sm, DriverConfig(tile=16))
    for window in (40, 150, 100000):
        ses = LdSession(aln, w, sm,
                        DriverConfig(tile=16, max_bp_distance=window,
                                     tiles_per_shard_batch=2))
        got = set()
        vals = {}
        for _b, rec in ses.stream():
            for a, b, r2 in zip(rec.pos_a, rec.pos_b, rec.r2):
                got.add((int(a), int(b)))
                vals[(int(a), int(b))] = float(r2)
        want = {(int(a), int(b)): float(r2)
                for a, b, r2 in zip(full.pos_a, full.pos_b, full.r2)
                if b - a <= window}
        assert got == set(want), window
        for key in want:
            np.testing.assert_allclose(vals[key], want[key], rtol=1e-6)
        # summarize() sees the same pair population.
        assert ses.summarize()["n_pairs"] == len(want)


def test_bp_window_composes_with_index_window(rng):
    from weightedld.runtime.driver import LdSession

    aln = random_alignment(rng, 25, 80)
    w = np.ones(25, dtype=np.float32)
    sm = np.cumsum(rng.integers(1, 30, size=80)).astype(np.int64)
    full = collect_ld_records(aln, w, sm, DriverConfig(tile=16))
    pos_to_idx = {int(p): i for i, p in enumerate(sm)}
    ses = LdSession(aln, w, sm,
                    DriverConfig(tile=16, max_site_distance=20,
                                 max_bp_distance=120))
    got = set()
    for _b, rec in ses.stream():
        got |= {(int(a), int(b)) for a, b in zip(rec.pos_a, rec.pos_b)}
    want = {(int(a), int(b))
            for a, b in zip(full.pos_a, full.pos_b)
            if b - a <= 120
            and pos_to_idx[int(b)] - pos_to_idx[int(a)] <= 20}
    assert got == want


def test_bp_window_rejects_decreasing_site_map(rng):
    from weightedld.runtime.driver import LdSession

    aln = random_alignment(rng, 10, 20)
    sm = np.arange(20)[::-1].copy()
    with pytest.raises(ValueError, match="non-decreasing"):
        LdSession(aln, np.ones(10, np.float32), sm,
                  DriverConfig(tile=16, max_bp_distance=5))


def test_top_pairs_concentrated_in_one_tile(rng):
    # Adversarial case for the tile-max prefilter: ONE tile holds far more
    # than k of the strongest pairs (a perfect-LD block), while every other
    # tile has a moderately high max.  The prefilter must still return the
    # exact top-k multiset.
    from weightedld.runtime.driver import LdSession

    n_seqs, n_sites = 40, 96
    aln = random_alignment(rng, n_seqs, n_sites)
    # Sites 0..15 (= the first 16x16 tile) perfectly correlated: all the
    # strongest pairs live in tile (0, 0).
    block = (rng.random(n_seqs) < 0.5).astype(np.int8)
    for s in range(16):
        aln[:, s] = block
    w = np.ones(n_seqs, dtype=np.float32)
    sm = np.arange(n_sites)
    session = LdSession(aln, w, sm,
                        DriverConfig(tile=16, tiles_per_shard_batch=3))
    full = collect_ld_records(aln, w, sm, DriverConfig(tile=16))
    for k in (5, 12, 40):
        top = session.top_pairs(k)
        want = np.sort(np.asarray(full.r2))[::-1][:k]
        np.testing.assert_allclose(np.asarray(top.r2), want, rtol=1e-6)


def test_ld_decay_matches_full_scan(rng):
    from weightedld.runtime.driver import LdSession

    aln = random_alignment(rng, 30, 96)
    w = (rng.random(30) + 0.05).astype(np.float32)
    # Non-trivial site_map: distances are measured in map units (bp), not
    # kept-index units.
    sm = (np.arange(96) * 37 + 11).astype(np.int64)
    session = LdSession(aln, w, sm,
                        DriverConfig(tile=16, tiles_per_shard_batch=2))
    edges = [0, 100, 500, 1000, 5000]
    out = session.ld_decay(edges)

    full = collect_ld_records(aln, w, sm, DriverConfig(tile=16))
    dist = np.asarray(full.pos_b) - np.asarray(full.pos_a)
    r2 = np.asarray(full.r2, dtype=np.float64)
    adp = np.abs(np.asarray(full.d_prime, dtype=np.float64))
    dp_ok = np.isfinite(adp)
    for b in range(len(edges) - 1):
        m = (dist >= edges[b]) & (dist < edges[b + 1])
        assert out["n_pairs"][b] == int(m.sum()), b
        np.testing.assert_allclose(out["r2_sum"][b], r2[m].sum(),
                                   rtol=1e-5, err_msg=str(b))
        if m.any():
            np.testing.assert_allclose(out["r2_mean"][b], r2[m].mean(),
                                       rtol=1e-5)
        else:
            assert out["r2_mean"][b] is None
        # |D'| statistics: finite-D' kept pairs only.
        mf = m & dp_ok
        assert out["n_d_prime_finite"][b] == int(mf.sum()), b
        np.testing.assert_allclose(out["abs_d_prime_sum"][b], adp[mf].sum(),
                                   rtol=1e-5, err_msg=str(b))
        if mf.any():
            np.testing.assert_allclose(out["abs_d_prime_mean"][b],
                                       adp[mf].mean(), rtol=1e-5)
        else:
            assert out["abs_d_prime_mean"][b] is None
    # Every kept pair lands in some bin when the edges cover the range.
    assert sum(out["n_pairs"]) == len(r2)

    with pytest.raises(ValueError):
        session.ld_decay([5, 5])
    with pytest.raises(ValueError):
        session.ld_decay([7])


def test_prune_matches_greedy_oracle(rng):
    from weightedld.runtime.driver import LdSession

    aln = random_alignment(rng, 40, 80)
    w = np.ones(40, dtype=np.float32)
    sm = (np.arange(80) * 3 + 5)  # non-trivial positions
    thr = 0.25
    session = LdSession(aln, w, sm,
                        DriverConfig(tile=16, tiles_per_shard_batch=2))
    full = collect_ld_records(aln, w, sm, DriverConfig(tile=16))
    over = [(int(a), int(b)) for a, b, r in
            zip(full.pos_a, full.pos_b, full.r2) if r > thr]
    over.sort()

    # Independent greedy oracle (reference-definition MAF).
    counts = np.stack([(aln == c).sum(axis=0) for c in range(5)])
    major = counts.max(axis=0)
    maf = (counts.sum(axis=0) - major) / np.maximum(counts.sum(axis=0), 1)
    idx = {int(p): i for i, p in enumerate(sm)}
    for rule in ("maf", "first"):
        kept = np.ones(80, dtype=bool)
        for qa, qb in over:
            a, b = idx[qa], idx[qb]
            if kept[a] and kept[b]:
                if rule == "maf" and maf[a] < maf[b]:
                    kept[a] = False
                else:
                    kept[b] = False
        got = session.prune(thr, rule=rule)
        np.testing.assert_array_equal(got, sm[kept], err_msg=rule)

    # Post-condition: no surviving pair between kept sites exceeds thr.
    kept_set = set(int(p) for p in session.prune(thr))
    for a, b, r in zip(full.pos_a, full.pos_b, full.r2):
        if int(a) in kept_set and int(b) in kept_set:
            assert r <= thr
    # Degenerate: threshold above every r2 keeps everything.
    assert len(session.prune(1.1)) == 80
    with pytest.raises(ValueError):
        session.prune(0.2, rule="bogus")


def test_prune_windowed(rng):
    # With --max-distance, only in-window conflicts prune.
    from weightedld.runtime.driver import LdSession

    aln = random_alignment(rng, 24, 60)
    w = np.ones(24, dtype=np.float32)
    sm = np.arange(60)
    sess_w = LdSession(aln, w, sm,
                       DriverConfig(tile=16, max_site_distance=8))
    kept = set(int(p) for p in sess_w.prune(0.3))
    full = collect_ld_records(aln, w, sm, DriverConfig(tile=16))
    for a, b, r in zip(full.pos_a, full.pos_b, full.r2):
        if b - a <= 8 and int(a) in kept and int(b) in kept:
            assert r <= 0.3


def test_structured_ld_blocks():
    # Block-correlated alignment: 4 blocks of 6 identical sites -> within-
    # block r2 == 1.0 exactly, across-block r2 = noise.  Every analytics
    # surface must agree on the structure.
    from weightedld.runtime.driver import LdSession

    rng = np.random.default_rng(7)
    n, n_blocks, bs = 60, 4, 6
    s_sites = n_blocks * bs
    hap = rng.integers(0, 2, size=(n, n_blocks))
    assert all(0 < hap[:, b].sum() < n for b in range(n_blocks))
    aln = (np.repeat(hap, bs, axis=1) * 3).astype(np.int8)  # codes 0 / 3
    w = np.ones(n, dtype=np.float32)
    sm = np.arange(s_sites)

    def block(i):
        return i // bs

    full = collect_ld_records(aln, w, sm, DriverConfig(tile=16))
    within = {(int(a), int(b)) for a, b in zip(full.pos_a, full.pos_b)
              if block(a) == block(b)}
    assert len(within) == n_blocks * bs * (bs - 1) // 2
    max_cross = max(r for a, b, r in zip(full.pos_a, full.pos_b, full.r2)
                    if block(a) != block(b))
    assert max_cross < 0.5, "seed must separate blocks"

    sess = LdSession(aln, w, sm, DriverConfig(tile=16))
    # Thresholded records = exactly the within-block pairs.
    got = {(int(a), int(b)) for _, rec in sess.stream(r2_threshold=0.5)
           for a, b in zip(rec.pos_a, rec.pos_b)}
    assert got == within
    assert sess.summarize(r2_threshold=0.5)["n_over_threshold"] == len(within)
    # Top-|within| pairs are all within-block at r2 == 1.0.
    top = sess.top_pairs(len(within))
    assert {(int(a), int(b)) for a, b in zip(top.pos_a, top.pos_b)} == within
    np.testing.assert_allclose(np.asarray(top.r2), 1.0, atol=1e-5)
    # Decay: short-range bin (within block span) has higher mean r2.
    dec = sess.ld_decay([1, bs, s_sites])
    assert dec["r2_mean"][0] > 0.5 > dec["r2_mean"][1]
    # Pruning at 0.5 keeps exactly the first site of each block under the
    # 'first' rule (all within-block pairs conflict; none across).
    kept = sess.prune(0.5, rule="first")
    assert kept.tolist() == [b * bs for b in range(n_blocks)]


def test_r2_histogram_matches_full_scan(rng):
    from weightedld.runtime.driver import LdSession

    aln = random_alignment(rng, 30, 96)
    w = (rng.random(30) + 0.05).astype(np.float32)
    sm = np.arange(96)
    session = LdSession(aln, w, sm,
                        DriverConfig(tile=16, tiles_per_shard_batch=2))
    edges = [0.0, 0.05, 0.1, 0.3, 1.01]
    out = session.r2_histogram(edges)
    full = collect_ld_records(aln, w, sm, DriverConfig(tile=16))
    r2 = np.asarray(full.r2)
    for b in range(len(edges) - 1):
        want = int(((r2 >= edges[b]) & (r2 < edges[b + 1])).sum())
        assert out["n_pairs"][b] == want, b
    assert sum(out["n_pairs"]) == len(r2)  # edges cover [0, 1]
    with pytest.raises(ValueError):
        session.r2_histogram([0.5])
    with pytest.raises(ValueError):
        session.r2_histogram([0.5, 0.5])


def test_analytics_cross_consistency(rng):
    # Every analytics query is a different projection of the same pair
    # population: their totals must agree exactly.
    from weightedld.runtime.driver import LdSession

    aln = random_alignment(rng, 40, 90)
    w = (rng.random(40) + 0.05).astype(np.float32)
    sm = np.arange(90) * 7
    sess = LdSession(aln, w, sm, DriverConfig(tile=16))

    summ = sess.summarize(r2_threshold=0.2)
    hist = sess.r2_histogram([0.0, 0.2, 1.01])
    decay = sess.ld_decay([0, 90 * 7])
    n_records = sum(len(rec) for _, rec in sess.stream(r2_threshold=None))

    assert summ["n_pairs"] == n_records
    assert sum(hist["n_pairs"]) == summ["n_pairs"]
    assert decay["n_pairs"][0] == summ["n_pairs"]
    np.testing.assert_allclose(decay["r2_sum"][0],
                               sess.summarize(r2_threshold=-1.0)
                               ["r2_sum_over_threshold"], rtol=1e-5)
    # hist bin [0.2, 1.01) vs summarize's strict > 0.2: they differ only
    # by pairs at exactly 0.2 — bound, don't equate.
    assert hist["n_pairs"][1] >= summ["n_over_threshold"]
    # top-k values live in the histogram's top occupied bin.
    top = sess.top_pairs(3)
    if len(top.r2):
        assert float(top.r2[0]) == pytest.approx(summ["r2_max"], rel=1e-6)


def test_compact_slot_and_sort_paths_identical(monkeypatch):
    """compact_tile_stats has two static paths (slot-driven vs the
    nonzero-sort fallback for huge capacity buckets); both must emit
    bit-identical records in the same (tile, row, col) order."""
    from weightedld.core import ld_tiled
    from weightedld.core.paircore import PairStats

    rng = np.random.default_rng(3)
    k, t = 5, 8
    st = PairStats(
        d=jnp.asarray(rng.standard_normal((k, t, t)), jnp.float32),
        d_prime=jnp.asarray(rng.standard_normal((k, t, t)), jnp.float32),
        r2=jnp.asarray(rng.random((k, t, t)), jnp.float32),
        keep=jnp.asarray(rng.random((k, t, t)) < 0.4),
    )
    ti = jnp.asarray(rng.integers(0, 7, k), jnp.int32)
    tj = jnp.asarray(rng.integers(0, 7, k), jnp.int32)

    # Distinct capacity values per path: _SLOT_BYTES_CAP is read at TRACE
    # time, so a repeated (shape, capacity) would hit the jit cache.
    cap_slot, cap_sort = 256, 257
    n1, s1, v1 = ld_tiled.compact_tile_stats(
        st, ti, tj, jnp.float32(0.3), tile=t, capacity=cap_slot)
    monkeypatch.setattr(ld_tiled, "_SLOT_BYTES_CAP", 0)
    # cap_sort * t * 4 = 8224 > 4 * mask.size = 1280 -> sort path.
    n2, s2, v2 = ld_tiled.compact_tile_stats(
        st, ti, tj, jnp.float32(0.3), tile=t, capacity=cap_sort)
    assert int(n1) == int(n2) > 0
    n = int(n1)
    np.testing.assert_array_equal(np.asarray(s1)[:n], np.asarray(s2)[:n])
    np.testing.assert_array_equal(np.asarray(v1)[:n], np.asarray(v2)[:n])


def test_speculative_compaction_learns_and_overflows(rng):
    """The stream() fast path dispatches the gather with a LEARNED capacity
    before the count lands; an undersized guess must fall back to an exact
    re-dispatch with identical records, and huge record volumes must turn
    speculation off (its O(capacity*T) cost would exceed the roundtrip)."""
    from weightedld.runtime import driver as drv
    from weightedld.runtime.driver import DriverConfig, LdSession

    aln = rng.choice([0, 0, 0, 1, 1, 4], size=(32, 96)).astype(np.int8)
    w = (rng.random(32) + 0.05).astype(np.float32)
    ses = LdSession(aln, w, np.arange(96),
                    DriverConfig(tile=16, tiles_per_shard_batch=1,
                                 r2_threshold=0.5))
    assert ses._spec_cap == 0  # nothing learned yet

    def rows(records_iter):
        return sorted(
            (int(a), int(b), float(r))
            for _, rec in records_iter
            for a, b, r in zip(rec.pos_a, rec.pos_b, rec.r2))

    sparse = rows(ses.stream())             # learns a small capacity
    cap_after_sparse = ses._spec_cap
    assert cap_after_sparse > 0
    # Denser scan: early batches OVERFLOW the learned guess (exact
    # fallback), later ones ride the ratcheted capacity. Same records
    # as a fresh session with no learned state.
    dense = rows(ses.stream(r2_threshold=0.0))
    fresh = LdSession(aln, w, np.arange(96),
                      DriverConfig(tile=16, tiles_per_shard_batch=1,
                                   r2_threshold=0.0))
    assert dense == rows(fresh.stream())
    assert ses._spec_cap >= cap_after_sparse
    assert sparse == [r for r in dense if r[2] > 0.5]

    # Beyond the regime: a bucket over the ceiling disables speculation
    # (shrink the ceiling rather than compiling a giant gather).
    ses._spec_cap = 4
    orig_max = drv._SPEC_CAP_MAX
    try:
        drv._SPEC_CAP_MAX = 2
        list(ses.stream(r2_threshold=0.0))
    finally:
        drv._SPEC_CAP_MAX = orig_max
    assert ses._spec_cap == 0


def test_batch_tiles_host_matches_device_plan(rng):
    # The host-retained striped plan reproduces the dispatched bi/bj tile
    # coordinates exactly for every batch, across BOTH hybrid phases (the
    # phase-1 buffer has its own k2 batch width).  matrices() relies on
    # this to skip two device fetches per batch.
    from weightedld.runtime.driver import LdSession, _fetch

    aln = rng.choice([0, 0, 1, 1, 1], size=(40, 90)).astype(np.int8)
    for s in rng.choice(90, size=20, replace=False):
        aln[rng.integers(40), s] = 5
    w = np.ones(40, np.float32)
    ses = LdSession(
        aln, w, np.arange(90),
        DriverConfig(tile=16, seq_chunk=64,
                     tiles_per_shard_batch=2),
    )
    assert ses._hybrid_safe is not None  # two phases engaged
    assert ses.n_batches > ses._n_batches_p0 > 1
    for b in range(ses.n_batches):
        disp = ses._dispatch(b)
        hi, hj, _em = ses._batch_tiles_host(b)
        np.testing.assert_array_equal(hi, _fetch(disp[5]))
        np.testing.assert_array_equal(hj, _fetch(disp[6]))


def test_speculative_capacity_shrinks_after_high_yield_scan(rng):
    """The learned capacity is a TWO-BATCH sliding window, not a ratchet:
    a resident session that ran one high-yield scan must not keep paying
    that scan's oversized per-batch compaction/transfer on later
    low-yield scans (PERF.md round 3: 171 -> 239 ms on a zero-record scan
    before the window)."""
    from weightedld.runtime.driver import (
        DriverConfig, LdSession, _next_bucket,
    )

    aln = random_alignment(rng, 32, 96)
    w = (rng.random(32) + 0.05).astype(np.float32)
    ses = LdSession(aln, w, np.arange(96),
                    DriverConfig(tile=16, tiles_per_shard_batch=1,
                                 r2_threshold=0.9))
    assert ses.n_batches >= 3
    dense = sum(len(r) for _, r in ses.stream(r2_threshold=0.0))
    cap_dense = ses._spec_cap
    # Learning is per SHARD (the fused compaction packs per shard).
    assert cap_dense >= _next_bucket(
        dense // (ses.n_batches * ses.n_dev))
    sparse = sum(len(r) for _, r in ses.stream(r2_threshold=0.99))
    assert sparse < dense
    # After >= 2 low-yield batches the window has forgotten the dense
    # bucket entirely.
    assert ses._spec_cap < cap_dense
    assert ses._spec_cap == max(ses._cap_hist)
    # And the shrunken capacity still produces identical records.
    again = sum(len(r) for _, r in ses.stream(r2_threshold=0.0))
    assert again == dense


def test_resolve_batch_memory_budget():
    # Tiles per dispatch come from the device's allocatable memory: the
    # budget share over the per-tile-pair bytes, capped by the shard's plan
    # and (with no r2 threshold) by the record-compaction buffers; a
    # device reporting no memory limit gets the fixed host budget.
    from weightedld.runtime import driver as drv

    per = drv.tile_pair_bytes(256, 1024, engine="int8", majmin=True,
                              n_planes=3, n_levels=3)
    # Operands (2 + 2L + 2) T N, int32 level products, 3-deep stats.
    assert per == 10 * 256 * 1024 + 3 * 4 * 256 * 256 * 4 \
        + 3 * 14 * 256 * 256
    mem = 60 << 30
    n = 10 ** 6
    cap = (mem // drv._BATCH_MEM_SHARE) // per
    k = drv.resolve_batch(n, 256, per, mem, records_uncapped=False)
    # Within the budget, in as few batches as the budget allows, and
    # evened out: no batch is more than one tile short of the others.
    assert k <= cap and -(-n // k) == -(-n // cap)
    assert -(-n // k) * k - n < -(-n // k)
    # A bigger device holds proportionally bigger batches.
    assert drv.resolve_batch(n, 256, per, 2 * mem, False) >= 2 * k - 2
    # Never more than the shard's plan, never fewer than one tile.
    assert drv.resolve_batch(5, 256, per, mem, False) == 5
    assert drv.resolve_batch(5, 256, 10 ** 15, mem, False) == 1
    # No threshold: bounded by the compaction buffers (~40 B/pair).
    ku = drv.resolve_batch(n, 256, per, mem, records_uncapped=True)
    assert ku <= min(cap, (mem // drv._BATCH_MEM_SHARE) // (256 * 256 * 40))
    # No reported limit (host CPU backends): the fixed host budget.
    assert drv.resolve_batch(n, 256, per, None, False) <= \
        max(1, drv._HOST_BATCH_BYTES // per)
    # A plan one tile over the budget splits into two even batches.
    assert drv.resolve_batch(cap + 1, 256, per, mem, False) == \
        -(-(cap + 1) // 2)
    # The general form costs more per tile pair than the factorized one.
    assert drv.tile_pair_bytes(256, 1024, engine="int8", majmin=False,
                               n_planes=5, n_levels=3) > per
    # The tile rule itself: auto or explicit.
    assert drv.resolve_tile(None) == drv.TILE_AUTO
    assert drv.resolve_tile(64) == 64


def test_session_sizes_batches_from_device_memory(rng, monkeypatch):
    # The session reads the mesh device's memory_stats() limit: a larger
    # reported memory gives larger auto batches (fewer dispatches).
    from weightedld.runtime import driver as drv

    aln = rng.choice([0, 1], size=(16, 200)).astype(np.int8)
    w = np.ones(16, np.float32)
    per = drv.tile_pair_bytes(16, 128, engine="int8", majmin=True,
                              n_planes=2, n_levels=1)
    for tiles, want_k in ((3, 3), (1000, 91)):
        monkeypatch.setattr(drv, "device_memory_bytes",
                            lambda devs, n=tiles: n * per
                            * drv._BATCH_MEM_SHARE)
        ses = drv.LdSession(aln, w, np.arange(200),
                            DriverConfig(tile=16, r2_threshold=0.5),
                            mesh=drv.default_mesh(jax.devices()[:1]))
        assert ses.cfg.tiles_per_shard_batch == want_k  # 91 = whole plan


# ---------------------------------------------------------------------------
# Rectangular (inter-region) mode: DriverConfig.cross_split.


def test_plan_tiles_cross_split():
    from weightedld.parallel.triangle import plan_tiles

    plan = plan_tiles(70, tile=16, cross_split=37)
    # Tiles must intersect both blocks: row tile covers sites < 37
    # (ti in {0, 1, 2}), col tile covers sites >= 37 (tj in {2, 3, 4}).
    assert set(plan.tile_i.tolist()) <= {0, 1, 2}
    assert set(plan.tile_j.tolist()) <= {2, 3, 4}
    assert len(plan.tile_i) == 9
    # Whole-triangle plan for the same shape has 15 tiles.
    assert plan_tiles(70, tile=16).n_tiles == 15
    with pytest.raises(ValueError, match="cross_split"):
        plan_tiles(70, tile=16, cross_split=0)
    with pytest.raises(ValueError, match="cross_split"):
        plan_tiles(70, tile=16, cross_split=70)


def _rect_oracle(aln, w, sm, split):
    import jax.numpy as jnp

    from weightedld.core.ld_dense import extract_records, ld_all_pairs_dense

    stats = ld_all_pairs_dense(jnp.asarray(aln), jnp.asarray(w))
    full = extract_records(stats, sm, None)
    pa, pb = np.asarray(full.pos_a), np.asarray(full.pos_b)
    # sm is strictly increasing in these tests: index the split by position.
    m = (pa < sm[split]) & (pb >= sm[split])
    return sorted(zip(pa[m].tolist(), pb[m].tolist(),
                      np.round(np.asarray(full.r2)[m], 4).tolist()))


@pytest.mark.parametrize("engine", ["xla", "auto"])
@pytest.mark.parametrize("seed", [2, 5])
def test_cross_split_matches_dense_rectangle(engine, seed):
    import jax

    from weightedld.parallel.sharded import default_mesh

    rng = np.random.default_rng(seed)
    N, S, split = 32, 70, 37
    aln = random_alignment(rng, N, S, p_gap=0.03, p_unknown=0.02)
    w = rng.random(N).astype(np.float32) + 0.1
    sm = np.arange(S, dtype=np.int64) * 7
    oracle = _rect_oracle(aln, w, sm, split)
    cfg = DriverConfig(engine=engine, tile=16, seq_chunk=128,
                       cross_split=split)
    mesh = default_mesh(jax.devices()[:4]) if engine == "auto" else None
    rec = collect_ld_records(aln, w, sm, cfg, mesh=mesh)
    got = sorted(zip(rec.pos_a.tolist(), rec.pos_b.tolist(),
                     np.round(rec.r2, 4).tolist()))
    assert len(got) == len(oracle)
    for g, o in zip(got, oracle):
        assert g[:2] == o[:2] and abs(g[2] - o[2]) < 2e-4, (g, o)


def test_cross_split_analytics_inherit_rectangle(rng):
    N, S, split = 30, 64, 20
    aln = random_alignment(rng, N, S, p_gap=0.02, p_unknown=0.0)
    w = np.ones(N, np.float32)
    sm = np.arange(S, dtype=np.int64)
    cfg = DriverConfig(engine="xla", tile=16, cross_split=split)
    s = LdSession(aln, w, sm, cfg)
    oracle = _rect_oracle(aln, w, sm, split)
    assert s.summarize()["n_pairs"] == len(oracle)
    tp = s.top_pairs(7)
    assert all(pa < split <= pb
               for pa, pb in zip(tp.pos_a.tolist(), tp.pos_b.tolist()))
    hist = s.r2_histogram((0.0, 0.5, 1.01))
    assert sum(hist["n_pairs"]) == len(oracle)
    mats = s.matrices()
    ij = np.argwhere(np.asarray(mats["keep"]))
    assert len(ij) == len(oracle)
    assert (ij[:, 0] < split).all() and (ij[:, 1] >= split).all()


def test_cross_split_validations(rng):
    aln = random_alignment(rng, 10, 20)
    w = np.ones(10, np.float32)
    sm = np.arange(20, dtype=np.int64)
    with pytest.raises(ValueError, match="cross_split must be in"):
        LdSession(aln, w, sm, DriverConfig(engine="xla", cross_split=20))
    with pytest.raises(ValueError, match="window flags"):
        LdSession(aln, w, sm, DriverConfig(engine="xla", cross_split=5,
                                           max_site_distance=3))
