"""The site-major integer engine (core.tile_engine) vs the f32 reference
tile path (core.ld_tiled.tile_stats_batch), and through the session."""

from functools import partial

import jax.numpy as jnp
import numpy as np
import pytest

from weightedld.core.ld_tiled import pad_alignment, tile_stats_batch
from weightedld.core.majmin import (
    majmin_site_aux,
    pad_alignment_site_major,
    pad_weights,
    pad_weights_int8,
)
from weightedld.core.tile_engine import tile_stats_general, tile_stats_majmin
from weightedld.parallel.triangle import plan_tiles

from .fixtures import random_alignment

PACK = {
    "": pad_weights,
    "int8": pad_weights_int8,
    "int8x3": partial(pad_weights_int8, levels=3),
}


def _plan_args(n_sites, tile):
    plan = plan_tiles(n_sites, tile)
    return (plan, jnp.asarray(plan.tile_i), jnp.asarray(plan.tile_j),
            jnp.ones(plan.n_tiles, dtype=jnp.int32))


def _reference(aln, w, tile):
    n_sites = aln.shape[1]
    _plan, ti, tj, em = _plan_args(n_sites, tile)
    return tile_stats_batch(
        jnp.asarray(pad_alignment(aln, tile)), jnp.asarray(w),
        ti, tj, em != 0, tile=tile, n_sites=n_sites)


def _assert_close(got, ref, rtol=1e-5, atol=1e-6, dp_tol=(1e-4, 1e-5)):
    np.testing.assert_array_equal(np.asarray(got.keep), np.asarray(ref.keep))
    keep = np.asarray(ref.keep)
    for name in ("d", "r2"):
        np.testing.assert_allclose(
            np.asarray(getattr(got, name))[keep],
            np.asarray(getattr(ref, name))[keep],
            rtol=rtol, atol=atol, err_msg=name)
    dp_ref = np.asarray(ref.d_prime)[keep]
    dp_got = np.asarray(got.d_prime)[keep]
    finite = np.isfinite(dp_ref)
    np.testing.assert_allclose(dp_got[finite], dp_ref[finite],
                               rtol=dp_tol[0], atol=dp_tol[1])


@pytest.mark.parametrize("seed,n_seqs,n_sites,tile,chunk", [
    (0, 40, 50, 16, 64),
    (1, 130, 70, 32, 128),
    (2, 64, 33, 16, 64),
])
def test_engine_matches_xla(seed, n_seqs, n_sites, tile, chunk):
    # General per-pair form, default int8x3 cascade, vs the f32 path.
    rng = np.random.default_rng(seed)
    aln = random_alignment(rng, n_seqs, n_sites)
    w = (rng.random(n_seqs) + 0.05).astype(np.float32)
    _plan, ti, tj, em = _plan_args(n_sites, tile)
    got = tile_stats_general(
        jnp.asarray(pad_alignment_site_major(aln, tile, chunk)),
        jnp.asarray(PACK["int8x3"](w, chunk)), ti, tj, em,
        tile=tile, n_sites=n_sites, wquant="int8x3")
    _assert_close(got, _reference(aln, w, tile))


def test_reduced_planes_binary_data():
    # SNP-style {0, 1, 4} data: the 3-plane form must match the 5-plane one.
    rng = np.random.default_rng(3)
    n_seqs, n_sites, tile, chunk = 60, 40, 16, 64
    aln = (rng.random((n_seqs, n_sites)) < 0.4).astype(np.int8)
    aln[rng.random((n_seqs, n_sites)) < 0.05] = 4
    w = (rng.random(n_seqs) + 0.05).astype(np.float32)

    from weightedld.core.majmin import detect_planes

    assert detect_planes(aln) == (0, 1, 4)
    _plan, ti, tj, em = _plan_args(n_sites, tile)
    args = (jnp.asarray(pad_alignment_site_major(aln, tile, chunk)),
            jnp.asarray(pad_weights(w, chunk)), ti, tj, em)
    full = tile_stats_general(*args, tile=tile, n_sites=n_sites)
    slim = tile_stats_general(*args, tile=tile, n_sites=n_sites,
                              planes=(0, 1, 4))
    np.testing.assert_array_equal(np.asarray(slim.keep), np.asarray(full.keep))
    keep = np.asarray(full.keep)
    np.testing.assert_allclose(
        np.asarray(slim.r2)[keep], np.asarray(full.r2)[keep], rtol=1e-6)


def test_driver_engine_matches_xla(rng):
    from weightedld.runtime.driver import DriverConfig, collect_ld_records

    aln = random_alignment(rng, 40, 50)
    w = (rng.random(40) + 0.05).astype(np.float32)
    sm = np.arange(50)
    xla = collect_ld_records(aln, w, sm, DriverConfig(tile=16, engine="xla"))
    eng = collect_ld_records(aln, w, sm, DriverConfig(tile=16, seq_chunk=64))
    xm = {(int(a), int(b)): (float(d), float(r))
          for a, b, d, r in zip(xla.pos_a, xla.pos_b, xla.d, xla.r2)}
    pm = {(int(a), int(b)): (float(d), float(r))
          for a, b, d, r in zip(eng.pos_a, eng.pos_b, eng.d, eng.r2)}
    assert set(xm) == set(pm)
    for key in xm:
        np.testing.assert_allclose(pm[key], xm[key], atol=1e-5)


def test_tile_order_invariant(rng):
    # A tile pair's stats do not depend on the batch it rides in: the
    # plan reversed and with padding tiles interleaved gives bit-identical
    # values for every real tile pair, in both forms.
    n_seqs, n_sites, tile, chunk = 50, 45, 16, 64
    aln = rng.choice([0, 1, 2, 4], size=(n_seqs, n_sites)).astype(np.int8)
    w = (rng.random(n_seqs) + 0.05).astype(np.float32)
    plan, ti, tj, em = _plan_args(n_sites, tile)
    codes = jnp.asarray(pad_alignment_site_major(aln, tile, chunk))
    wr = jnp.asarray(PACK["int8x3"](w, chunk))
    aux = jnp.asarray(majmin_site_aux(aln, plan.s_pad))
    kw = dict(tile=tile, n_sites=n_sites, wquant="int8x3")
    ti2 = jnp.concatenate([ti[::-1], ti[:2]])
    tj2 = jnp.concatenate([tj[::-1], tj[:2]])
    em2 = jnp.concatenate([em, jnp.zeros(2, jnp.int32)])
    n = plan.n_tiles
    for fn, extra in ((tile_stats_general, ()), (tile_stats_majmin, (aux,))):
        if fn is tile_stats_majmin:
            base = fn(codes, wr, aux, ti, tj, em, **kw)
            shuf = fn(codes, wr, aux, ti2, tj2, em2, **kw)
        else:
            base = fn(codes, wr, ti, tj, em, **kw)
            shuf = fn(codes, wr, ti2, tj2, em2, **kw)
        for f in ("d", "d_prime", "r2", "keep"):
            a = np.asarray(getattr(base, f))
            b = np.asarray(getattr(shuf, f))[:n][::-1]
            np.testing.assert_array_equal(a, b, err_msg=f)
        # The trailing padding tiles keep nothing.
        assert not np.asarray(shuf.keep)[n:].any()


def test_two_plane_binary_no_missing(rng):
    # A perfectly-called SNP matrix has only codes {0, 1}: p=2 form.
    from weightedld.core.majmin import detect_planes

    n_seqs, n_sites, tile, chunk = 40, 30, 16, 64
    aln = (rng.random((n_seqs, n_sites)) < 0.4).astype(np.int8)
    assert detect_planes(aln) == (0, 1)
    w = (rng.random(n_seqs) + 0.05).astype(np.float32)
    _plan, ti, tj, em = _plan_args(n_sites, tile)
    got = tile_stats_general(
        jnp.asarray(pad_alignment_site_major(aln, tile, chunk)),
        jnp.asarray(pad_weights(w, chunk)), ti, tj, em,
        tile=tile, n_sites=n_sites, planes=(0, 1))
    ref = _reference(aln, w, tile)
    np.testing.assert_array_equal(np.asarray(got.keep), np.asarray(ref.keep))
    keep = np.asarray(ref.keep)
    np.testing.assert_allclose(np.asarray(got.r2)[keep],
                               np.asarray(ref.r2)[keep], rtol=1e-5, atol=1e-6)


def test_unit_weights_matches(rng):
    # The unit-weight specialization (one int8 count contraction, no
    # weighted pass) equals the split-bf16 path on unit weights.
    n_seqs, n_sites, tile, chunk = 40, 40, 16, 64
    aln = random_alignment(rng, n_seqs, n_sites)
    _plan, ti, tj, em = _plan_args(n_sites, tile)
    codes = jnp.asarray(pad_alignment_site_major(aln, tile, chunk))
    wr = jnp.asarray(pad_weights(np.ones(n_seqs, np.float32), chunk))
    base = tile_stats_general(codes, wr, ti, tj, em, tile=tile,
                              n_sites=n_sites)
    unit = tile_stats_general(codes, wr, ti, tj, em, tile=tile,
                              n_sites=n_sites, unit_weights=True)
    np.testing.assert_array_equal(np.asarray(unit.keep), np.asarray(base.keep))
    keep = np.asarray(base.keep)
    np.testing.assert_allclose(np.asarray(unit.r2)[keep],
                               np.asarray(base.r2)[keep], rtol=1e-6)
    np.testing.assert_allclose(np.asarray(unit.d)[keep],
                               np.asarray(base.d)[keep], rtol=1e-6, atol=1e-8)


@pytest.mark.parametrize("wquant", ["int8", "int8x3"])
def test_quantized_weights_kernel_matches(rng, wquant):
    # The int8 cascades (int8: w ~= a1*q1 + a2*q2, error <= max|w|/64516;
    # int8x3: one f32 ulp) must agree with the split-bf16 path far inside
    # the reference's 4-dp output rounding.
    n_seqs, n_sites, tile, chunk = 48, 40, 16, 64
    aln = random_alignment(rng, n_seqs, n_sites)
    w = (np.abs(rng.normal(size=n_seqs)) * 0.3 + 0.01).astype(np.float32)
    w /= w.max()
    _plan, ti, tj, em = _plan_args(n_sites, tile)
    codes = jnp.asarray(pad_alignment_site_major(aln, tile, chunk))
    kw = dict(tile=tile, n_sites=n_sites)
    base = tile_stats_general(codes, jnp.asarray(pad_weights(w, chunk)),
                              ti, tj, em, **kw)
    loq = tile_stats_general(codes, jnp.asarray(PACK[wquant](w, chunk)),
                             ti, tj, em, wquant=wquant, **kw)
    np.testing.assert_array_equal(np.asarray(loq.keep), np.asarray(base.keep))
    keep = np.asarray(base.keep)
    # int8x3's weight representation (~6e-8, one f32 ulp) is tighter than
    # split-bf16's, so it must agree essentially to f32 arithmetic noise;
    # the lossy 2-level cascade gets the 4-dp-safe bound.
    atol = 2e-5 if wquant == "int8x3" else 4e-4
    for field in ("d", "d_prime", "r2"):
        np.testing.assert_allclose(
            np.asarray(getattr(loq, field))[keep],
            np.asarray(getattr(base, field))[keep],
            atol=atol, err_msg=field)


@pytest.mark.parametrize("wq", ["int8", "int8x3"])
def test_quantized_weights_driver_matches(rng, wq):
    # Record-level agreement of the session's weight modes with the f32
    # reference path.
    from weightedld.runtime.driver import DriverConfig, collect_ld_records

    aln = random_alignment(rng, 30, 60)
    w = (np.abs(rng.normal(size=30)) + 0.1).astype(np.float32)
    w /= w.max()
    sm = np.arange(60)
    want = collect_ld_records(aln, w, sm, DriverConfig(tile=16, engine="xla"))
    got = collect_ld_records(aln, w, sm,
                             DriverConfig(tile=16, weight_quant=wq))
    wm = {(int(a), int(b)): float(r) for a, b, r in
          zip(want.pos_a, want.pos_b, want.r2)}
    gm = {(int(a), int(b)): float(r) for a, b, r in
          zip(got.pos_a, got.pos_b, got.r2)}
    assert set(gm) == set(wm)
    for k in wm:
        np.testing.assert_allclose(gm[k], wm[k], atol=4e-4, err_msg=str(k))


def test_large_tile_matches(rng):
    # T=256 (the auto tile) with a partial last tile, both forms.
    n_seqs, n_sites, tile, chunk = 24, 300, 256, 64
    aln = random_alignment(rng, n_seqs, n_sites)
    w = (rng.random(n_seqs) + 0.05).astype(np.float32)
    _plan, ti, tj, em = _plan_args(n_sites, tile)
    got = tile_stats_general(
        jnp.asarray(pad_alignment_site_major(aln, tile, chunk)),
        jnp.asarray(pad_weights(w, chunk)), ti, tj, em,
        tile=tile, n_sites=n_sites)
    ref = _reference(aln, w, tile)
    np.testing.assert_array_equal(np.asarray(got.keep), np.asarray(ref.keep))
    keep = np.asarray(ref.keep)
    np.testing.assert_allclose(np.asarray(got.r2)[keep],
                               np.asarray(ref.r2)[keep], rtol=1e-5, atol=1e-6)


def _majmin_args(aln, tile, chunk):
    n_sites = aln.shape[1]
    plan, ti, tj, em = _plan_args(n_sites, tile)
    codes = jnp.asarray(pad_alignment_site_major(aln, tile, chunk))
    aux = majmin_site_aux(aln, plan.s_pad)
    return codes, jnp.asarray(aux), ti, tj, em


@pytest.mark.parametrize("alphabet,wq", [
    ((0, 1, 2, 3, 4), ""),          # general DNA, split-bf16
    ((0, 1, 2, 3, 4), "int8x3"),    # general DNA, default cascade
    ((0, 1, 4), "int8x3"),          # SNP-style
    ((0, 1), ""),                   # perfectly-called binary
    ((0, 3, 4), "int8"),            # lossy 2-level cascade
])
def test_majmin_kernel_bit_equal_general(rng, alphabet, wq):
    # The factorized major/dmin form must be BIT-identical to the general
    # form on no-UNKNOWN inputs: same integer joints / bf16 products, same
    # f32 combine order.
    n_seqs, n_sites, tile, chunk = 50, 70, 16, 64
    aln = rng.choice(alphabet, size=(n_seqs, n_sites)).astype(np.int8)
    w = (rng.random(n_seqs) + 0.05).astype(np.float32)
    w /= w.max()
    wr = jnp.asarray(PACK[wq](w, chunk))
    codes, aux, ti, tj, em = _majmin_args(aln, tile, chunk)
    kw = dict(tile=tile, n_sites=n_sites, wquant=wq)
    base = tile_stats_general(codes, wr, ti, tj, em, **kw)
    mm = tile_stats_majmin(codes, wr, aux, ti, tj, em, **kw)
    np.testing.assert_array_equal(np.asarray(mm.keep), np.asarray(base.keep))
    keep = np.asarray(base.keep)
    for f in ("d", "d_prime", "r2"):
        gb = np.asarray(getattr(base, f))[keep]
        gm = np.asarray(getattr(mm, f))[keep]
        fin = np.isfinite(gb)
        assert (np.isfinite(gm) == fin).all(), f
        np.testing.assert_array_equal(gm[fin], gb[fin], err_msg=f)  # bitwise


def test_majmin_unit_and_exact_weights(rng):
    n_seqs, n_sites, tile, chunk = 48, 40, 16, 64
    aln = rng.choice([0, 1, 2, 4], size=(n_seqs, n_sites)).astype(np.int8)
    codes, aux, ti, tj, em = _majmin_args(aln, tile, chunk)
    kw = dict(tile=tile, n_sites=n_sites)
    # Unit weights: single int8 count contraction.
    wr = jnp.asarray(pad_weights(np.ones(n_seqs, np.float32), chunk))
    base = tile_stats_general(codes, wr, ti, tj, em, unit_weights=True, **kw)
    mm = tile_stats_majmin(codes, wr, aux, ti, tj, em, unit_weights=True,
                           **kw)
    np.testing.assert_array_equal(np.asarray(mm.keep), np.asarray(base.keep))
    keep = np.asarray(base.keep)
    np.testing.assert_array_equal(np.asarray(mm.r2)[keep],
                                  np.asarray(base.r2)[keep])
    # bf16-exact weights: single bf16 pass.
    w = (np.arange(n_seqs) % 4 + 1).astype(np.float32) / 4.0
    wr = jnp.asarray(pad_weights(w, chunk))
    base = tile_stats_general(codes, wr, ti, tj, em, exact_weights=True, **kw)
    mm = tile_stats_majmin(codes, wr, aux, ti, tj, em, exact_weights=True,
                           **kw)
    np.testing.assert_array_equal(np.asarray(mm.keep), np.asarray(base.keep))
    keep = np.asarray(base.keep)
    np.testing.assert_array_equal(np.asarray(mm.d)[keep],
                                  np.asarray(base.d)[keep])


def test_majmin_multichunk_accumulation(rng):
    # A sequence axis padded over several 64-wide multiples: the padded
    # sequences (UNKNOWN, weight 0) contribute nothing.
    n_seqs, n_sites, tile, chunk = 150, 40, 16, 64
    aln = rng.choice([0, 1, 3, 4], size=(n_seqs, n_sites)).astype(np.int8)
    w = (rng.random(n_seqs) + 0.05).astype(np.float32)
    wr = jnp.asarray(PACK["int8x3"](w, chunk))
    codes, aux, ti, tj, em = _majmin_args(aln, tile, chunk)
    kw = dict(tile=tile, n_sites=n_sites, wquant="int8x3")
    base = tile_stats_general(codes, wr, ti, tj, em, **kw)
    mm = tile_stats_majmin(codes, wr, aux, ti, tj, em, **kw)
    np.testing.assert_array_equal(np.asarray(mm.keep), np.asarray(base.keep))
    keep = np.asarray(base.keep)
    np.testing.assert_array_equal(np.asarray(mm.r2)[keep],
                                  np.asarray(base.r2)[keep])
    _assert_close(mm, _reference(aln, w, tile))


@pytest.mark.parametrize("case", ["single_site_tile_majmin",
                                  "single_site_tile_general",
                                  "all_padding_batch"])
def test_int8x3_edge_cases(rng, case):
    # Default int8x3 cascade at the plan's edges: a last tile holding ONE
    # real site (its pairs with every earlier site must match the f32
    # path), and a batch of nothing but padding tile pairs (emit == 0
    # everywhere: no pair may survive).
    n_seqs, tile, chunk = 40, 16, 64
    n_sites = 2 * tile + 1
    if case == "single_site_tile_majmin":
        aln = rng.choice([0, 1, 2], size=(n_seqs, n_sites)).astype(np.int8)
    else:
        aln = random_alignment(rng, n_seqs, n_sites)
    w = (rng.random(n_seqs) + 0.05).astype(np.float32)
    wr = jnp.asarray(PACK["int8x3"](w, chunk))
    plan, ti, tj, em = _plan_args(n_sites, tile)
    codes = jnp.asarray(pad_alignment_site_major(aln, tile, chunk))
    kw = dict(tile=tile, n_sites=n_sites, wquant="int8x3")
    if case == "all_padding_batch":
        got = tile_stats_general(codes, wr, ti, tj, jnp.zeros_like(em), **kw)
        assert not np.asarray(got.keep).any()
        aux = jnp.asarray(majmin_site_aux(aln, plan.s_pad))
        got = tile_stats_majmin(codes, wr, aux, ti, tj, jnp.zeros_like(em),
                                **kw)
        assert not np.asarray(got.keep).any()
        return
    if case == "single_site_tile_majmin":
        aux = jnp.asarray(majmin_site_aux(aln, plan.s_pad))
        got = tile_stats_majmin(codes, wr, aux, ti, tj, em, **kw)
    else:
        got = tile_stats_general(codes, wr, ti, tj, em, **kw)
    ref = _reference(aln, w, tile)
    _assert_close(got, ref)
    # The single-site tile's pairs are present and only in column 0.
    last = np.asarray(plan.tile_j) == plan.grid - 1
    kl = np.asarray(got.keep)[last]
    assert kl[:, :, 0].any() and not kl[:, :, 1:].any()


def test_majmin_session_auto_selected_and_fallback(rng):
    # The driver enables the factorized form when the input has no
    # UNKNOWN, and falls back to the general form when UNKNOWNs make the
    # per-site margins unsafe; either way records must match the XLA engine.
    from weightedld.runtime.driver import DriverConfig, LdSession

    def records_map(rec):
        return {(int(a), int(b)): (float(d), float(r)) for a, b, d, r in
                zip(rec.pos_a, rec.pos_b, rec.d, rec.r2)}

    for unsafe_unknown in (False, True):
        aln = rng.choice([0, 1, 2, 4], size=(40, 50)).astype(np.int8)
        if unsafe_unknown:
            aln[3, 7] = 5
            # A count TIE (c1 == c2 <= u_max margin) forces the fallback.
            aln[:20, 0] = 0
            aln[20:, 0] = 1
        w = (rng.random(40) + 0.05).astype(np.float32)
        sm = np.arange(50)
        ses = LdSession(aln, w, sm,
                        DriverConfig(tile=16, seq_chunk=64))
        # Unsafe margins reject GLOBAL factorization; the session may still
        # run the hybrid tile-pair split (phase-0 factorized on provably
        # safe tile pairs) — either way results must match.
        assert ses._majmin == (not unsafe_unknown)
        if unsafe_unknown:
            assert ses._hybrid_safe is None or not ses._hybrid_safe.all()
        else:
            assert ses._hybrid_safe is None
        got = {}
        for _b, rec in ses.stream():
            got.update(records_map(rec))
        from weightedld.runtime.driver import collect_ld_records

        want = records_map(collect_ld_records(
            aln, w, sm, DriverConfig(tile=16, engine="xla")))
        assert set(got) == set(want)
        for key in want:
            np.testing.assert_allclose(got[key], want[key], atol=1e-5)


def test_majmin_safe_with_sparse_unknowns(rng):
    # UNKNOWNs present but every site's count margins exceed the worst-case
    # per-pair removals: the factorized form stays exact (bit-equal to
    # the general form) — the margin proof in majmin_safe_with_unknown.
    from weightedld.core.majmin import majmin_safe_with_unknown

    n_seqs, n_sites, tile, chunk = 96, 60, 16, 64
    # Strongly skewed alleles -> wide margins (c1 - c2 and c2 - c3 large).
    aln = rng.choice([0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 4],
                     size=(n_seqs, n_sites)).astype(np.int8)
    aln[:3, :] = 0
    aln[:24, 0] = 1  # keep site 0's minor well clear of third place
    # Two UNKNOWN cells (u_max = 1 per site).
    aln[5, 3] = 5
    aln[7, 11] = 5
    assert majmin_safe_with_unknown(aln)
    w = (rng.random(n_seqs) + 0.05).astype(np.float32)
    wr = jnp.asarray(pad_weights(w, chunk))
    codes, aux, ti, tj, em = _majmin_args(aln, tile, chunk)
    kw = dict(tile=tile, n_sites=n_sites)
    base = tile_stats_general(codes, wr, ti, tj, em, **kw)
    mm = tile_stats_majmin(codes, wr, aux, ti, tj, em, **kw)
    np.testing.assert_array_equal(np.asarray(mm.keep), np.asarray(base.keep))
    keep = np.asarray(base.keep)
    for f in ("d", "d_prime", "r2"):
        gb = np.asarray(getattr(base, f))[keep]
        gm = np.asarray(getattr(mm, f))[keep]
        fin = np.isfinite(gb)
        assert (np.isfinite(gm) == fin).all(), f
        np.testing.assert_array_equal(gm[fin], gb[fin], err_msg=f)


def test_majmin_safety_gate_rejects_tight_margins(rng):
    from weightedld.core.majmin import majmin_safe_with_unknown

    # No unknowns at all: trivially safe.
    aln = rng.choice([0, 1], size=(30, 20)).astype(np.int8)
    assert majmin_safe_with_unknown(aln)
    # One unknown + a site whose top-2 counts tie: unsafe.
    aln2 = aln.copy()
    aln2[:15, 0] = 0
    aln2[15:, 0] = 1
    aln2[0, 5] = 5
    assert not majmin_safe_with_unknown(aln2)
    # Monomorphic sites are safe regardless of unknowns elsewhere.
    aln3 = np.zeros((30, 20), dtype=np.int8)
    aln3[0, 5] = 5
    aln3[:25, 1] = 1  # margins 20 vs u_max 1: safe
    assert majmin_safe_with_unknown(aln3)


def test_hybrid_partition_bit_equal_general(rng):
    # UNKNOWNs plus one tight-margin (count-tie) site: the GLOBAL
    # factorized safety test fails, but most tile PAIRS remain provably
    # safe — the session splits the plan (phase 0 factorized form,
    # phase 1 general form; majmin_tile_margins) and the merged output
    # must be bit-identical to forcing the general form everywhere.
    from dataclasses import replace

    from weightedld.runtime.driver import DriverConfig, LdSession

    n_seqs, n_sites = 64, 70  # tile=16 -> 5x5 tile grid (80 padded sites)
    aln = rng.choice([0, 0, 0, 0, 0, 1, 1, 2],
                     size=(n_seqs, n_sites)).astype(np.int8)
    aln[:32, 36] = 0          # count TIE: c1 == c2 -> margin 0 (tile 2)
    aln[32:, 36] = 1
    aln[5, 38] = 5            # UNKNOWN in the same tile -> (2, 2) unsafe
    aln[7, 3] = 5             # sparse UNKNOWN elsewhere (wide margins)
    w = (rng.random(n_seqs) + 0.05).astype(np.float32)
    sm = np.arange(n_sites)
    cfg = DriverConfig(tile=16, seq_chunk=64)

    ses = LdSession(aln, w, sm, cfg)
    assert ses._hybrid_safe is not None
    assert ses._hybrid_safe.any() and not ses._hybrid_safe.all()
    assert ses._runner2 is not None and ses._n_batches_p0 < ses.n_batches

    gen = LdSession(aln, w, sm, replace(cfg, kernel="general"))
    assert gen._hybrid_safe is None and gen._aux_dev is None
    assert not gen._majmin

    def rec_map(session):
        got = {}
        for _b, rec in session.stream():
            for a, b, d, dp, r2 in zip(rec.pos_a, rec.pos_b, rec.d,
                                       rec.d_prime, rec.r2):
                got[(int(a), int(b))] = (float(d), float(dp), float(r2))
        return got

    hyb, base = rec_map(ses), rec_map(gen)
    assert set(hyb) == set(base)
    # Unsafe-site packing may flip a pair's internal orientation (an
    # earlier DIRTY site is packed after its clean partner); the finalize
    # algebra is grouped swap-symmetrically and the factorized cells equal
    # the general form's selected cells, so every pair is bit-identical.
    assert ses._site_perm is not None
    for key, vals in base.items():
        assert hyb[key] == vals, key

    sh, sg = ses.summarize(), gen.summarize()
    assert sh["n_pairs"] == sg["n_pairs"]
    assert sh["n_over_threshold"] == sg["n_over_threshold"]
    np.testing.assert_allclose(sh["r2_sum_over_threshold"],
                               sg["r2_sum_over_threshold"], rtol=1e-5)
    np.testing.assert_allclose(sh["r2_max"], sg["r2_max"], rtol=1e-6)


def test_kernel_config_validation():
    from weightedld.runtime.driver import DriverConfig, LdSession

    aln = np.zeros((8, 8), dtype=np.int8)
    aln[:4, 1] = 1
    with np.testing.assert_raises(ValueError):
        LdSession(aln, np.ones(8, np.float32), np.arange(8),
                  DriverConfig(engine="xla", kernel="majmin"))


def test_int8_cascade_packer_error_bounds(rng):
    # Reconstruction w ~= sum_l a_l q_l: levels=2 within max|w|/64516,
    # levels=3 within one f32 ulp of max|w| (the documented bounds).
    from weightedld.core.majmin import pad_weights_int8

    w = (rng.random(1000).astype(np.float32) ** 4)  # spans 0..1, skewed low
    w[0] = 1.0
    for levels, bound in ((2, 1.0 / 64516), (3, 6.5e-8)):
        out = pad_weights_int8(w, seq_chunk=512, levels=levels)
        # f64 reconstruction: the bound is on the REPRESENTATION; the
        # kernel's f32 combine adds at most ~1 extra f32 ulp on top.
        rec = sum(out[levels + i][0].astype(np.float64)
                  * out[i].astype(np.float64) for i in range(levels))
        err = np.abs(rec[:1000] - w.astype(np.float64)).max()
        assert err <= bound, (levels, err)


def test_unsafe_site_packing_scattered_unknowns(rng):
    # The round-2 adversarial class: near-balanced allele counts (small
    # margins) with ~1% UNKNOWN cells SCATTERED over sites.  In input
    # order almost every tile pair contains an unsafe site and the hybrid
    # partition degenerates to the general kernel; the packing permutation
    # concentrates the dirty sites into trailing tiles so clean x clean
    # pairs (the bulk) run factorized.  Output must match the forced
    # general kernel as a SET with f32-tolerance values, and every
    # order-sensitive API must report in the caller's coordinates.
    from weightedld.runtime.driver import (
        DriverConfig, LdSession, collect_ld_records,
    )

    n_seqs, n_sites = 64, 160
    # Near-balanced biallelic sites -> margins of a few counts only.
    aln = rng.choice([0, 0, 1, 1, 1], size=(n_seqs, n_sites)).astype(np.int8)
    # Scatter UNKNOWNs over ~30% of sites (1-2 cells each).
    dirty_sites = rng.choice(n_sites, size=48, replace=False)
    for s in dirty_sites:
        aln[rng.integers(n_seqs), s] = 5
    w = (rng.random(n_seqs) + 0.05).astype(np.float32)
    sm = np.arange(n_sites) * 3 + 7  # non-trivial positions
    cfg = DriverConfig(tile=16, seq_chunk=64)

    ses = LdSession(aln, w, sm, cfg)
    assert ses._site_perm is not None          # packing engaged
    assert not ses._majmin and ses._hybrid_safe is not None
    # Dirty sites occupy the TRAILING internal slots.
    n_dirty = (np.asarray(
        [np.count_nonzero(aln[:, s] == 5) for s in range(n_sites)]) > 0).sum()
    tail = ses._site_perm[n_sites - n_dirty:]
    assert set(tail) == {s for s in range(n_sites)
                         if (aln[:, s] == 5).any()}
    # Packing makes the SAFE phase the bulk of the plan: every clean x
    # clean tile pair is safe, so unsafe pairs are bounded by
    # dirty_tiles * grid.
    grid = ses.plan.grid
    dirty_tiles = -(-int(n_dirty) // 16)
    n_unsafe = int((~ses._hybrid_safe).sum())
    assert n_unsafe <= dirty_tiles * grid, (n_unsafe, dirty_tiles, grid)
    assert n_unsafe < len(ses._hybrid_safe) // 2  # safe phase dominates

    def rec_map(records_iter):
        got = {}
        for rec in records_iter:
            for a, b, d, dp, r2 in zip(rec.pos_a, rec.pos_b, rec.d,
                                       rec.d_prime, rec.r2):
                got[(int(a), int(b))] = (d, dp, r2)
        return got

    hyb = rec_map(r for _, r in ses.stream())
    base = rec_map([collect_ld_records(
        aln, w, sm, DriverConfig(tile=16, seq_chunk=64,
                                 kernel="general"))])
    assert set(hyb) == set(base)
    for key, vals in base.items():
        np.testing.assert_allclose(hyb[key], vals, rtol=2e-5, atol=1e-6,
                                   err_msg=str(key))
    # Endpoint convention survives packing: pos_a < pos_b everywhere.
    assert all(a < b for a, b in hyb)

    # matrices() comes back in the CALLER's site order (upper triangle).
    mats = ses.matrices()
    gen_ses = LdSession(aln, w, sm, DriverConfig(
        tile=16, seq_chunk=64, kernel="general"))
    mats_gen = gen_ses.matrices()
    assert gen_ses._site_perm is None
    np.testing.assert_array_equal(mats["keep"], mats_gen["keep"])
    np.testing.assert_allclose(mats["r2"][mats["keep"]],
                               mats_gen["r2"][mats_gen["keep"]],
                               rtol=2e-5, atol=1e-6)
    assert not np.tril(mats["keep"], k=-1).any()

    # prune() reports kept positions in input order.
    kept = ses.prune(0.2)
    kept_gen = gen_ses.prune(0.2)
    np.testing.assert_array_equal(kept, kept_gen)
    assert (np.diff(kept) > 0).all()

    # ld_decay still accepts the (monotonic-in-input-order) site map and
    # bins identically to the unpacked session.
    decay = ses.ld_decay([0, 60, 600])
    decay_gen = gen_ses.ld_decay([0, 60, 600])
    assert decay["n_pairs"] == decay_gen["n_pairs"]
    np.testing.assert_allclose(decay["r2_sum"], decay_gen["r2_sum"],
                               rtol=1e-5)

    # top_pairs: endpoint convention + same top values.
    top = ses.top_pairs(7)
    assert all(int(a) < int(b) for a, b in zip(top.pos_a, top.pos_b))
    top_gen = gen_ses.top_pairs(7)
    np.testing.assert_allclose(np.sort(top.r2), np.sort(top_gen.r2),
                               rtol=2e-5, atol=1e-6)


def test_packing_under_windowed_plans_is_order_preserving(rng):
    # Round 5: windowed plans no longer disable packing — they use the
    # ORDER-PRESERVING class-split permutation (clean sites in input
    # order, then dirty sites in input order), so the interval plan's
    # clean band stays no wider than the unpermuted band.
    from weightedld.runtime.driver import DriverConfig, LdSession

    aln = rng.choice([0, 0, 1, 1, 1], size=(32, 64)).astype(np.int8)
    aln[3, 10] = 5
    aln[9, 40] = 5
    w = np.ones(32, np.float32)
    ses = LdSession(aln, w, np.arange(64), DriverConfig(
        tile=16, seq_chunk=32, max_site_distance=20))
    assert ses._windowed_packed and ses._site_perm is not None
    clean = [s for s in range(64) if s not in (10, 40)]
    np.testing.assert_array_equal(ses._site_perm, clean + [10, 40])


def test_windowed_unsafe_site_packing_parity(rng):
    """Round-5: unsafe-site packing under WINDOWED plans.  The class-split
    permutation + interval plan + |distance| lookup masks must reproduce
    the forced-general windowed run exactly (same record set, same
    summarize population, same decay curve) for a site-index window, a bp
    window, and their composition."""
    from weightedld.runtime.driver import (
        DriverConfig, LdSession, collect_ld_records,
    )

    n_seqs, n_sites = 64, 160
    aln = rng.choice([0, 0, 1, 1, 1], size=(n_seqs, n_sites)).astype(np.int8)
    dirty_sites = rng.choice(n_sites, size=14, replace=False)
    for s in dirty_sites:
        aln[rng.integers(n_seqs), s] = 5
    w = (rng.random(n_seqs) + 0.05).astype(np.float32)
    sm = np.arange(n_sites) * 3 + 7

    def rec_map(records_iter):
        got = {}
        for rec in records_iter:
            for a, b, d, dp, r2 in zip(rec.pos_a, rec.pos_b, rec.d,
                                       rec.d_prime, rec.r2):
                got[(int(a), int(b))] = (d, dp, r2)
        return got

    for win_kw in ({"max_site_distance": 60},
                   {"max_bp_distance": 150},
                   {"max_site_distance": 70, "max_bp_distance": 180}):
        cfg = DriverConfig(tile=16, seq_chunk=64,
                           r2_threshold=None, **win_kw)
        ses = LdSession(aln, w, sm, cfg)
        assert ses._windowed_packed and ses._site_perm is not None, win_kw
        assert ses._hybrid_safe is not None
        # The clean band dominates the plan: unsafe pairs are bounded by
        # (dirty tiles + straddler) x grid.
        n_unsafe = int((~ses._hybrid_safe).sum())
        assert n_unsafe < len(ses._hybrid_safe), win_kw

        base_cfg = DriverConfig(tile=16, seq_chunk=64,
                                kernel="general", r2_threshold=None,
                                **win_kw)
        base_ses = LdSession(aln, w, sm, base_cfg)
        assert base_ses._site_perm is None  # forced general: no packing

        hyb = rec_map(r for _, r in ses.stream())
        base = rec_map(r for _, r in base_ses.stream())
        assert set(hyb) == set(base), win_kw
        assert len(hyb) > 0
        for key, vals in base.items():
            np.testing.assert_allclose(hyb[key], vals, rtol=2e-5,
                                       atol=1e-6, err_msg=str((win_kw, key)))
        assert all(a < b for a, b in hyb)

        s_h = ses.summarize(r2_threshold=0.05)
        s_b = base_ses.summarize(r2_threshold=0.05)
        assert s_h["n_pairs"] == s_b["n_pairs"], win_kw
        assert s_h["n_over_threshold"] == s_b["n_over_threshold"], win_kw

        edges = (0, 50, 200, 500)
        d_h = ses.ld_decay(edges)
        d_b = base_ses.ld_decay(edges)
        assert d_h["n_pairs"] == d_b["n_pairs"], win_kw
        np.testing.assert_allclose(d_h["r2_sum"], d_b["r2_sum"],
                                   rtol=1e-5, atol=1e-7)

    # top_pairs and matrices under the windowed packing permutation.
    cfg = DriverConfig(tile=16, seq_chunk=64,
                       r2_threshold=None, max_site_distance=60)
    ses = LdSession(aln, w, sm, cfg)
    base_ses = LdSession(aln, w, sm, DriverConfig(
        tile=16, seq_chunk=64, kernel="general",
        r2_threshold=None, max_site_distance=60))
    top = ses.top_pairs(9)
    top_b = base_ses.top_pairs(9)
    assert all(int(a) < int(b) for a, b in zip(top.pos_a, top.pos_b))
    np.testing.assert_allclose(np.sort(top.r2), np.sort(top_b.r2),
                               rtol=2e-5, atol=1e-6)
    m = ses.matrices()
    m_b = base_ses.matrices()
    np.testing.assert_array_equal(m["keep"], m_b["keep"])
    np.testing.assert_allclose(
        np.nan_to_num(m["r2"], nan=-1.0),
        np.nan_to_num(m_b["r2"], nan=-1.0), rtol=2e-5, atol=1e-6)

    # Window population sanity vs the dense oracle restricted by hand.
    got = rec_map(r for _, r in ses.stream())
    full = rec_map([collect_ld_records(
        aln, w, sm, DriverConfig(tile=16, seq_chunk=64,
                                 kernel="general", r2_threshold=None))])
    expect = {k: v for k, v in full.items()
              if (k[1] - k[0]) // 3 <= 60}  # positions are 3*idx+7
    assert set(got) == set(expect)


def test_windowed_packing_gate_dense_dirt(rng):
    """Dense dirt under a narrow window must NOT trigger the windowed
    packing permutation (the dirty rows would outweigh the band saving)."""
    from weightedld.runtime.driver import DriverConfig, LdSession

    n_seqs, n_sites = 48, 128
    aln = rng.choice([0, 0, 1, 1, 1], size=(n_seqs, n_sites)).astype(np.int8)
    dirty_sites = rng.choice(n_sites, size=40, replace=False)  # 2*40 > 32
    for s in dirty_sites:
        aln[rng.integers(n_seqs), s] = 5
    w = np.ones(n_seqs, np.float32)
    ses = LdSession(aln, w, np.arange(n_sites),
                    DriverConfig(tile=16, seq_chunk=64,
                                 max_site_distance=32))
    assert not ses._windowed_packed and ses._site_perm is None


def _dot_operand_dtypes(fn, *args):
    """Operand dtypes of every dot_general in ``fn``'s jaxpr (nested
    jaxprs included)."""
    import jax

    found = []

    def walk(jaxpr):
        for eqn in jaxpr.eqns:
            if eqn.primitive.name == "dot_general":
                found.append(tuple(str(v.aval.dtype) for v in eqn.invars))
            for sub in jax.core.jaxprs_in_params(eqn.params):
                walk(sub)

    walk(jax.make_jaxpr(fn)(*args).jaxpr)
    return found


@pytest.mark.parametrize("form,wquant,want", [
    ("majmin", "int8x3", {("int8", "int8")}),
    ("general", "int8x3", {("int8", "int8")}),
    ("general", "", {("bfloat16", "bfloat16"), ("int8", "int8")}),
])
def test_no_float32_matmul_on_engine_paths(rng, form, wquant, want):
    # No float32 matrix product (which a GPU may run in TF32) on the
    # engine's paths: the int8x3 cascade and the count dots are integer,
    # the split-bf16 mode multiplies bf16 operands with f32 accumulation.
    n_seqs, n_sites, tile, chunk = 40, 40, 16, 64
    aln = rng.choice([0, 1, 2], size=(n_seqs, n_sites)).astype(np.int8)
    w = (rng.random(n_seqs) + 0.05).astype(np.float32)
    plan, ti, tj, em = _plan_args(n_sites, tile)
    codes = jnp.asarray(pad_alignment_site_major(aln, tile, chunk))
    wr = jnp.asarray(PACK[wquant](w, chunk))
    kw = dict(tile=tile, n_sites=n_sites, wquant=wquant)
    if form == "majmin":
        aux = jnp.asarray(majmin_site_aux(aln, plan.s_pad))
        fn = partial(tile_stats_majmin, **kw)
        args = (codes, wr, aux, ti, tj, em)
    else:
        fn = partial(tile_stats_general, **kw)
        args = (codes, wr, ti, tj, em)
    dts = _dot_operand_dtypes(fn, *args)
    assert dts and set(dts) == want


@pytest.mark.gpu
def test_engine_on_gpu_matches_f32_reference(gpu_device):
    # Both integer forms, compiled for the card at real width (N=5,008
    # haplotypes, T=256), against the f32 HIGHEST reference tile path on
    # the same card: identical keep masks, values within the int8x3
    # cascade's f32 rounding.  The general form sees UNKNOWN cells that
    # change pairs' alleles; the factorized form the same data without them.
    from weightedld.io.synthetic import synthetic_haplotypes

    rng = np.random.default_rng(20265)
    n_seqs, tile = 5008, 256
    n_sites = 4 * tile
    clean = synthetic_haplotypes(rng, n_seqs, n_sites).astype(np.int8)
    dirty = clean.copy()
    dirty[rng.random(dirty.shape) < 0.002] = 5
    w = (rng.random(n_seqs) + 0.05).astype(np.float32)
    w /= w.max()
    plan, ti, tj, em = _plan_args(n_sites, tile)
    wr = jnp.asarray(PACK["int8x3"](w))
    kw = dict(tile=tile, n_sites=n_sites, wquant="int8x3")
    aux = jnp.asarray(majmin_site_aux(clean, plan.s_pad))
    for aln, got in (
            (clean, tile_stats_majmin(
                jnp.asarray(pad_alignment_site_major(clean, tile)), wr, aux,
                ti, tj, em, **kw)),
            (dirty, tile_stats_general(
                jnp.asarray(pad_alignment_site_major(dirty, tile)), wr,
                ti, tj, em, **kw))):
        assert got.r2.devices() == {gpu_device}
        ref = _reference(aln, w, tile)
        assert np.asarray(ref.keep).sum() > 10_000
        _assert_close(got, ref)


def _float32_products(hlo: str) -> list:
    """Lines of an optimized HLO module that multiply f32 operands: dots,
    and library GEMM custom calls (operand types resolved through their
    defining instructions)."""
    import re

    dtype = dict(re.findall(r"%([\w.\-]+) = (\w+)\[", hlo))
    bad = []
    for line in hlo.splitlines():
        m = re.search(r"\b(dot|custom-call)\(([^)]*)\)", line)
        if not m or (m.group(1) == "custom-call"
                     and not re.search(r"gemm|matmul", line)):
            continue
        ops = re.findall(r"%([\w.\-]+)", m.group(2))
        if any(dtype.get(o) == "f32" for o in ops):
            bad.append(line.strip())
    return bad


def test_float32_product_scan_finds_f32_dots():
    # The HLO scan the card-only test relies on flags an f32 dot and
    # passes an integer one (checked on CPU-compiled programs).
    import jax

    x32 = jnp.ones((64, 64), jnp.float32)
    x8 = jnp.ones((64, 64), jnp.int8)
    f = jax.jit(lambda a, b: jax.lax.dot_general(
        a, b, (((1,), (1,)), ((), ())), preferred_element_type=jnp.int32))
    assert _float32_products(f.lower(x8, x8).compile().as_text()) == []
    g = jax.jit(lambda a, b: a @ b)
    assert _float32_products(g.lower(x32, x32).compile().as_text())


@pytest.mark.gpu
def test_gpu_compiled_engine_has_no_float32_product(gpu_device):
    # The engine's programs as compiled for the card multiply integers
    # only: no f32 dot or f32 library GEMM in the optimized HLO.
    import jax

    rng = np.random.default_rng(12)
    n_seqs, n_sites, tile = 256, 512, 128
    aln = rng.choice([0, 1, 2], size=(n_seqs, n_sites)).astype(np.int8)
    w = (rng.random(n_seqs) + 0.05).astype(np.float32)
    plan, ti, tj, em = _plan_args(n_sites, tile)
    codes = jnp.asarray(pad_alignment_site_major(aln, tile))
    wr = jnp.asarray(PACK["int8x3"](w))
    aux = jnp.asarray(majmin_site_aux(aln, plan.s_pad))
    kw = dict(tile=tile, n_sites=n_sites, wquant="int8x3")
    for fn, args in (
            (partial(tile_stats_majmin, **kw), (codes, wr, aux, ti, tj, em)),
            (partial(tile_stats_general, **kw), (codes, wr, ti, tj, em))):
        hlo = jax.jit(fn).lower(*args).compile().as_text()
        assert _float32_products(hlo) == []
