"""Multi-device execution: shard the site-pair triangle across a device mesh.

The device replacement for the reference's rayon work-stealing pool
(``lib.rs:613-679``): the linearized upper-triangle tile list is striped
across a 1-D ``jax.sharding.Mesh`` axis; the alignment matrix and weight
vector are replicated; each device evaluates and *compacts* its own
tiles, so cross-device traffic is O(results), not O(pairs).

Communication accounting (SURVEY.md §2.3): inputs are broadcast once;
per-batch outputs are fixed-capacity compacted record buffers gathered
host-side; no collective runs inside the hot loop.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..core.ld_tiled import compact_tile_stats, tile_stats_batch
from ..core.tile_engine import tile_stats_general, tile_stats_majmin

AXIS = "tiles"


def default_mesh(devices=None) -> Mesh:
    devices = devices if devices is not None else jax.devices()
    return Mesh(np.asarray(devices), (AXIS,))


_RUNNER_CACHE: dict = {}


def replicate(mesh: Mesh, *arrays):
    """Device_put arrays fully-replicated over the mesh."""
    sharding = NamedSharding(mesh, P())
    return tuple(jax.device_put(a, sharding) for a in arrays)


def make_sharded_stats_runner(
    mesh: Mesh,
    *,
    tile: int,
    n_sites: int,
    k_per_batch: int,
    engine: str = "xla",
    planes: tuple = (0, 1, 2, 3, 4),
    exact_weights: bool = False,
    unit_weights: bool = False,
    wquant: str = "",
    majmin: bool = False,
    max_site_distance: int | None = None,
    max_bp_distance: int | None = None,
    windows_by_lookup: bool = False,
    emit_capacity: int | None = None,
    wire_scale: int | None = None,
    cross_split: int | None = None,
):
    """Stats-only sharded pass: evaluate one batch of tiles, apply the r2
    threshold, and return per-tile record counts plus the masked stat
    tensors (left on device, sharded over the batch axis).

    ``engine="int8"`` runs the site-major integer engine
    (``core.tile_engine``: the factorized form when ``majmin``, else the
    general per-pair form); ``engine="xla"`` the f32 sequence-major
    reference path (``core.ld_tiled.tile_stats_batch``).

    The full striped tile plan lives on device (uploaded once by the
    driver); each dispatch selects its batch by a scalar index, so the only
    per-batch host<->device traffic is that scalar down and the small
    count/moment vectors up.  Record extraction runs as a separate
    gather-compact dispatch over the batch's stat tensors unless the
    compaction is fused (below).

    ``emit_capacity``: when set, each SHARD additionally slot-compacts its
    surviving records into a ``[capacity, 5]`` int32 block INSIDE the same
    program (sites + f32 D/D'/r2 bitcast — the ``gather_compact`` packing)
    and the runner returns it as a 10th output, so streaming pays one
    program launch per batch.  The per-shard record count can exceed the
    capacity — the caller detects overflow from the fused moments and
    re-dispatches an exact gather (the driver's speculative-capacity
    protocol).

    ``wire_scale`` (with ``emit_capacity``): pack the records in the
    compressed 12-byte fixed-point wire format for ``10^-d``-precision
    text output instead of the 20-byte sites+f32 block — see
    ``compact_tile_stats``; the packed output is then ``[cap, 3]``.
    """
    if engine not in ("int8", "xla"):
        raise ValueError(f"engine must be int8|xla, got {engine!r}")
    key = (
        "stats", tuple(d.id for d in mesh.devices.flat), tile, n_sites,
        k_per_batch, engine, planes, exact_weights, unit_weights,
        wquant, majmin, max_site_distance, max_bp_distance,
        windows_by_lookup, emit_capacity, wire_scale, cross_split,
    )
    cached = _RUNNER_CACHE.get(key)
    if cached is not None:
        return cached

    n_dev = mesh.devices.size
    k = k_per_batch
    weight_kw = dict(exact_weights=exact_weights, unit_weights=unit_weights,
                     wquant=wquant)

    def local_fn(codes, weights, aux, sm_pad, orig_pad, ti_all, tj_all,
                 em_all, batch, r2_threshold):
        sl = (batch * k,)
        tile_i = jax.lax.dynamic_slice(ti_all, sl, (k,))
        tile_j = jax.lax.dynamic_slice(tj_all, sl, (k,))
        emit = jax.lax.dynamic_slice(em_all, sl, (k,))
        if engine == "int8" and majmin:
            st = tile_stats_majmin(
                codes, weights, aux, tile_i, tile_j, emit,
                tile=tile, n_sites=n_sites, **weight_kw)
        elif engine == "int8":
            st = tile_stats_general(
                codes, weights, tile_i, tile_j, emit,
                tile=tile, n_sites=n_sites, planes=planes, **weight_kw)
        else:
            st = tile_stats_batch(
                codes, weights, tile_i, tile_j, emit != 0,
                tile=tile, n_sites=n_sites,
            )
        keep = st.keep
        if max_site_distance is not None:
            # Windowed LD: pair distance in kept-site index space.  Folded
            # into `keep` so record extraction AND summarize() see the same
            # pair population.
            li = jnp.arange(tile, dtype=jnp.int32)
            if windows_by_lookup:
                # Packed (permuted) layout: layout index != kept-site
                # index, so distance comes from the replicated original-
                # index lookup, |.| because layout order is class-split.
                oa = orig_pad[tile_i[:, None] * tile + li[None, :]]
                ob = orig_pad[tile_j[:, None] * tile + li[None, :]]
                keep = keep & (
                    jnp.abs(ob[:, None, :] - oa[:, :, None])
                    <= max_site_distance)
            else:
                gi = tile_i[:, None, None] * tile + li[None, :, None]
                gj = tile_j[:, None, None] * tile + li[None, None, :]
                keep = keep & (gj - gi <= max_site_distance)
        if max_bp_distance is not None:
            # Windowed LD in site_map units (bp for VCF — PLINK-style):
            # per-tile position lookup from the replicated padded site map,
            # same mechanics as the decay runner.  |.| under the packing
            # permutation (the permuted map is non-monotonic; validation
            # ran against the input order).
            li = jnp.arange(tile, dtype=jnp.int32)
            pa = sm_pad[tile_i[:, None] * tile + li[None, :]]   # [K, T]
            pb = sm_pad[tile_j[:, None] * tile + li[None, :]]
            dist = pb[:, None, :] - pa[:, :, None]
            if windows_by_lookup:
                dist = jnp.abs(dist)
            keep = keep & (dist <= max_bp_distance)
        if cross_split is not None:
            # Rectangular (inter-region) mode: keep only pairs crossing the
            # layout split (a in block A, b in block B).  Folded into
            # `keep`, so records, summarize, top-k, decay, histograms and
            # matrices all see the same rectangle population.
            li = jnp.arange(tile, dtype=jnp.int32)
            gi = tile_i[:, None, None] * tile + li[None, :, None]
            gj = tile_j[:, None, None] * tile + li[None, None, :]
            keep = keep & (gi < cross_split) & (gj >= cross_split)
        # Strict > threshold; kept pairs have non-NaN r2 (paircore keep
        # rules skip the reference's crash cases), so thr == -inf emits all.
        mask = keep & (st.r2 > r2_threshold)
        tile_counts = mask.sum(axis=(1, 2)).astype(jnp.int32)
        # Per-batch reduction moments, fused into this dispatch so
        # summarize() never needs a second pass over the [K,T,T] outputs.
        # Counts stay int32: a batch can exceed 2^24 pairs, beyond f32
        # integer precision.
        mom_counts = jnp.stack([
            keep.sum().astype(jnp.int32),
            mask.sum().astype(jnp.int32),
        ])
        mom_vals = jnp.stack([
            jnp.where(mask, st.r2, 0.0).sum(),
            jnp.where(keep, st.r2, -jnp.inf).max(),
        ])
        # One fused [1, 4] int32 array per shard (f32 moments bitcast for
        # transport): summarize() then needs a SINGLE host fetch per batch.
        moments = jnp.concatenate(
            [mom_counts, jax.lax.bitcast_convert_type(mom_vals, jnp.int32)]
        )[None]
        outs = (tile_counts, st.d, st.d_prime, st.r2, mask, tile_i, tile_j,
                keep, moments)
        if emit_capacity:
            # Per-shard slot compaction fused into the stats program: no
            # cross-shard traffic (each shard packs its OWN records), same
            # record order as the separate gather within a shard.  Guarded
            # by a real runtime branch on the (already-computed) record
            # count: a zero-yield batch skips the O(K*T^2) survivor sweep
            # entirely — sparse scans are the streaming engine's hot case.
            from ..core.paircore import PairStats

            stp = PairStats(d=st.d, d_prime=st.d_prime, r2=st.r2, keep=mask)

            n_wire = 3 if wire_scale is not None else 5

            def _do_compact(_):
                if wire_scale is not None:
                    _cnt, packed = compact_tile_stats(
                        stp, tile_i, tile_j, jnp.float32(-jnp.inf),
                        tile=tile, capacity=emit_capacity,
                        wire_scale=wire_scale,
                    )
                    return packed
                _cnt, sites, values = compact_tile_stats(
                    stp, tile_i, tile_j, jnp.float32(-jnp.inf),
                    tile=tile, capacity=emit_capacity,
                )
                return jnp.concatenate(
                    [sites,
                     jax.lax.bitcast_convert_type(values, jnp.int32)],
                    axis=1,
                )

            def _no_records(_):
                return jnp.zeros((emit_capacity, n_wire), jnp.int32)

            packed = jax.lax.cond(
                mom_counts[1] > 0, _do_compact, _no_records, None,
            )[None]                                       # [1, cap, n_wire]
            outs = outs + (packed,)
        return outs

    n_out = 10 if emit_capacity else 9
    fn = jax.jit(jax.shard_map(
        local_fn,
        mesh=mesh,
        in_specs=(P(), P(), P(), P(), P(),
                  P(AXIS), P(AXIS), P(AXIS), P(), P()),
        out_specs=(P(AXIS),) * n_out,
        check_vma=False,
    ))

    # Replicated placeholders for the aux/site-map operands when unused
    # (the local_fn never touches them; a fixed tiny array keeps the call
    # signature — and the compiled program — uniform across modes).
    dummy_aux, dummy_sm = replicate(
        mesh, np.zeros((1, 1), np.int32), np.zeros(1, np.int32))

    def runner(codes, weights, ti_all, tj_all, em_all, batch, r2_threshold,
               aux=None, sm_pad=None, orig_pad=None):
        return fn(
            codes, weights,
            dummy_aux if aux is None else aux,
            dummy_sm if sm_pad is None else sm_pad,
            dummy_sm if orig_pad is None else orig_pad,
            ti_all, tj_all, em_all,
            jnp.int32(batch), jnp.float32(r2_threshold),
        )

    runner.mesh = mesh
    runner.n_dev = n_dev
    _RUNNER_CACHE[key] = runner
    return runner


def make_topk_runner(mesh: Mesh, *, tile: int, k_out: int):
    """Per-batch top-k selection by r2 over KEPT pairs (threshold-free).

    Runs on the device-resident ``[K, T, T]`` stat tensors of a dispatched
    batch: each shard first reduces every tile to its max kept r2 (one
    cheap sweep), selects the top ``k_out`` CANDIDATE TILES by that max,
    and only sorts the candidates' ``k_out * T^2`` pairs — instead of a
    ``lax.top_k`` over the whole batch's K*T^2 values.

    The prefilter is exact up to ties at the k-th value (which the
    :meth:`~weightedld.runtime.driver.LdSession.top_pairs` contract
    already leaves arbitrary): any pair with r2 strictly above the k-th
    value lives in a tile whose max is outranked by at most k-1 other tile
    maxes — if k tiles outranked it, each would contain a pair at least as
    large, contradicting the pair's top-k membership — so all such pairs
    are inside the candidate set, and when some tile holding a tied pair
    falls outside, the k candidate tiles each contribute a pair >= the
    k-th value anyway.

    Packs ``[1, k_out, 5]`` int32 records (global site indices + D/D'/r2
    bitcast) — the same one-fetch transport as ``gather_compact``.  Host
    traffic is O(n_dev * k_out) per batch; the host merges batches.
    Slots beyond the shard's kept-pair count carry r2 == -inf (filter them
    after the bitcast round-trip)."""
    key = ("topk", tuple(d.id for d in mesh.devices.flat), tile, k_out)
    cached = _RUNNER_CACHE.get(key)
    if cached is not None:
        return cached

    def local_fn(d, dp, r2, keep, tile_i, tile_j):
        t = tile
        t2 = t * t
        masked = jnp.where(keep, r2, -jnp.inf)           # [K, T, T]
        tile_max = masked.max(axis=(1, 2))               # [K]
        kt_n = min(k_out, tile_max.shape[0])
        _mv, cand = jax.lax.top_k(tile_max, kt_n)        # [kt_n] tile ids
        sub = masked[cand].reshape(-1)                   # [kt_n * T^2]
        kk = min(k_out, sub.shape[0])
        vals, idx = jax.lax.top_k(sub, kk)
        kt = cand[idx // t2]
        rem = idx % t2
        gi = tile_i[kt] * t + rem // t
        gj = tile_j[kt] * t + rem % t
        # Row gather + vectorized one-hot column select (the same
        # selection as compact_tile_stats).  The one-hot sum runs on
        # int32 bit patterns so an exactly -0.0 stat survives the
        # select (-0.0 + 0.0 would normalize to +0.0 in a float sum)
        # and row NaN/inf is zeroed before the sum.
        grow = kt * t + rem // t                         # row in [K*T]
        gcol = (rem % t)[:, None]
        lane = jnp.arange(t, dtype=jnp.int32)[None, :]

        def sel(x):
            rows = x.reshape(-1, t)[grow]                # [kk, T]
            bits = jax.lax.bitcast_convert_type(
                rows.astype(jnp.float32), jnp.int32)
            out = jnp.where(lane == gcol, bits, 0).sum(axis=1)
            return jax.lax.bitcast_convert_type(out, jnp.float32)

        values = jnp.stack([sel(d), sel(dp), vals], axis=1)
        packed = jnp.concatenate(
            [jnp.stack([gi, gj], axis=1),
             jax.lax.bitcast_convert_type(values, jnp.int32)],
            axis=1,
        )
        if kk < k_out:  # degenerate tiny batches: pad to the static shape
            pad = jnp.tile(
                jnp.concatenate([
                    jnp.zeros(2, jnp.int32),
                    jax.lax.bitcast_convert_type(
                        jnp.asarray([0.0, 0.0, -jnp.inf], jnp.float32),
                        jnp.int32),
                ])[None], (k_out - kk, 1),
            )
            packed = jnp.concatenate([packed, pad], axis=0)
        return packed[None]

    fn = jax.jit(jax.shard_map(
        local_fn,
        mesh=mesh,
        in_specs=(P(AXIS),) * 6,
        out_specs=P(AXIS),
        check_vma=False,
    ))
    _RUNNER_CACHE[key] = fn
    return fn


def make_decay_runner(mesh: Mesh, *, tile: int, edges: tuple):
    """Per-batch LD-decay accumulation: per distance bin, the kept-pair
    count, r2 sum, |D'| sum, and |D'|-finite count, computed on device in
    ONE pass over the batch's resident stats (XLA fuses the per-bin
    selects into a single read of r2/d_prime/keep).

    |D'| is summed over kept pairs with a FINITE D' only (the reference's
    zero-denominator fallback yields NaN D' for degenerate pairs,
    ``WeightedLD.py:269-277`` — those count toward r2 but not |D'|), with
    the finite count reported so means stay truthful.

    Distance is measured in ``site_map`` coordinates (bp for VCF input),
    looked up per tile from the replicated padded site map.  ``edges`` is a
    static ascending tuple; bin b covers ``edges[b] <= dist < edges[b+1]``.
    Returns ``[n_dev, B, 4]`` int32 (count, f32 r2-sum bitcast, f32
    |D'|-sum bitcast, |D'|-finite count)."""
    key = ("decay", tuple(d.id for d in mesh.devices.flat), tile, edges)
    cached = _RUNNER_CACHE.get(key)
    if cached is not None:
        return cached

    def local_fn(r2, dp, keep, tile_i, tile_j, sm_pad):
        t = tile
        li = jnp.arange(t, dtype=jnp.int32)
        sma = sm_pad[tile_i[:, None] * t + li[None, :]]   # [K, T]
        smb = sm_pad[tile_j[:, None] * t + li[None, :]]
        # |distance|: orientation-free, so the unsafe-site packing
        # permutation (driver) bins identically to genomic order.
        dist = jnp.abs(smb[:, None, :] - sma[:, :, None])  # [K, T, T]
        adp = jnp.abs(dp)
        dp_ok = jnp.isfinite(adp)
        counts, sums, dpsums, dpcounts = [], [], [], []
        for b in range(len(edges) - 1):
            m = keep & (dist >= edges[b]) & (dist < edges[b + 1])
            counts.append(m.sum().astype(jnp.int32))
            sums.append(jnp.where(m, r2, 0.0).sum())
            mf = m & dp_ok
            dpsums.append(jnp.where(mf, adp, 0.0).sum())
            dpcounts.append(mf.sum().astype(jnp.int32))
        packed = jnp.stack([
            jnp.stack(counts),
            jax.lax.bitcast_convert_type(jnp.stack(sums), jnp.int32),
            jax.lax.bitcast_convert_type(jnp.stack(dpsums), jnp.int32),
            jnp.stack(dpcounts),
        ], axis=1)                                        # [B, 4]
        return packed[None]

    fn = jax.jit(jax.shard_map(
        local_fn,
        mesh=mesh,
        in_specs=(P(AXIS), P(AXIS), P(AXIS), P(AXIS), P(AXIS), P()),
        out_specs=P(AXIS),
        check_vma=False,
    ))
    _RUNNER_CACHE[key] = fn
    return fn


def make_hist_runner(mesh: Mesh, *, edges: tuple):
    """Per-batch r2 histogram over kept pairs: one on-device pass (XLA
    fuses the per-bin selects into a single read of r2/keep), O(B) host
    traffic.  ``edges`` is a static ascending tuple of floats; bin b
    covers ``edges[b] <= r2 < edges[b+1]``.  Returns ``[n_dev, B]``
    int32 counts."""
    key = ("hist", tuple(d.id for d in mesh.devices.flat), edges)
    cached = _RUNNER_CACHE.get(key)
    if cached is not None:
        return cached

    def local_fn(r2, keep):
        counts = [
            (keep & (r2 >= edges[b]) & (r2 < edges[b + 1]))
            .sum().astype(jnp.int32)
            for b in range(len(edges) - 1)
        ]
        return jnp.stack(counts)[None]

    fn = jax.jit(jax.shard_map(
        local_fn,
        mesh=mesh,
        in_specs=(P(AXIS), P(AXIS)),
        out_specs=P(AXIS),
        check_vma=False,
    ))
    _RUNNER_CACHE[key] = fn
    return fn


def gather_compact(d, dp, r2, mask, tile_i, tile_j, *, tile, capacity,
                   mesh=None):
    """Compact a batch's surviving records into one fixed-capacity block
    (cached jit by shapes).

    Args:
        d/dp/r2/mask: ``[K, T, T]`` batch stat tensors (device-resident).
        tile_i/tile_j: ``[K]`` tile coordinates of the batch.
        mesh: when given, the outputs are constrained FULLY REPLICATED over
            it — required in multi-process runs so every host can fetch the
            compacted records (GSPMD would otherwise leave them sharded on
            non-addressable devices).
    Returns:
        (count, packed [capacity, 5] int32) — columns 0-1 are the global
        site indices, columns 2-4 the f32 (D, D', r2) bitcast to int32 so
        the whole record block travels to the host in ONE fetch.

    The compaction is slot-driven (see ``compact_tile_stats``): per batch
    it costs one cheap mask pass plus O(capacity * T) work, so it runs at
    full batch shape with no live-tile pre-gather — one compiled program
    per (batch shape, capacity bucket).
    """
    return _gather_compact_jit(mesh)(
        d, dp, r2, mask, tile_i, tile_j, tile=tile, capacity=capacity
    )


def _gc_impl(d, dp, r2, mask, tile_i, tile_j, *, tile, capacity):
    from ..core.ld_tiled import compact_tile_stats
    from ..core.paircore import PairStats

    st = PairStats(d=d, d_prime=dp, r2=r2, keep=mask)
    count, sites, values = compact_tile_stats(
        st, tile_i, tile_j, jnp.float32(-jnp.inf),
        tile=tile, capacity=capacity,
    )
    packed = jnp.concatenate(
        [sites, jax.lax.bitcast_convert_type(values, jnp.int32)], axis=1
    )
    return count, packed


_GC_CACHE: dict = {}


def _gather_compact_jit(mesh):
    key = (None if mesh is None
           else tuple(d.id for d in mesh.devices.flat))
    fn = _GC_CACHE.get(key)
    if fn is None:
        if mesh is None:
            fn = jax.jit(_gc_impl, static_argnames=("tile", "capacity"))
        else:
            repl = NamedSharding(mesh, P())
            fn = jax.jit(_gc_impl, static_argnames=("tile", "capacity"),
                         out_shardings=(repl, repl))
        _GC_CACHE[key] = fn
    return fn
