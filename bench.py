#!/usr/bin/env python
"""Headline benchmark: weighted-LD site-pairs/s on one GPU.

Runs the full streaming engine (LdSession: the site-major integer engine,
the sharded driver and on-device compaction) on synthetic alignments, and
the native C++ SIMD/OpenMP baseline (the reference's Rust-SIMD equivalent)
on the same distribution, then prints ONE JSON line:

    {"metric": ..., "value": pairs/s, "unit": ..., "vs_baseline": ratio,
     "device": {...}}

vs_baseline = device pairs/s : native CPU baseline pairs/s on this host.
Every JSON names the device it ran on (platform, device_kind, device
count, and the nvidia-smi name and power limit).  Without a GPU the bench
refuses to run, except under ``JAX_PLATFORMS=cpu`` — the CPU test hooks,
which run shrunken shapes and measure nothing about a device.
"""

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
if str(REPO) not in sys.path:  # robust to being launched from any cwd
    sys.path.insert(0, str(REPO))

from weightedld.io.synthetic import criterion_alignment  # noqa: E402

N_SEQS = 1000
S_FULL = 49152
S_CPU = 2048
R2_THRESHOLD = 0.1
TILE = None  # auto
TILES_PER_BATCH = None  # auto: sized from the device's memory


def cpu_hooks() -> bool:
    """True when the caller pinned JAX to the CPU (the test hooks)."""
    return os.environ.get("JAX_PLATFORMS", "").lower() == "cpu"


def gpu_info() -> dict | None:
    """nvidia-smi's name and power limit of each visible card, or None."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    cards = [ln.split(", ") for ln in out.strip().splitlines() if ln]
    return {"name": cards[0][0], "power_limit": cards[0][-1],
            "n_visible": len(cards)} if cards else None


def device_record(devices=None) -> dict:
    import jax

    devices = devices if devices is not None else jax.devices()
    return {"platform": devices[0].platform,
            "kind": devices[0].device_kind,
            "count": len(devices),
            "nvidia_smi": gpu_info()}


def require_gpu() -> bool:
    """True on a GPU; False under the CPU test hooks; exits otherwise."""
    import jax

    platform = jax.devices()[0].platform
    if platform == "gpu":
        return True
    if cpu_hooks():
        print(f"[bench] JAX_PLATFORMS=cpu: CPU test hooks, shrunken shapes "
              f"— no device metric", file=sys.stderr)
        return False
    print(f"bench.py: needs a GPU (JAX backend is {platform!r}); set "
          "JAX_PLATFORMS=cpu for the CPU test hooks", file=sys.stderr)
    raise SystemExit(2)


def synthetic_alignment(rng, n_seqs, n_sites):
    """60% major allele / 30% minor / 10% missing — the reference's criterion
    bench distribution (benches/bench_weighted_pair_ld.rs:8-28)."""
    return criterion_alignment(rng, n_seqs, n_sites)


def _native_bench(n_seqs: int, n_sites: int) -> dict | None:
    """Run the native C++ baseline's --bench mode (auto-building it once);
    returns its stats dict or None."""
    exe = REPO / "native" / "weighted_ld_baseline"
    if not exe.exists():
        try:
            # Build only the baseline binary: the default target also links
            # libwldio.so against zlib, which the bench does not need.
            subprocess.run(
                ["make", "-C", str(REPO / "native"), "weighted_ld_baseline"],
                check=True, capture_output=True, timeout=120)
        except Exception as e:
            print(f"[bench] native baseline build failed: {e}", file=sys.stderr)
            return None
    try:
        out = subprocess.run(
            [str(exe), "--bench", str(n_seqs), str(n_sites)],
            capture_output=True, text=True, timeout=600, check=True,
        ).stdout
        return json.loads(out.strip().splitlines()[-1])
    except Exception as e:
        print(f"[bench] native baseline run failed: {e}", file=sys.stderr)
        return None


def bench_cpu_baseline() -> float | None:
    # Best of 3: a shared host varies under interference — the device side
    # is also best-of-N, so the ratio compares both at their
    # least-disturbed.
    best = None
    threads = None
    for _ in range(3):
        stats = _native_bench(N_SEQS, S_CPU)
        if stats is None:
            break
        if best is None or stats["pairs_per_s"] > best:
            best = float(stats["pairs_per_s"])
            threads = stats["threads"]
    if best is None:
        return None
    print(f"[bench] cpu baseline: {best:,.0f} pairs/s "
          f"({threads} threads, best of 3)", file=sys.stderr)
    return best


def structured_alignment(rng, n_seqs, n_sites, n_groups):
    """LD-structured synthetic input: ``n_groups`` triplets of correlated
    sites (a seed site plus two 2%-mutated copies — within-triplet r2 far
    above 0.1) scattered among otherwise-independent sites drawn from the
    criterion distribution.  Each triplet contributes ~3 surviving records
    at ``r2 > 0.1`` while cross-triplet/random pairs at N=1,000 essentially
    never pass (r2 ~ 1/N), so the scan yields ~``3 * n_groups`` records —
    the 'loaded rate' regime the zero-yield headline floor does not cover."""
    aln = synthetic_alignment(rng, n_seqs, n_sites)
    seeds = rng.choice(n_sites, size=(n_groups, 3), replace=False)
    for s0, s1, s2 in seeds:
        for dst in (s1, s2):
            col = aln[:, s0].copy()
            mut = rng.random(n_seqs) < 0.02
            col[mut] = np.where(col[mut] == 0, 3, 0)
            aln[:, dst] = col
    return aln


def _time_stream(session, n_pairs, scans_per_sample=3, samples=3):
    """Best-of-N timed stream() scans -> (pairs_per_s, records_per_scan)."""
    best = 0.0
    total = 0
    for _ in range(samples):
        t0 = time.monotonic()
        total = 0
        for _ in range(scans_per_sample):
            for _, rec in session.stream():
                total += len(rec)
        dt = time.monotonic() - t0
        best = max(best, scans_per_sample * n_pairs / dt)
    return best, total // scans_per_sample


def _heavy_alignment(n_seqs, n_sites, groups):
    """The adversarial output-volume input: ``groups`` 5-site correlated
    clusters (each ~10 surviving pairs at r2>0.1) on the criterion
    distribution — ~73k records/scan at the full shapes."""
    rng = np.random.default_rng(42)
    aln = synthetic_alignment(rng, n_seqs, n_sites)
    seeds = rng.choice(n_sites, size=(groups, 5), replace=False)
    for row in seeds:
        for dst in row[1:]:
            col = aln[:, row[0]].copy()
            mut = rng.random(n_seqs) < 0.02
            col[mut] = np.where(col[mut] == 0, 3, 0)
            aln[:, dst] = col
    return aln


# ---------------------------------------------------------------------------
# Interleaved multi-config measurement: every metric is sampled in the SAME
# rounds as a fixed PROBE (a summarize scan on the floor shape, N=1000 x
# S=49152) and reported as min/median/max across rounds plus the per-round
# probe ratio, which cancels drift common to one round.
# ---------------------------------------------------------------------------


def _stats(xs, digits=0):
    s = sorted(xs)
    n = len(s)
    med = s[n // 2] if n % 2 else 0.5 * (s[n // 2 - 1] + s[n // 2])
    f = (lambda v: round(v, digits)) if digits else (lambda v: round(v))
    return {"min": f(s[0]), "median": f(med), "max": f(s[-1]), "n": n}


def _summ_sample(session, n_pairs, scans):
    t0 = time.monotonic()
    for _ in range(scans):
        session.summarize()
    return scans * n_pairs / (time.monotonic() - t0)


def _stream_sample(session, n_pairs, scans, decimals=None):
    recs = 0
    t0 = time.monotonic()
    for _ in range(scans):
        recs = 0
        if decimals is None:
            for _, r in session.stream():
                recs += len(r)
        else:
            for _, r in session.stream(decimals=decimals):
                recs += len(r)
    return scans * n_pairs / (time.monotonic() - t0), recs


def bench_interleaved() -> dict:
    import jax.numpy as jnp

    from weightedld.core.henikoff import henikoff_weights
    from weightedld.runtime.driver import DriverConfig, LdSession

    full = require_gpu()
    n_sites = S_FULL if full else int(os.environ.get("WLD_BENCH_S", 1024))
    reps = int(os.environ.get("WLD_BENCH_REPS", 5 if full else 2))
    scans = 3 if full else 1

    def make(aln, **cfg_kw):
        w = np.asarray(henikoff_weights(jnp.asarray(aln)))
        return LdSession(
            aln, w, np.arange(aln.shape[1]),
            DriverConfig(r2_threshold=R2_THRESHOLD, **cfg_kw))

    # Floor: random criterion-distribution input, zero records at
    # r2>0.1.  Its summarize scan doubles as the fixed probe.
    rng = np.random.default_rng(42)
    floor_sess = make(
        synthetic_alignment(rng, N_SEQS, n_sites),
        tile=TILE, tiles_per_shard_batch=TILES_PER_BATCH if full else 4)
    # Loaded: LD-structured input, ~1e4 records/scan (3 sites/group).
    n_groups = 3400 if full else max(8, n_sites // 16)
    loaded_sess = make(
        structured_alignment(np.random.default_rng(7), N_SEQS, n_sites,
                             n_groups))
    # Heavy: the adversarial output-volume case (N=250, 5-site groups,
    # ~73k records/scan at the full shapes) — measured as a
    # stream/summarize ratio on its own session.
    hv_seqs = 250 if full else 100
    hv_groups = 6600 if full else max(8, n_sites // 20)
    heavy_sess = make(_heavy_alignment(hv_seqs, n_sites, hv_groups))

    n_pairs = n_sites * (n_sites - 1) // 2

    # Warm-up/compile every measured program before any timing.  TWO
    # stream passes each: the per-batch capacity memory learns from the
    # first scan and re-specializes the fused program, so the second
    # pass absorbs that recompile before the clock starts.
    floor_sess.summarize()
    loaded_sess.summarize()
    heavy_sess.summarize()
    for _ in range(2):
        for _ in floor_sess.stream():
            pass
        for _ in loaded_sess.stream():
            pass
        for _ in heavy_sess.stream(decimals=4):
            pass

    S = {k: [] for k in ("probe", "floor", "loaded", "ld_summ",
                         "hv_summ", "hv_stream")}
    floor_recs = loaded_recs = hv_recs = 0
    for rep in range(reps):
        S["probe"].append(_summ_sample(floor_sess, n_pairs, scans))
        r, floor_recs = _stream_sample(floor_sess, n_pairs, scans)
        S["floor"].append(r)
        # Loaded summarize IMMEDIATELY before the loaded stream: the
        # own-summarize ratio is context-free (same session, same input,
        # adjacent in time) where the probe ratio also carries
        # cross-session allocator effects.
        S["ld_summ"].append(_summ_sample(loaded_sess, n_pairs, scans))
        r, loaded_recs = _stream_sample(loaded_sess, n_pairs, scans)
        S["loaded"].append(r)
        S["hv_summ"].append(_summ_sample(heavy_sess, n_pairs, scans))
        r, hv_recs = _stream_sample(heavy_sess, n_pairs, scans, decimals=4)
        S["hv_stream"].append(r)
        print(f"[bench] round {rep + 1}/{reps}: "
              f"probe {S['probe'][-1]:.3g}  floor {S['floor'][-1]:.3g}  "
              f"loaded {S['loaded'][-1]:.3g} "
              f"({S['loaded'][-1] / S['ld_summ'][-1]:.3f}x own summ)  "
              f"heavy {S['hv_stream'][-1] / S['hv_summ'][-1]:.3f}x",
              file=sys.stderr)

    ratio = lambda k: [a / b for a, b in zip(S[k], S["probe"])]
    loaded_own = [st / su for st, su in zip(S["loaded"], S["ld_summ"])]
    heavy_ratio = [st / su for st, su in zip(S["hv_stream"], S["hv_summ"])]
    return {
        "full_shapes": full,
        "n_sites": n_sites,
        "probe": {
            "what": ("summarize scan, N=%d x S=%d — the floor shape; "
                     "probe_ratio = same-round rate / probe rate, the "
                     "drift-cancelling cross-round comparator"
                     % (N_SEQS, n_sites)),
            "pairs_per_s": _stats(S["probe"]),
        },
        "floor": {
            "pairs_per_s": _stats(S["floor"]),
            "probe_ratio": _stats(ratio("floor"), digits=3),
            "records_per_scan": floor_recs,
        },
        "loaded": {
            "pairs_per_s": _stats(S["loaded"]),
            "probe_ratio": _stats(ratio("loaded"), digits=3),
            "stream_vs_own_summarize": _stats(loaded_own, digits=3),
            "summarize_pairs_per_s": _stats(S["ld_summ"]),
            "records_per_scan": loaded_recs,
            "n_corr_groups": n_groups,
        },
        "heavy": {
            "stream_vs_summarize_ratio": _stats(heavy_ratio, digits=3),
            "stream_pairs_per_s": _stats(S["hv_stream"]),
            "summarize_pairs_per_s": _stats(S["hv_summ"]),
            "probe_ratio": _stats(ratio("hv_stream"), digits=3),
            "records_per_scan": hv_recs,
            "config": {"n_seqs": hv_seqs, "corr_groups": hv_groups,
                       "wire": "fixed4"},
        },
    }


# ---------------------------------------------------------------------------
# Pod scaling harness (bench.py --pod [N])
# ---------------------------------------------------------------------------


def bench_pod(n: int | None) -> int:
    """One-command 1->N shard scaling measurement over the visible devices.

    On N GPUs: wall-clock pairs/s at 1, 2, ..., N shards of the SAME fixed
    input and the scaling efficiency vs the 1-shard rate.

    Under ``JAX_PLATFORMS=cpu`` with fewer than N devices it relaunches
    itself on a virtual N-device CPU mesh
    (``--xla_force_host_platform_device_count``).  Virtual devices share
    the host cores, so wall-clock scaling is NOT a hardware measurement
    there; the per-row ``efficiency`` is then the exact static work
    balance of the striped plan (``pairs_per_shard``), labeled via
    ``efficiency_basis``.  On any other backend too few devices is an
    error."""
    import jax

    navail = jax.device_count()
    n = n or navail
    if navail < n:
        if not cpu_hooks():
            print(f"bench.py --pod {n}: only {navail} "
                  f"{jax.devices()[0].platform} device(s) visible",
                  file=sys.stderr)
            return 2
        env = dict(os.environ)
        flags = " ".join(
            f for f in env.get("XLA_FLAGS", "").split()
            if "xla_force_host_platform_device_count" not in f
        )
        env["XLA_FLAGS"] = (
            f"{flags} --xla_force_host_platform_device_count={n}".strip()
        )
        print(f"[pod] {navail} device(s) visible; relaunching on a "
              f"virtual {n}-device CPU mesh", file=sys.stderr)
        return subprocess.call(
            [sys.executable, __file__, "--pod", str(n)], env=env)
    return _bench_pod_run(n)


def _bench_pod_run(n: int) -> int:
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from weightedld.core.henikoff import henikoff_weights
    from weightedld.parallel.triangle import pairs_per_shard
    from weightedld.runtime.driver import DriverConfig, LdSession

    devices = jax.devices()[:n]
    full = require_gpu()
    virtual = not full
    n_seqs = N_SEQS if full else 200
    n_sites = S_FULL if full else 4096
    # Test hook: the CPU smoke test shrinks the problem so the harness
    # itself (relaunch, meshes, balance accounting, JSON shape) is
    # exercised in seconds.
    n_seqs = int(os.environ.get("WLD_POD_BENCH_N", n_seqs))
    n_sites = int(os.environ.get("WLD_POD_BENCH_S", n_sites))
    rng = np.random.default_rng(42)
    aln = synthetic_alignment(rng, n_seqs, n_sites)
    weights = np.asarray(henikoff_weights(jnp.asarray(aln)))
    n_pairs = n_sites * (n_sites - 1) // 2

    shard_counts = [1]
    while shard_counts[-1] * 2 <= n:
        shard_counts.append(shard_counts[-1] * 2)
    if shard_counts[-1] != n:
        shard_counts.append(n)

    rows = []
    base_rate = None
    for m in shard_counts:
        mesh = Mesh(np.asarray(devices[:m]), ("tiles",))
        session = LdSession(
            aln, weights, np.arange(n_sites),
            DriverConfig(r2_threshold=R2_THRESHOLD),
            mesh=mesh,
        )
        for _ in session.stream():  # warm-up/compile this mesh size
            pass
        rate, _recs = _time_stream(
            session, n_pairs, scans_per_sample=3 if full else 1,
            samples=3 if full else 2)
        if base_rate is None:
            base_rate = rate
        pps = pairs_per_shard(session.plan, m)
        assert int(pps.sum()) == session.plan.n_pairs
        balance = float(pps.mean() / pps.max())
        spread_pct = float((pps.max() - pps.min()) / pps.mean() * 100.0)
        scaling = rate / (m * base_rate)
        eff = balance if virtual else scaling
        rows.append({
            "shards": m,
            "pairs_per_s": round(rate),
            "efficiency": round(eff, 4),
            "scaling_efficiency": round(scaling, 4),
            "balance_efficiency": round(balance, 6),
            "pairs_spread_pct": round(spread_pct, 4),
            "pairs_per_shard": pps.tolist(),
            "tile": session.cfg.tile,
            "n_batches": session.n_batches,
        })
        print(f"[pod] shards={m:3d}: {rate:14,.0f} pairs/s  "
              f"efficiency={eff:.4f}  balance={balance:.6f}  "
              f"spread={spread_pct:.4f}%", file=sys.stderr)
    print(json.dumps({
        "metric": "pod_scaling_pairs_per_s",
        "n_devices": n,
        "device": device_record(devices),
        "virtual_mesh": virtual,
        "efficiency_basis": (
            "plan_balance (virtual devices share host cores; wall-clock "
            "scaling is not a hardware measurement here)" if virtual
            else "measured_wall_clock_vs_1_shard"),
        "config": {"n_seqs": n_seqs, "n_sites": n_sites,
                   "r2_threshold": R2_THRESHOLD},
        "rows": rows,
    }))
    return 0


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def bench_pod_worker() -> int:
    """One process of the ``--processes`` measurement: join the Gloo group
    (when a coordinator is configured), run the fixed summarize workload
    over the GLOBAL mesh, and let process 0 print the wall-clock rate."""
    from weightedld.parallel.multihost import initialize_distributed

    if os.environ.get("JAX_COORDINATOR_ADDRESS"):
        initialize_distributed()  # env-driven manual bring-up (Gloo group)
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from weightedld.core.henikoff import henikoff_weights
    from weightedld.runtime.driver import DriverConfig, LdSession

    n_seqs = int(os.environ.get("WLD_POD_BENCH_N", 200))
    n_sites = int(os.environ.get("WLD_POD_BENCH_S", 4096))
    reps = int(os.environ.get("WLD_POD_BENCH_REPS", 3))
    rng = np.random.default_rng(42)
    aln = synthetic_alignment(rng, n_seqs, n_sites)
    weights = np.asarray(henikoff_weights(jnp.asarray(aln)))
    mesh = Mesh(np.asarray(jax.devices()), ("tiles",))
    session = LdSession(aln, weights, np.arange(n_sites),
                        DriverConfig(r2_threshold=R2_THRESHOLD), mesh=mesh)
    session.summarize()  # warm-up/compile
    n_pairs = n_sites * (n_sites - 1) // 2
    best = 0.0
    for _ in range(reps):
        t0 = time.monotonic()
        for _ in range(3):
            session.summarize()
        best = max(best, 3 * n_pairs / (time.monotonic() - t0))
    if jax.process_index() == 0:
        print(json.dumps({
            "pairs_per_s": round(best),
            "n_devices": jax.device_count(),
            "n_processes": jax.process_count(),
            "device": device_record(),
        }))
    return 0


def _visible_gpus() -> int:
    """Cards nvidia-smi lists (0 without a driver) — counted without JAX,
    so the launching process never holds a card itself."""
    info = gpu_info()
    return info["n_visible"] if info else 0


def bench_pod_processes(n_devices: int, n_procs: int) -> int:
    """Measured (not by-construction) multi-PROCESS scaling overhead.

    Runs the SAME fixed workload over the same total device count twice —
    once as 1 process with ``n_devices`` local devices, once as
    ``n_procs`` real ``jax.distributed`` processes (localhost group,
    ``n_devices / n_procs`` devices each) — and reports the wall-clock
    rate ratio, which isolates cross-process collective cost and
    multi-driver dispatch skew.

    Never two processes on one card: on a GPU host each worker sees only
    its own cards (``CUDA_VISIBLE_DEVICES``), and a request for more
    cards than are visible is refused.  Under ``JAX_PLATFORMS=cpu`` the
    workers run virtual CPU devices (the runtime machinery only)."""
    if n_procs < 2:
        print("bench.py --processes: need at least 2 processes",
              file=sys.stderr)
        return 2
    if n_devices % n_procs:
        print(f"bench.py --processes: device count {n_devices} not "
              f"divisible by process count {n_procs}", file=sys.stderr)
        return 2
    on_cpu = cpu_hooks()
    if not on_cpu and _visible_gpus() < n_devices:
        print(f"bench.py --processes: {n_devices} cards requested, "
              f"{_visible_gpus()} visible — refusing to put two processes "
              "on one card", file=sys.stderr)
        return 2
    results = {}
    for procs in (1, n_procs):
        dev_per = n_devices // procs
        port = _free_port()
        ps = []
        for pid in range(procs):
            env = dict(os.environ)
            if on_cpu:
                flags = " ".join(
                    f for f in env.get("XLA_FLAGS", "").split()
                    if "xla_force_host_platform_device_count" not in f)
                env["XLA_FLAGS"] = (f"{flags} --xla_force_host_platform_"
                                    f"device_count={dev_per}").strip()
            else:
                env["CUDA_VISIBLE_DEVICES"] = ",".join(
                    str(pid * dev_per + i) for i in range(dev_per))
            for k in ("JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES",
                      "JAX_PROCESS_ID"):
                env.pop(k, None)
            if procs > 1:
                env.update({
                    "JAX_COORDINATOR_ADDRESS": f"localhost:{port}",
                    "JAX_NUM_PROCESSES": str(procs),
                    "JAX_PROCESS_ID": str(pid),
                })
            ps.append(subprocess.Popen(
                [sys.executable, "-u", __file__, "--pod-worker"],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True, env=env))
        outs = []
        for p in ps:
            try:
                outs.append(p.communicate(timeout=1200)[0])
            except subprocess.TimeoutExpired:
                for q in ps:
                    q.kill()
                raise
        for p, out in zip(ps, outs):
            if p.returncode != 0:
                print(f"[pod-proc] worker failed (rc={p.returncode}):\n"
                      + out[-3000:], file=sys.stderr)
                return 1
        payload_lines = [ln for out in outs for ln in out.splitlines()
                         if ln.startswith("{")]
        results[procs] = json.loads(payload_lines[-1])
        print(f"[pod-proc] {procs} process(es) x {dev_per} device(s): "
              f"{results[procs]['pairs_per_s']:,} pairs/s", file=sys.stderr)
    eff = results[n_procs]["pairs_per_s"] / results[1]["pairs_per_s"]
    print(json.dumps({
        "metric": "pod_process_scaling_pairs_per_s",
        "n_devices": n_devices,
        "n_processes": n_procs,
        "device": results[1]["device"],
        "rows": [
            {"processes": 1, **results[1]},
            {"processes": n_procs, **results[n_procs]},
        ],
        "process_efficiency": round(eff, 4),
        "efficiency_basis": (
            "measured wall-clock: N real jax.distributed processes vs 1 "
            "process over the SAME total device count — isolates "
            "cross-process collective + dispatch overhead"),
    }))
    return 0


def bench_heavy() -> int:
    """The heavy-output adversarial case with one command: N=250 x
    S=49,152 with 6,600 5-site correlated groups (~73k records/scan at
    r2>0.1), interleaved summarize vs stream (compressed wire),
    min-of-reps — prints one JSON line with the stream/summarize ratio.
    (The default ``bench.py`` run also measures this case, interleaved
    with the floor/loaded configs and the fixed probe.)"""
    import jax
    import jax.numpy as jnp

    from weightedld.core.henikoff import henikoff_weights
    from weightedld.runtime.driver import DriverConfig, LdSession

    full = require_gpu()
    n_seqs = 250
    n_sites = S_FULL if full else 2048
    groups = 6600 if full else 250
    aln = _heavy_alignment(n_seqs, n_sites, groups)
    w = np.asarray(henikoff_weights(jnp.asarray(aln)))
    n_pairs = n_sites * (n_sites - 1) // 2
    session = LdSession(aln, w, np.arange(n_sites),
                        DriverConfig(r2_threshold=R2_THRESHOLD))
    session.summarize()
    recs = 0
    for _, r in session.stream(decimals=4):
        recs += len(r)
    summ_t, stream_t = [], []
    reps = 5 if full else 2
    scans = 3 if full else 1
    for _ in range(reps):  # interleaved: drift cancels in the ratio
        t0 = time.monotonic()
        for _ in range(scans):
            session.summarize()
        summ_t.append((time.monotonic() - t0) / scans)
        t0 = time.monotonic()
        for _ in range(scans):
            for _ in session.stream(decimals=4):
                pass
        stream_t.append((time.monotonic() - t0) / scans)
    s_best, st_best = min(summ_t), min(stream_t)
    print(json.dumps({
        "metric": "heavy_output_stream_vs_summarize",
        "device": device_record(),
        "records_per_scan": recs,
        "summarize_pairs_per_s": round(n_pairs / s_best),
        "stream_pairs_per_s": round(n_pairs / st_best),
        "ratio": round(s_best / st_best, 3),
        "per_round_ratio": _stats(
            [su / st for su, st in zip(summ_t, stream_t)], digits=3),
        "config": {"n_seqs": n_seqs, "n_sites": n_sites,
                   "corr_groups": groups, "r2_threshold": R2_THRESHOLD,
                   "wire": "fixed4"},
    }))
    return 0


SWEEP_N = (10, 50, 100, 250, 500, 1000)


def bench_sweep() -> int:
    """Criterion-parity sequence-count sweep (reference
    ``benches/bench_weighted_pair_ld.rs:30-53``: n_seqs in {10..1000} on the
    60% major / 30% minor / 10% missing distribution).  The reference
    measures one pair-kernel call; the analog here is the full streaming
    session, reported as pairs/s and element-throughput (pairs/s * N, the
    criterion ``Throughput::Elements`` equivalent)."""
    import jax
    import jax.numpy as jnp

    from weightedld.core.henikoff import henikoff_weights
    from weightedld.runtime.driver import DriverConfig, LdSession

    full = require_gpu()
    # Floor S: a small S measures per-scan fixed costs, not the N-scaling.
    n_sites = S_FULL if full else 512
    n_pairs = n_sites * (n_sites - 1) // 2
    rows = []
    for n in SWEEP_N:
        rng = np.random.default_rng(42)
        aln = synthetic_alignment(rng, n, n_sites)
        weights = np.asarray(henikoff_weights(jnp.asarray(aln)))
        session = LdSession(
            aln, weights, np.arange(n_sites),
            DriverConfig(r2_threshold=R2_THRESHOLD),
        )
        session.summarize()  # warm-up/compile
        best = 0.0
        for _ in range(3):
            # Reduction-only scans (the criterion bench measures the pair
            # kernel, not record extraction — small-N noise floods any r2
            # threshold with records).  Loop >= ~0.5 s per sample to
            # amortize per-scan dispatch latency.
            t0 = time.monotonic()
            scans = 0
            while True:
                session.summarize()
                scans += 1
                dt = time.monotonic() - t0
                if dt >= 0.5:
                    break
            best = max(best, scans * n_pairs / dt)
        stats = _native_bench(n, min(n_sites, 2048))
        native = float(stats["pairs_per_s"]) if stats else None
        rows.append({"n_seqs": n, "pairs_per_s": round(best),
                     "elements_per_s": round(best * n),
                     "native_pairs_per_s": round(native) if native else None,
                     "vs_native": round(best / native, 2) if native else None})
        print(f"[sweep] N={n:5d}: {best:14,.0f} pairs/s"
              + (f"  (native {native:12,.0f}, {best / native:7.1f}x)"
                 if native else ""), file=sys.stderr)
    print(json.dumps({"metric": "weighted_ld_pairs_per_s_sweep",
                      "device": device_record(),
                      "n_sites": n_sites, "rows": rows}))
    return 0


def main() -> int:
    if "--sweep" in sys.argv:
        return bench_sweep()
    if "--heavy" in sys.argv:
        return bench_heavy()
    if "--pod-worker" in sys.argv:
        return bench_pod_worker()
    if "--pod" in sys.argv or "--processes" in sys.argv:
        def int_arg(flag, default):
            if flag not in sys.argv:
                return default
            idx = sys.argv.index(flag)
            arg = sys.argv[idx + 1] if idx + 1 < len(sys.argv) else None
            if arg is not None and arg.startswith("-"):
                arg = None  # another flag, not a count
            if arg is not None and not arg.isdigit():
                print(f"bench.py {flag}: expected a count, got {arg!r} "
                      "(usage: bench.py --pod [N] [--processes P])",
                      file=sys.stderr)
                raise SystemExit(2)
            return int(arg) if arg else default

        n = int_arg("--pod", None)
        if "--processes" in sys.argv:
            p = int_arg("--processes", 2)
            return bench_pod_processes(n or p, p)
        return bench_pod(n)
    res = bench_interleaved()
    cpu = bench_cpu_baseline()
    floor_best = res["floor"]["pairs_per_s"]["max"]
    result = {
        "metric": "weighted_ld_site_pairs_per_s_per_chip",
        "device": device_record(),
        # `value` is best-of-rounds on the zero-yield floor config; compare
        # across runs with the spread and probe_ratio blocks.
        "value": floor_best,
        "unit": "pairs/s",
        "vs_baseline": round(floor_best / cpu, 2) if cpu else None,
        # The headline input is random (criterion distribution): at
        # r2 > 0.1 essentially nothing passes, so `value` is the
        # ZERO-YIELD scan floor; `loaded` re-measures on an LD-structured
        # input with ~1e4 records/scan, `heavy` on the adversarial ~73k
        # records/scan case (all interleaved round-robin with the probe).
        "records_per_scan": res["floor"]["records_per_scan"],
        "probe": res["probe"],
        "floor": res["floor"],
        "loaded": res["loaded"],
        "heavy": res["heavy"],
        "config": {
            "n_seqs": N_SEQS,
            "n_sites": res["n_sites"],
            "r2_threshold": R2_THRESHOLD,
            "tile": TILE or "auto",
            "baseline": "native C++ -march=native -fopenmp (Rust-SIMD-equivalent)"
            if cpu else "unavailable",
            "cpu_baseline_pairs_per_s": round(cpu) if cpu else None,
            # The baseline runs at a smaller S (its per-pair cost is O(N),
            # S-independent) — recorded so the ratio is traceable.
            "cpu_baseline_n_sites": S_CPU if cpu else None,
        },
    }
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
