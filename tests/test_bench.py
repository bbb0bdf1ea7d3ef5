"""Smoke coverage for the benchmark harness itself — its relaunch / mesh /
balance-accounting / JSON plumbing and its refusal to report a CPU run as
a device measurement, exercised through the ``JAX_PLATFORMS=cpu`` test
hooks."""

import json
import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]


def test_bench_pod_virtual_mesh_smoke():
    env = dict(os.environ)
    env.update({
        "JAX_PLATFORMS": "cpu",
        # Parent sees 1 CPU device -> exercises the virtual-mesh relaunch.
        "XLA_FLAGS": "--xla_force_host_platform_device_count=1",
        "WLD_POD_BENCH_N": "24",
        "WLD_POD_BENCH_S": "2048",  # 10 tiles at the auto T=512
    })
    for k in ("JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES",
              "JAX_PROCESS_ID"):
        env.pop(k, None)
    res = subprocess.run(
        [sys.executable, "-u", str(REPO / "bench.py"), "--pod", "2"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env, timeout=300,
    )
    assert res.returncode == 0, res.stdout[-3000:]
    payload = json.loads(res.stdout.strip().splitlines()[-1])
    assert payload["metric"] == "pod_scaling_pairs_per_s"
    assert payload["n_devices"] == 2 and payload["virtual_mesh"] is True
    assert payload["device"]["platform"] == "cpu"
    assert payload["device"]["count"] == 2
    rows = payload["rows"]
    assert [r["shards"] for r in rows] == [1, 2]
    for r in rows:
        assert r["pairs_per_s"] > 0
        assert 0.9 <= r["balance_efficiency"] <= 1.0
        assert r["pairs_spread_pct"] < 10.0


def test_bench_default_interleaved_smoke():
    """The default bench must emit the round-5 comparable JSON: floor /
    loaded / heavy blocks each carrying a min/median/max spread and a
    same-round probe ratio (the chip-phase-cancelling comparator)."""
    env = dict(os.environ)
    env.update({
        "JAX_PLATFORMS": "cpu",
        "WLD_BENCH_S": "256",
        "WLD_BENCH_REPS": "2",
    })
    res = subprocess.run(
        [sys.executable, "-u", str(REPO / "bench.py")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env, timeout=540,
    )
    assert res.returncode == 0, res.stdout[-3000:]
    payload = json.loads(res.stdout.strip().splitlines()[-1])
    assert payload["metric"] == "weighted_ld_site_pairs_per_s_per_chip"
    assert payload["device"]["platform"] == "cpu"
    assert set(payload["device"]) == {"platform", "kind", "count",
                                      "nvidia_smi"}
    assert payload["value"] > 0
    assert payload["value"] == payload["floor"]["pairs_per_s"]["max"]
    for block in ("floor", "loaded", "heavy"):
        spread_key = ("pairs_per_s" if block != "heavy"
                      else "stream_pairs_per_s")
        for key in (spread_key, "probe_ratio"):
            st = payload[block][key]
            assert st["min"] <= st["median"] <= st["max"], (block, key)
            assert st["n"] == 2
    assert payload["loaded"]["records_per_scan"] > 0
    own = payload["loaded"]["stream_vs_own_summarize"]
    assert own["min"] <= own["median"] <= own["max"] and own["n"] == 2
    assert payload["heavy"]["records_per_scan"] > 0
    assert payload["heavy"]["stream_vs_summarize_ratio"]["median"] > 0
    assert payload["probe"]["pairs_per_s"]["min"] > 0


def test_bench_pod_rejects_non_numeric_argument():
    env = dict(os.environ)
    env.update({"JAX_PLATFORMS": "cpu"})
    res = subprocess.run(
        [sys.executable, str(REPO / "bench.py"), "--pod", "all"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env, timeout=120,
    )
    assert res.returncode == 2
    assert "expected a count" in res.stdout


def test_bench_pod_processes_smoke():
    """--processes launches a real 2-process Gloo group and reports a
    measured (not by-construction) 1-vs-2-process efficiency over the
    same total device count."""
    env = dict(os.environ)
    env.update({
        "JAX_PLATFORMS": "cpu",
        "WLD_POD_BENCH_N": "24",
        "WLD_POD_BENCH_S": "2048",  # 10 tiles at the auto T=512
        "WLD_POD_BENCH_REPS": "1",
    })
    for k in ("JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES",
              "JAX_PROCESS_ID"):
        env.pop(k, None)
    res = subprocess.run(
        [sys.executable, "-u", str(REPO / "bench.py"),
         "--pod", "2", "--processes", "2"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env, timeout=600,
    )
    assert res.returncode == 0, res.stdout[-3000:]
    payload = json.loads(res.stdout.strip().splitlines()[-1])
    assert payload["metric"] == "pod_process_scaling_pairs_per_s"
    rows = payload["rows"]
    assert [r["processes"] for r in rows] == [1, 2]
    assert rows[0]["n_devices"] == rows[1]["n_devices"] == 2
    assert rows[1]["n_processes"] == 2
    assert payload["process_efficiency"] > 0
    assert "measured wall-clock" in payload["efficiency_basis"]
    assert payload["device"]["platform"] == "cpu"


def test_bench_refuses_without_gpu():
    """Outside the CPU test hooks a host without a GPU gets no number: the
    bench exits 2 instead of reporting a CPU run under a device metric,
    and --pod does not fall back to a virtual mesh."""
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=1"
    for argv in ([], ["--pod", "2"], ["--heavy"]):
        res = subprocess.run(
            [sys.executable, str(REPO / "bench.py"), *argv],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=env, timeout=300,
        )
        assert res.returncode == 2, (argv, res.stdout[-2000:])
        assert not res.stdout.strip().endswith("}"), argv
