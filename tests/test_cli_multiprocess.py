"""Multi-process CLI integration: the pod entry point IS the CLI.

The reference is a CLI binary (``main.rs:121-213``); a pod user runs the
SAME ``weightedld`` command line on every host and gets exactly one
output file.  These tests launch the real CLI in 2 Gloo processes
(2 virtual CPU devices each) via the ``JAX_COORDINATOR_ADDRESS`` /
``JAX_NUM_PROCESSES`` / ``JAX_PROCESS_ID`` manual bring-up and byte-compare
the TSV against a single-process run on the same global device count, plus
a kill-mid-triangle checkpoint/resume of a 2-process ``run_to_tsv``.
"""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parents[1]

# The CLI entry wrapper: optional crash injection (WLD_FAULT_AFTER_BATCHES
# hard-exits the process after N streamed batches — a mid-triangle kill with
# no cleanup, the honest restart scenario for checkpoint/resume).
_ENTRY = """
import os, sys
sys.path.insert(0, {repo!r})
fault = int(os.environ.get("WLD_FAULT_AFTER_BATCHES", "0"))
if fault:
    from weightedld.runtime import driver as _drv
    _orig = _drv.LdSession.stream
    def _stream(self, *a, **k):
        n = 0
        for item in _orig(self, *a, **k):
            yield item
            n += 1
            if n >= fault:
                os._exit(17)
    _drv.LdSession.stream = _stream
from weightedld.cli import main
sys.exit(main(sys.argv[1:]))
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _write_fasta(path: Path, n_seqs=24, n_sites=120, seed=7) -> None:
    rng = np.random.default_rng(seed)
    # Skewed symbol mix: most sites pass the masks, some don't.
    rows = rng.choice(list("AACCGTT-"), size=(n_seqs, n_sites),
                      p=[0.4, 0.15, 0.1, 0.1, 0.1, 0.05, 0.05, 0.05])
    with open(path, "w") as fh:
        for i, row in enumerate(rows):
            fh.write(f">s{i}\n{''.join(row)}\n")


def _base_env(n_devices: int) -> dict:
    env = dict(os.environ)
    env.update({
        "JAX_PLATFORMS": "cpu",
        "XLA_FLAGS": f"--xla_force_host_platform_device_count={n_devices}",
    })
    # The parent's env must not leak a coordinator into local runs.
    for k in ("JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES",
              "JAX_PROCESS_ID", "WLD_FAULT_AFTER_BATCHES"):
        env.pop(k, None)
    return env


def _run_cli_distributed(entry, cli_args, n_procs=2, dev_per_proc=2,
                         fault_batches=0, expect_rc=(0,), timeout=300):
    """Launch the CLI once per process over a localhost Gloo group."""
    port = _free_port()
    procs = []
    for pid in range(n_procs):
        env = _base_env(dev_per_proc)
        env.update({
            "JAX_COORDINATOR_ADDRESS": f"localhost:{port}",
            "JAX_NUM_PROCESSES": str(n_procs),
            "JAX_PROCESS_ID": str(pid),
        })
        if fault_batches:
            env["WLD_FAULT_AFTER_BATCHES"] = str(fault_batches)
        procs.append(subprocess.Popen(
            [sys.executable, "-u", str(entry), *cli_args],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=env,
        ))
    outs = []
    for pr in procs:
        try:
            out, _ = pr.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append(out)
    for pr, out in zip(procs, outs):
        assert pr.returncode in expect_rc, (pr.returncode, out[-3000:])
    return [pr.returncode for pr in procs], outs


def _run_cli_single(entry, cli_args, n_devices=4, timeout=300):
    res = subprocess.run(
        [sys.executable, "-u", str(entry), *cli_args],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=_base_env(n_devices), timeout=timeout,
    )
    assert res.returncode == 0, res.stdout[-3000:]
    return res.stdout


@pytest.fixture(scope="module")
def cli_env(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("cli_mp")
    entry = tmp / "entry.py"
    entry.write_text(_ENTRY.format(repo=str(REPO)))
    fasta = tmp / "input.fasta"
    _write_fasta(fasta)
    return tmp, entry, fasta


FLAGS = ["--engine", "tiled", "--tile", "16", "--tiles-per-batch", "2"]


def test_cli_two_process_tsv_byte_equals_single(cli_env):
    tmp, entry, fasta = cli_env
    dist_tsv = tmp / "dist.tsv"
    dist_w = tmp / "dist.weights.tsv"
    # Every process gets the IDENTICAL command line (the srun contract) —
    # including the output paths; only process 0 may touch them.
    _run_cli_distributed(entry, [
        "--file", str(fasta), "--pair-output", str(dist_tsv),
        "--weights-output", str(dist_w), *FLAGS,
    ])

    single_tsv = tmp / "single.tsv"
    single_w = tmp / "single.weights.tsv"
    # Same GLOBAL device count (2 procs x 2 devs = 4) -> same tile striping
    # and batch order -> byte-identical streamed TSV.
    _run_cli_single(entry, [
        "--file", str(fasta), "--pair-output", str(single_tsv),
        "--weights-output", str(single_w), *FLAGS,
    ], n_devices=4)

    assert dist_tsv.read_bytes() == single_tsv.read_bytes()
    assert dist_w.read_bytes() == single_w.read_bytes()
    assert len(dist_tsv.read_text().splitlines()) > 3  # non-trivial run


def test_cli_two_process_stats_only_prints_once(cli_env):
    tmp, entry, fasta = cli_env
    rcs, outs = _run_cli_distributed(entry, [
        "--file", str(fasta), "--stats-only", *FLAGS,
    ])
    payloads = []
    for out in outs:
        for line in out.splitlines():
            if line.startswith("{"):
                payloads.append(json.loads(line))
    # Exactly ONE process printed the summary.
    assert len(payloads) == 1
    single = _run_cli_single(entry, [
        "--file", str(fasta), "--stats-only", *FLAGS], n_devices=4)
    want = json.loads([ln for ln in single.splitlines()
                       if ln.startswith("{")][0])
    for key in ("n_pairs", "n_over_threshold", "n_sites", "n_sequences"):
        assert payloads[0][key] == want[key]


@pytest.mark.parametrize("suffix", ["", ".gz"])
def test_cli_two_process_checkpoint_kill_resume(cli_env, suffix):
    """Kill-mid-triangle resume, plain TSV and gzip: the .gz variant
    exercises the per-segment gzip-member output (GzipMemberWriter) —
    resume truncates at a member boundary and the final file byte-equals
    an uninterrupted checkpointed run."""
    tmp, entry, fasta = cli_env
    out_tsv = tmp / ("ckpt.tsv" + suffix)
    ckpt = Path(str(out_tsv) + ".ckpt.json")

    # Interrupted run: both processes hard-exit after 2 streamed batches
    # (os._exit — no cleanup, like a pod preemption).
    _run_cli_distributed(entry, [
        "--file", str(fasta), "--pair-output", str(out_tsv),
        "--checkpoint", *FLAGS,
    ], fault_batches=2, expect_rc=(17,))
    assert ckpt.exists(), "no checkpoint written before the kill"
    state = json.loads(ckpt.read_text())
    assert state["next_batch"] >= 1
    torn = out_tsv.read_bytes()

    # Resume: the same command line, no fault.
    _, outs = _run_cli_distributed(entry, [
        "--file", str(fasta), "--pair-output", str(out_tsv),
        "--checkpoint", "-v", *FLAGS,
    ])
    assert not ckpt.exists()  # completed runs clear their checkpoint
    assert any("resuming at batch" in o for o in outs)
    # The resumed prefix really was reused, not rewritten from scratch.
    assert out_tsv.read_bytes()[: state["byte_offset"]] == \
        torn[: state["byte_offset"]]

    # Ground truth: an uninterrupted 2-process run into a fresh file.
    clean_tsv = tmp / ("clean.tsv" + suffix)
    _run_cli_distributed(entry, [
        "--file", str(fasta), "--pair-output", str(clean_tsv),
        "--checkpoint", *FLAGS,
    ])
    assert out_tsv.read_bytes() == clean_tsv.read_bytes()


def test_cli_verbose_stage_report(cli_env):
    tmp, entry, fasta = cli_env
    out = _run_cli_single(entry, [
        "--file", str(fasta), "--pair-output", str(tmp / "stages.tsv"),
        "-v", *FLAGS,
    ], n_devices=4)
    # Per-run wall-clock spans for every stage, like the Rust binary
    # (main.rs:128-210), plus the final report table.
    for stage in ("ingest", "mask", "weights", "upload", "scan+write"):
        assert f"stage {stage}" in out, stage
    assert "stage report:" in out
