"""Multi-process execution support.

Design (SURVEY.md §2.3/§5): the site-pair triangle is the only scale-out
axis.  Inputs (alignment codes + weights — N x S_kept int8 + N f32) are
replicated to every device via a one-time broadcast; the striped tile plan
is global and deterministic, so every process computes its own disjoint
strip without coordination; per-batch outputs are compacted per device and
written by process 0 — communication is O(results), never O(pairs).

In a multi-process job each process sees only its local devices;
``jax.shard_map`` over the global mesh plus fully-replicated inputs gives
exactly the ownership layout above with XLA inserting the (single) initial
broadcast.  One process may equally drive every device of a host.
"""

from __future__ import annotations

import logging

import jax
import numpy as np
from jax.sharding import Mesh

log = logging.getLogger("weightedld")


def initialize_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> None:
    """Bring up the JAX distributed runtime (no-op for single-process runs).

    Call BEFORE any other jax use: probing the backend first (even
    ``jax.devices()``) would initialize it locally and make a later
    ``jax.distributed.initialize`` fail.  Under Slurm / Open MPI the
    arguments are auto-detected from the environment; pass them
    explicitly (or via ``JAX_COORDINATOR_ADDRESS`` +
    ``JAX_NUM_PROCESSES`` + ``JAX_PROCESS_ID``) for manual bring-up.
    """
    import os

    if coordinator_address is None and num_processes is None \
            and process_id is None:
        # Manual bring-up via environment: the three JAX_* variables name
        # the group explicitly (launchers without Slurm/MPI metadata,
        # e.g. a plain ssh fan-out, export these per process).
        env = os.environ
        if all(v in env for v in ("JAX_COORDINATOR_ADDRESS",
                                  "JAX_NUM_PROCESSES", "JAX_PROCESS_ID")):
            coordinator_address = env["JAX_COORDINATOR_ADDRESS"]
            num_processes = int(env["JAX_NUM_PROCESSES"])
            process_id = int(env["JAX_PROCESS_ID"])
    if (coordinator_address is not None or num_processes is not None
            or process_id is not None):
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    elif _multiprocess_env():
        # A cluster environment is clearly indicated: a failed
        # bring-up here must NOT silently degrade to N independent
        # "process 0"s all writing the same output — propagate it.
        jax.distributed.initialize()  # auto-detect from the environment
    else:
        log.info("no multi-process environment detected; running locally")
        return
    log.info(
        "distributed runtime up: process %d/%d, %d local / %d global devices",
        jax.process_index(), jax.process_count(),
        jax.local_device_count(), jax.device_count(),
    )


def _multiprocess_env() -> bool:
    """Heuristic: does the environment indicate a multi-process job?

    Explicit coordinator variables always count.  SLURM counts only when
    the allocation has multiple tasks AND this process has a task id (a
    user running N *independent* scans inside one allocation should not be
    fused into one accidental distributed group — pass explicit arguments
    for manual bring-up instead).
    """
    import os

    env = os.environ
    if any(v in env for v in (
        "JAX_COORDINATOR_ADDRESS", "COORDINATOR_ADDRESS",
    )):
        return True
    try:
        # SLURM_STEP_NUM_TASKS, not SLURM_NTASKS: an `sbatch --ntasks=N`
        # batch step exports SLURM_NTASKS=N and SLURM_PROCID=0 even when
        # the script runs this program ONCE without srun — initializing
        # there would block forever waiting for N-1 peers that were never
        # launched.  Only an srun-launched step has a multi-task step.
        return (int(env.get("SLURM_STEP_NUM_TASKS", "1")) > 1
                and "SLURM_PROCID" in env)
    except ValueError:
        return False


def global_mesh(axis_name: str = "tiles") -> Mesh:
    """1-D mesh over every device in the job (all processes)."""
    return Mesh(np.asarray(jax.devices()), (axis_name,))


def is_output_process() -> bool:
    """Only process 0 writes records/TSV; other processes drive their
    devices.

    Backend-free when the distributed runtime is down (every
    single-process run is its own output process) — so the CLI's fast
    pre-analysis paths never pay a backend bring-up just to learn they
    may print.
    """
    if not jax.distributed.is_initialized():
        return True
    return jax.process_index() == 0
