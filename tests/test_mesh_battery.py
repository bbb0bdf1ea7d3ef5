"""CPU twin of the multi-device dry run: the full sharded-runner battery
(both engine forms, windowed plans, every analytics runner, streamed
site-major ingest) on the suite's 8-virtual-device CPU mesh — SURVEY §4's
multi-device mandate."""

import sys
from pathlib import Path

import jax
import numpy as np
from jax.sharding import Mesh

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def test_mesh_battery_8_devices():
    from __graft_entry__ import mesh_battery

    devices = np.asarray(jax.devices()[:8])
    assert devices.size == 8, "conftest should provision 8 virtual devices"
    mesh_battery(Mesh(devices, ("tiles",)))
