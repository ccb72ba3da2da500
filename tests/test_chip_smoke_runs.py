"""chip_smoke.py's user-entry phases at tiny sizes on the CPU: the episodic
loop, the fleet batch runner, serving, and the four-device sharded fleet
(here on four of the virtual CPU devices)."""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402

_TINY = dict(n_steps=3, n_init_samples=12, hyp_iters=2, n_max=32)


def test_phase_episodic_tiny():
    chip_smoke.phase_episodic(n_ep=2, **_TINY)


def test_phase_fleet_tiny():
    chip_smoke.phase_fleet(batch_lanes=8, **_TINY)


def test_phase_serve_tiny():
    chip_smoke.phase_serve(n_steps=3, n_init_samples=12, hyp_iters=2, n_max=32)


def test_phase_sharded_fleet_tiny():
    chip_smoke.phase_sharded_fleet(n_dev=4, batch_lanes=8, **_TINY)
