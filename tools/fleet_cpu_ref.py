"""The CPU reference for `chip_smoke.py`'s fleet phase.

Runs the same program as that phase (`chip_smoke.fleet_rollout_on`: the
committed 128-scene planner fleet, `perf_mpc_params()`, 20 closed-loop
ticks, float32) on the CPU backend, in chunks of 16 scenes, and prints
its diagnostics as one JSON line. One run after compilation is timed.

Usage: JAX_PLATFORMS=cpu python tools/fleet_cpu_ref.py
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

import chip_smoke  # noqa: E402


def main():
    cfg, fleet = chip_smoke.load_fleet()
    device = jax.devices("cpu")[0]
    _, _, diag, _ = chip_smoke.fleet_rollout_on(device, cfg, fleet, chunk=16,
                                                reps=0)
    print(json.dumps({"platform": device.platform, "cpu_count": os.cpu_count(),
                      "chunk": 16, "ticks": chip_smoke.FLEET_TICKS, **diag}))


if __name__ == "__main__":
    main()
