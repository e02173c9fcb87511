"""Multi-host (DCN) tier test: 2 real processes x 4 virtual CPU devices
must reproduce the single-process 8-device fleet bit-for-bit (same scenes,
same config, same tick count).

This exercises the full `parallel.distributed` surface: the launcher, the
`jax.distributed` runtime join, the global scenario mesh spanning both
processes, per-process shard feeding (`global_from_local`), the DCN-riding
diagnostic reductions, and local shard extraction.
"""

import json
import sys
from pathlib import Path

import numpy as np
import pytest

import jax

from boundplanner_tpu.demo import demo_fleet
from boundplanner_tpu.parallel import distributed as dist
from boundplanner_tpu.parallel.batch import closed_loop_rollout

WORKER = Path(__file__).with_name("distributed_worker.py")


def _single_process_reference():
    from tests.distributed_worker import CFG, GLOBAL_BATCH, N_TICKS

    carry_b, obs_b, q0_b = demo_fleet(CFG, GLOBAL_BATCH, dtype=np.float64)
    to_dev = lambda x: jax.numpy.asarray(x)
    final, recs = jax.vmap(
        lambda c, q, o: closed_loop_rollout(c, q, o, CFG, N_TICKS)
    )(
        jax.tree.map(to_dev, carry_b),
        to_dev(q0_b.astype(np.float64)),
        jax.tree.map(to_dev, obs_b),
    )
    return np.asarray(recs["phi"][:, -1]), np.asarray(recs["q"][:, -1]), recs


def test_two_process_fleet_matches_single_process():
    results = dist.launch(
        [sys.executable, str(WORKER)],
        nproc=2,
        env_extra={
            "JAX_PLATFORMS": "cpu",
            "XLA_FLAGS": "--xla_force_host_platform_device_count=4",
        },
        timeout=900,
    )
    workers = []
    for rc, out in results:
        assert rc == 0
        line = [l for l in out.splitlines() if l.startswith("WORKER_RESULT ")]
        assert line, out
        workers.append(json.loads(line[0][len("WORKER_RESULT "):]))
    workers.sort(key=lambda w: w["pid"])

    # shard layout: process p owns scenes [4p, 4p+4)
    assert [w["lo"] for w in workers] == [0, 4]

    # global diagnostics are replicated identically on both processes
    assert workers[0]["diag"] == workers[1]["diag"]

    phi_ref, q_ref, recs = _single_process_reference()
    phi_dist = np.concatenate([np.asarray(w["phi"]) for w in workers])
    q_dist = np.concatenate(
        [np.asarray(w["q"]).reshape(4, 7) for w in workers]
    )

    # scenes are distinct by construction — a wrong shard order would show
    assert np.std(phi_ref) > 1e-5
    np.testing.assert_allclose(phi_dist, phi_ref, rtol=0, atol=1e-9)
    np.testing.assert_allclose(q_dist, q_ref, rtol=0, atol=1e-9)

    # cross-process reductions match host-side reference reductions
    diag = workers[0]["diag"]
    np.testing.assert_allclose(
        diag["success_rate"],
        np.mean(np.asarray(recs["success"], np.float32)),
        atol=1e-6,
    )
    np.testing.assert_allclose(
        diag["mean_phi_final"], np.mean(phi_ref), atol=1e-9
    )


def test_local_batch_slice_single_process():
    # in-process (process_count == 1) the slice must cover everything
    assert dist.local_batch_slice(8) == slice(0, 8)


def test_global_from_local_roundtrip():
    mesh = dist.global_scenario_mesh()
    tree = {"a": np.arange(16, dtype=np.float32).reshape(8, 2),
            "b": np.arange(8, dtype=np.float32)}
    g = dist.global_from_local(tree, mesh, 8)
    back = dist.local_from_global(g)
    np.testing.assert_array_equal(back["a"], tree["a"])
    np.testing.assert_array_equal(back["b"], tree["b"])


@pytest.mark.parametrize("visible, want", [
    (None, ["0", "1"]),
    ("3,5", ["3", "5"]),
])
def test_launch_gives_each_child_one_card(monkeypatch, visible, want):
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    extra = {} if visible is None else {"CUDA_VISIBLE_DEVICES": visible}
    cmd = [sys.executable, "-c",
           "import os; print(os.environ['CUDA_VISIBLE_DEVICES'])"]
    outs = dist.launch(cmd, 2, env_extra=extra, timeout=60)
    assert [out.strip() for _, out in outs] == want


def test_launch_refuses_more_processes_than_cards():
    with pytest.raises(ValueError, match="visible"):
        dist.launch([sys.executable, "-c", "pass"], 3,
                    env_extra={"CUDA_VISIBLE_DEVICES": "0,1"})
