"""scripts/torch_scaling_bench.py on the CPU, against the JAX script's
payload (scripts/scaling_bench.py, its committed output scaling_cpu.json
read as data) and against what parallel/sharding.py issues.

- ``--mode both`` at 62 rollouts x 4 steps (31 per shard), n in {1, 2}:
  the weak rows (n = 2 as 2 gloo ranks on a 1-D mesh) and the overhead rows
  (the one-process twin) carry the JAX script's keys and rows, finite
  positive rates, the efficiencies as the JAX script computes them, and no
  kernel launch (the plain versions run on the CPU);
- ``--mode collectives`` on 2 gloo ranks (the rank spawning of
  tests/test_torch_sharding.py): per update on the 1-D mesh one cost
  all-gather ((R, 2) float32), one all-gather of the partial sums ((S,
  dof) per rank) and one broadcast of rollout 0's states ((S, 24)), with
  their bytes; on the 2 x 1 scenario mesh, the scenario-cost all-gather
  besides;
- ``counted_collectives`` counts a call's bytes, leaves its result and
  restores the calls after its block.
"""

import json
import os
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import scripts.torch_scaling_bench as bench  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401  (a module fixture)

SMALL = ["--device", "cpu", "--rollouts-per-device", "31", "--steps", "4", "--sizes", "1,2"]
STEPS, DOF, STATE = 4, 12, 24


def jax_payload():
    with open(os.path.join(ROOT, "scaling_cpu.json")) as handle:
        return json.load(handle)


def test_both_modes_payload(tmp_path):
    out = tmp_path / "both.json"
    assert bench.main(SMALL + ["--mode", "both", "--iters", "2", "--repeats", "1", "--out", str(out)]) == 0
    payload = json.loads(out.read_text())
    want = jax_payload()
    assert {"platform", "backend", "weak", "weak_caveat", "overhead"} <= set(payload)
    assert {"device", "power_limit"} <= set(payload) and payload["device"] == "cpu"
    for mode in ("weak", "overhead"):
        rows = payload[mode]
        assert [row["devices"] for row in rows] == [1, 2]
        assert set(want[mode][0]) <= set(rows[0]), mode
        assert all(row["solves_per_s"] > 0 for row in rows)
    weak, overhead = payload["weak"], payload["overhead"]
    assert [row["rollouts"] for row in weak] == [31, 62]
    assert [row["rollouts"] for row in overhead] == [62, 62]
    assert weak[1]["weak_scaling_efficiency"] == round(weak[1]["solves_per_s"] / weak[0]["solves_per_s"], 3)
    assert overhead[1]["sharding_efficiency_same_work"] == round(
        overhead[1]["solves_per_s"] / overhead[0]["solves_per_s"], 3)
    assert [row["kernel1_launches_per_update"] for row in overhead] == [0, 0]
    assert "one cpu device" in payload["weak_caveat"]


def test_collectives_per_update(tmp_path):
    out = tmp_path / "collectives.json"
    assert bench.main(SMALL + ["--mode", "collectives", "--out", str(out)]) == 0
    payload = json.loads(out.read_text())
    assert set(jax_payload()["collectives_fused"][0]) <= set(payload["collectives_fused"][0])
    one_d, two_d = payload["collectives_fused"]
    R = 62
    assert one_d["mesh"] == "1d_rollouts" and one_d["devices"] == 2 and one_d["rollouts"] == R
    # The cost all-gather (every rank's (R / 2, 2) block), the states
    # broadcast, the partial sums' all-gather, in the order the update
    # issues them.
    assert one_d["calls"] == [["all-gather", R * 2 * 4], ["broadcast", STEPS * STATE * 4],
                              ["all-gather", 2 * STEPS * DOF * 4]]
    assert one_d["collectives"] == {"ops": {"all-gather": 2, "broadcast": 1},
                                    "payload_bytes": R * 8 + STEPS * STATE * 4 + 2 * STEPS * DOF * 4}
    # The 2 x 1 scenario mesh: each rank scores its scenario, the
    # scenario costs gathered over the scenario axis first.
    assert two_d["mesh"] == "2d_scenarios_x_rollouts" and two_d["scenarios"] == 2
    assert [op for op, _ in two_d["calls"]] == ["all-gather", "all-gather", "broadcast", "all-gather"]
    assert two_d["calls"][0][1] == 2 * R * 2 * 4


def test_counted_collectives_counts_bytes_keeps_results_and_restores(monkeypatch):
    import torch.distributed as dist

    seen = []
    monkeypatch.setattr(dist, "all_gather", lambda parts, tensor, group=None: seen.append(tensor) or "done")
    monkeypatch.setattr(dist, "broadcast", lambda tensor, src, group=None: "sent")
    fakes = {name: getattr(dist, name) for name in bench.COLLECTIVES}
    with bench.counted_collectives() as calls:
        parts = [torch.zeros(3, 2), torch.zeros(3, 2)]
        assert dist.all_gather(parts, torch.ones(3, 2)) == "done" and len(seen) == 1
        assert dist.broadcast(torch.zeros(5, dtype=torch.float64), src=0) == "sent"
    assert calls == [("all-gather", 48), ("broadcast", 40)]
    assert all(getattr(dist, name) is fn for name, fn in fakes.items())


@pytest.mark.parametrize("mode", ["overhead", "collectives"])
def test_cuda_is_asked_by_default(monkeypatch, mode):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bench.main(["--mode", mode])
