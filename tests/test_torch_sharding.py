"""Rollout sharding (assistedmanipulation_tpu_torch/parallel/sharding.py) and
``build_flagship(mesh=..., sampler_shards=...)``, on the CPU.

(a) Against the JAX package: tests/test_torch_sharding_jax.py.
(b) Two gloo ranks on the CPU (scripts/torch_multihost_check.py, a
    ``file://`` rendezvous in tmp_path): the 1-D mesh flagship, fused,
    ``backend="vmap"`` and in resimulate mode, bitwise equal to the
    ``sampler_shards=2`` twin (noise, costs, weights, gradient, optimal
    control, states); the 2 x 1 scenario mesh with 2 scenarios, with
    ``safety=True`` and on ``backend="vmap"``: noise bitwise, the rest
    within the script's SCENARIO_TOLERANCE (1e-4 of max(|twin|, 1); it has
    been bitwise here). The script also checks ``shard_rollout_fn``
    on a costs-only rollout_fn, a paired one and scenario weights, and
    ``make_scenario_mesh``'s ValueError.
(c) Placement invariance: the shard seed words, the block a rank runs on a
    2-D mesh, the per-shard in-kernel draws and static rows.
(d) ``build_flagship``'s ValueErrors, on a stand-in mesh (they raise before
    any collective).
(e) ``interop.lane_noise_to_logical`` with shards.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from assistedmanipulation_tpu_torch import interop
from assistedmanipulation_tpu_torch.kernels.cuda_rollout import noise_from_logical, noise_to_logical
from assistedmanipulation_tpu_torch.kernels.philox import normal_draws, shard_seed, split_key
from assistedmanipulation_tpu_torch.models import frankaridgeback as fr
from assistedmanipulation_tpu_torch.parallel import sharding
from assistedmanipulation_tpu_torch.parallel.flagship import build_flagship
from torch_threads import one_torch_thread  # noqa: E402,F401  (a module fixture)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_two_ranks_match_the_single_process_twin(tmp_path):
    out = tmp_path / "result.json"
    proc = subprocess.run(
        [sys.executable, os.path.join(ROOT, "scripts", "torch_multihost_check.py"), "--device", "cpu",
         "--rollouts", "62", "--steps", "4", "--updates", "3", "--scenarios", "2",
         "--cases", "fused,vmap,resimulate,scenario-safety,scenario-vmap", "--store", str(tmp_path), "--timeout", "120",
         "--out", str(out)],
        capture_output=True, text=True, timeout=180, cwd=str(tmp_path),
    )
    assert proc.returncode == 0, (proc.stdout + proc.stderr)[-3000:]
    result = json.loads(out.read_text())
    assert result["ok"] and result["processes"] == 2
    assert result["shard_rollout_fn"] == {"costs_only": True, "paired": True, "scenario_weights": True}
    for case in ("fused", "vmap", "resimulate"):
        report = result["cases"][case]
        assert report["bitwise"] and report["noise_bitwise"], report
        assert report["held_noise_shape"] == [4, 12, 32]  # each rank holds its block
    for case in ("scenario-safety", "scenario-vmap"):
        scenario = result["cases"][case]
        assert scenario["noise_bitwise"] and scenario["ok"], scenario
        assert scenario["ctx_scenarios"] == 1  # each rank scores its half of the ensemble
        assert scenario["held_noise_shape"] == [4, 12, 64]  # one rollout shard: the whole batch


def test_shard_seed_words():
    seed = split_key(torch.tensor([7, 11], dtype=torch.int64))[1]
    assert torch.equal(shard_seed(seed, 0), seed)  # one shard: the update's words
    words = [tuple(shard_seed(seed, i).tolist()) for i in range(8)]
    assert len(set(words)) == 8
    assert shard_seed(seed, 3).dtype == torch.int32
    assert torch.equal(shard_seed(seed, 3), shard_seed(seed.clone(), 3))


class _Mesh:
    """A stand-in DeviceMesh: axis names, sizes and this rank's coordinates."""

    def __init__(self, names, shape, coordinates=None):
        self.mesh_dim_names, self.shape = tuple(names), tuple(shape)
        self._coordinates = coordinates or (0,) * len(shape)

    def size(self, dim):
        return self.shape[dim]

    def get_local_rank(self, name):
        return self._coordinates[self.mesh_dim_names.index(name)]

    def get_group(self, name):
        return name


def test_ranks_of_one_rollout_block_draw_the_same_words():
    """On a 2 x 2 (scenarios, rollouts) mesh the rank at (s, r) runs rollout
    shard r whatever s: its block and its seed words follow r alone."""
    seed = split_key(torch.tensor([0, 5], dtype=torch.int64))[1]
    names = (sharding.SCENARIO_AXIS, sharding.ROLLOUT_AXIS)
    local = {
        (s, r): sharding.RolloutShards(8, mesh=_Mesh(names, (2, 2), (s, r))).local for s in (0, 1) for r in (0, 1)
    }
    assert local == {(0, 0): (0,), (1, 0): (0,), (0, 1): (1,), (1, 1): (1,)}
    assert not torch.equal(shard_seed(seed, local[0, 1][0]), shard_seed(seed, local[0, 0][0]))


def test_sharded_inkernel_sampler_draws_each_shard_from_its_words():
    """The in-kernel-RNG flagship at ``sampler_shards=2`` on the CPU: each
    shard's fresh rows are ``philox.normal_draws`` of that shard's words
    (rollouts counted within the shard); only shard 0 holds the static
    rows (row 0 zero, row 1 the negated optimal, zero at the first update)."""
    rollouts, steps = 30, 4
    flagship = build_flagship(rollouts=rollouts, steps=steps, device="cpu", inkernel_rng=True, sampler_shards=2)
    state = flagship.init(seed=3)
    _, seed = split_key(state.rng)
    keep = flagship.planner._sample_meta(state, torch.tensor(0.0))[4]  # elite rows keep their old noise
    state, _ = flagship.update(state, flagship.x0, 0.0, flagship.make_ctx())
    scale = torch.tensor(np.sqrt(fr.DEFAULT_COVARIANCE), dtype=torch.float32)
    half = (rollouts + 2) // 2
    fresh = ~keep
    fresh[:2] = False
    for shard in (0, 1):
        block = slice(shard * half, (shard + 1) * half)
        want = normal_draws(shard_seed(seed, shard), steps, half, scale)
        assert torch.equal(state.noise[:, :, block][:, :, fresh[block]], want[:, :, fresh[block]])
    assert not bool(state.noise[:, :, :2].any())
    assert not bool(keep[half:half + 2].any())
    assert bool(state.noise[:, :10, half:half + 2].ne(0).all())  # dofs 10, 11 have zero variance


def test_sharded_noise_keeps_the_logical_layout():
    flagship = build_flagship(rollouts=14, steps=3, device="cpu", sampler_shards=4)
    state, _ = flagship.update(flagship.init(seed=0), flagship.x0, 0.0, flagship.make_ctx())
    logical = noise_to_logical(state.noise)
    assert logical.shape == (16, 3, 12)
    assert torch.equal(noise_from_logical(logical), state.noise)


def _errors():
    one_d = _Mesh((sharding.ROLLOUT_AXIS,), (2,))
    two_d = _Mesh((sharding.SCENARIO_AXIS, sharding.ROLLOUT_AXIS), (2, 1))
    return {
        "no rollout axis": (dict(mesh=_Mesh(("other",), (2,))), "'rollouts' axis"),
        "rollouts not divisible": (dict(rollouts=13, mesh=one_d), "not divisible into 2 shards"),
        "scenarios not divisible": (dict(scenarios=3, mesh=two_d), "3 scenarios not divisible"),
        "capture": (dict(capture=True, mesh=one_d), "capture=True takes no mesh"),
        "mesh and sampler_shards": (dict(mesh=one_d, sampler_shards=2), "one or the other"),
        "sampler_shards not dividing": (dict(rollouts=13, sampler_shards=2), "not divisible into 2 shards"),
    }


@pytest.mark.parametrize("case", list(_errors()))
def test_build_flagship_value_errors(case):
    options, message = _errors()[case]
    options = {"rollouts": 14, "steps": 3, "device": "cpu", **options}
    with pytest.raises(ValueError, match=message):
        build_flagship(**options)


def test_lane_noise_to_logical_with_shards():
    """Two shards of 100 rollouts, each padded on its own to one 128-lane
    tile (the JAX sampler's layout): the conversion drops each shard's
    padding; the one-shard conversion would read shard 0's padding as
    rollouts 100-127."""
    rng = np.random.default_rng(0)
    logical = rng.standard_normal((200, 5, 12)).astype(np.float32)
    lanes = np.full((2, 5, 12, 1, 128), np.nan, np.float32)
    for shard in (0, 1):
        lanes[shard, :, :, 0, :100] = logical[shard * 100:(shard + 1) * 100].transpose(1, 2, 0)
    np.testing.assert_array_equal(interop.lane_noise_to_logical(lanes, 200, shards=2), logical)
    assert np.isnan(interop.lane_noise_to_logical(lanes, 200)[100:128]).all()
    state = interop.planner_state_from_numpy(
        {"noise": lanes, "optimal_control": np.zeros((5, 12)), "costs": np.zeros((200, 2)),
         **{name: np.zeros(()) for name in ("last_shift_time", "last_update_time", "sg_time", "update_count",
                                           "optimal_cost", "update_duration")},
         "sg_buffer": np.zeros((0, 0)), "rng": np.zeros(2, np.uint32)},
        200, device="cpu", shards=2,
    )
    np.testing.assert_array_equal(noise_to_logical(state.noise).numpy(), logical)
