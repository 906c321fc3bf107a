"""Why the pose/unassisted cell of the port's matrix holds more force on the
card than on the CPU.

The cell (scripts/torch_experiments.py: the pose row holds the initial
huddled end effector, no forecast reaches the planner, the controller
runs) at float32, captured on the card. Parts (``--parts``,
comma-separated):

- ``seeds``: the cell over ``--seeds`` on ``--device``: per seed the mean
  force, RMSE and wall time; their median, mean, standard deviation and
  range beside the JAX cell's band.
- ``same_draws``: one set of draws for every update of the episode, made on
  the host with a CPU ``torch.Generator`` (seed ``--draw-seed``), scaled to
  the planner's covariance and passed as ``Episode.run(noise_override=)``
  (every sampled row, elite rows included, so this is not the matrix's
  controller). The episode on ``--device`` and the same one on the CPU, at
  ``--dtype`` (the planner and the episode), in a child process started
  first. Their mean forces, the first tick at which their EE traces part
  by more than each of ``PARTING_M``, the traces' distance at a few ticks,
  and the first tick's operations on both devices from the same inputs
  (derive, the human's PID, the planner's costs, weights and gradient, the
  published control, the plant step), with the largest difference of
  each.
- ``float64``: the cell at float64 (the planner and the episode) on
  ``--device`` for the first three seeds.
- ``draws``: the planner's fresh draws on ``--device``: the per-update seed
  words split from the key (``philox.split_key``), each seeding the
  sampler's generator (``PlantSampler.seed_replay``), as the episode's
  captured periods do; a one-draw CUDA graph replayed after each reseed
  must give the eager draws bitwise, no two updates' seed words may repeat,
  and the sample correlation of successive updates' draws must lie within
  ``CORRELATION_SIGMAS`` standard errors (1 / sqrt(n)) of 0.

Usage:
    python3 scripts/torch_pose_diagnosis.py [--device cuda|cpu] [--out DIR]
        [--parts seeds,same_draws,float64,draws] [--seeds 0,...,9] [--duration 15]
        [--dtype float32|float64] [--draw-seed N]

Writes ``torch_pose_diagnosis.json`` under ``--out`` (default
build/torch_pose_diagnosis) with ``device`` and ``power_limit``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import multiprocessing
import os
import statistics
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from assistedmanipulation_tpu_torch import resolve_device  # noqa: E402
from assistedmanipulation_tpu_torch.kernels.philox import key_from_seed, split_key  # noqa: E402
from assistedmanipulation_tpu_torch.models import frankaridgeback as fr  # noqa: E402
from assistedmanipulation_tpu_torch.ops.gaussian import diagonal_scale  # noqa: E402
from assistedmanipulation_tpu_torch.sim.episode import episode_metrics  # noqa: E402

import scripts.torch_experiments as ex  # noqa: E402

# The JAX cell's seed range 6.99-7.81 N widened by 15% of its median 7.80.
JAX_BAND = (5.82, 8.98)
DIVERGE_M = 1e-6
PARTING_M = (1e-12, 1e-9, DIVERGE_M)  # the same_draws part reports the first tick past each
CORRELATION_SIGMAS = 5.0
TRACE_TICKS = (1, 10, 100, 1000)
DRAW_SEED = 0


def pose_episode(duration: float, device, dtype=torch.float32, capture=None):
    """The pose/unassisted cell's episode; at float64 the planner too."""
    episode = ex.make_episode("pose", "unassisted", duration, device, capture=capture)
    if dtype == torch.float32:
        return episode
    return ex.Episode(
        dataclasses.replace(ex.mppi_configuration(), dtype="float64"), episode.objective, episode.trajectory,
        episode.episode, dtype=dtype, device=device, capture=capture,
    )


def run(episode, seed: int = 0, noise_override=None) -> dict:
    start = time.perf_counter()
    outputs = episode.run(seed=seed, noise_override=noise_override)
    if episode.device.type == "cuda":
        torch.cuda.synchronize(episode.device)
    metrics = episode_metrics(outputs)
    metrics["wall_s"] = time.perf_counter() - start
    metrics["ee"] = outputs.ee_position.detach().cpu().double().numpy()
    return metrics


def summary(forces: list) -> dict:
    return {
        "median": statistics.median(forces), "mean": statistics.mean(forces),
        "sd": statistics.stdev(forces) if len(forces) > 1 else 0.0, "min": min(forces), "max": max(forces),
        "in_jax_band": sum(JAX_BAND[0] <= f <= JAX_BAND[1] for f in forces),
    }


def seeds_part(seeds, duration, device, dtype=torch.float32) -> dict:
    rows = []
    for seed in seeds:
        metrics = run(pose_episode(duration, device, dtype), seed)
        rows.append({"seed": seed, **{k: metrics[k] for k in ("mean_force", "rmse", "max_force", "wall_s")}})
        print(f"pose/unassisted {dtype} seed {seed}: mean force {metrics['mean_force']:.4f} N, rmse "
              f"{metrics['rmse']:.5f} m, wall {metrics['wall_s']:.1f} s", flush=True)
    return {"runs": rows, "force": summary([row["mean_force"] for row in rows])}


def injected_noise(duration: float, draw_seed: int, dtype=torch.float32) -> torch.Tensor:
    """(updates, R - 2, steps, dof) draws of the cell's covariance in
    ``dtype`` from a CPU generator: every sampled row of every update."""
    configuration = ex.mppi_configuration()
    updates = int(round(duration / 0.05))
    steps = int(round(configuration.horizon / configuration.time_step))
    scale = torch.as_tensor(diagonal_scale(configuration.covariance), dtype=dtype)
    generator = torch.Generator().manual_seed(draw_seed)
    z = torch.randn((updates, configuration.rollouts, steps, scale.shape[0]), generator=generator, dtype=dtype)
    return z * scale


def _cpu_same_draws(duration: float, draw_seed: int, path: str, dtype: str = "float32") -> None:
    """The child process's CPU run under the injected draws."""
    torch.set_num_threads(4)
    dtype = getattr(torch, dtype)
    metrics = run(pose_episode(duration, "cpu", dtype), 0, injected_noise(duration, draw_seed, dtype))
    np.save(path, metrics.pop("ee"))
    with open(path + ".json", "w") as handle:
        json.dump(metrics, handle)


def _to(tree, device):
    if isinstance(tree, tuple):
        values = [_to(value, device) for value in tree]
        return type(tree)(*values) if hasattr(tree, "_fields") else tuple(values)
    if isinstance(tree, torch.Tensor) and tree.is_floating_point():
        return tree.to(device)
    return tree


def _max_diff(a, b) -> float:
    if isinstance(a, tuple):
        return max((_max_diff(x, y) for x, y in zip(a, b)), default=0.0)
    return float((a.detach().cpu().double() - b.detach().cpu().double()).abs().max())


def first_tick_operations(device, noise: torch.Tensor, dtype=torch.float32) -> list:
    """The first tick's operations on ``device`` and on the CPU from the
    same inputs (the CPU's initial carry), eager, in tick order: (name,
    largest difference)."""
    outs = {}
    for where in ("cpu", device):
        episode = pose_episode(0.05, where, dtype, capture=False)
        carry = _to(episode.init_carry(0), where)
        x = carry.x
        model = episode.model
        aux = fr.derive_aux(model, x)
        t = torch.zeros((), dtype=dtype, device=x.device)
        pid_state = episode.pid.set_reference(carry.pid_state, episode.trajectory.position(t).to(x.dtype))
        pid_state = episode.pid.update(pid_state, aux.ee_position, t)
        wrench = torch.cat([pid_state.control, torch.zeros(3, dtype=x.dtype, device=x.device)])
        state, info = episode.planner.update(carry.planner_state, x, t, None, noise_override=noise[0])
        u = episode.planner.get(state, t)
        kp, kd = (torch.as_tensor(np.asarray(v), dtype=x.dtype, device=x.device) for v in (episode._kp, episode._kd))
        x_next, _, _ = fr.integrate_with_wrench_extras(model, kp, kd, x, u, aux, wrench, episode.episode.time_step)
        outs[str(where)] = [
            ("derive_aux", aux), ("human PID", pid_state.control), ("planner costs", info.costs),
            ("planner weights", info.weights), ("planner gradient", info.gradient),
            ("optimal control", state.optimal_control), ("published control", u), ("plant step", x_next),
        ]
    cpu, card = outs["cpu"], outs[str(device)]
    return [(name, _max_diff(a, b)) for (name, a), (_, b) in zip(cpu, card)]


def start_cpu_same_draws(duration, draw_seed, out, dtype=torch.float32):
    """The CPU run under the injected draws, in a child process that runs
    while this one drives the card."""
    path = os.path.join(out, "cpu_same_draws.npy")
    child = multiprocessing.get_context("spawn").Process(
        target=_cpu_same_draws, args=(duration, draw_seed, path, str(dtype).split(".")[-1]))
    child.start()
    return child, path


def same_draws_part(duration, device, draw_seed, child, path, dtype=torch.float32) -> dict:
    noise = injected_noise(duration, draw_seed, dtype)
    card = run(pose_episode(duration, device, dtype), 0, noise)
    operations = first_tick_operations(device, noise, dtype)
    child.join()
    if child.exitcode != 0:
        raise RuntimeError(f"the CPU run exited with {child.exitcode}")
    with open(path + ".json") as handle:
        cpu = json.load(handle)
    cpu_ee = np.load(path)
    distance = np.linalg.norm(card.pop("ee") - cpu_ee, axis=-1)
    parted = np.flatnonzero(distance > DIVERGE_M)
    report = {
        "draw_seed": draw_seed,
        "dtype": str(dtype).split(".")[-1],
        device.type: {k: card[k] for k in ("mean_force", "rmse", "wall_s")},
        "cpu": {k: cpu[k] for k in ("mean_force", "rmse", "wall_s")},
        "force_difference": card["mean_force"] - cpu["mean_force"],
        "first_tick_parted": int(parted[0]) if parted.size else None,
        "first_tick_past": {str(m): (int(np.flatnonzero(distance > m)[0]) if (distance > m).any() else None)
                            for m in PARTING_M},
        "ee_distance_at": {int(k): float(distance[k]) for k in TRACE_TICKS if k < len(distance)},
        "ticks": int(len(distance)),
        "ee_distance_max": float(distance.max()),
        "first_tick_operations": operations,
    }
    print(f"same draws (seed {draw_seed}, {report['dtype']}): {device.type} {card['mean_force']:.6f} N, cpu "
          f"{cpu['mean_force']:.6f} N; EE traces first past {json.dumps(report['first_tick_past'])} m at those "
          f"ticks (of {len(distance)}), largest distance {report['ee_distance_max']:.3g} m; first tick's operations "
          f"{operations}", flush=True)
    return report


def draws_part(device, updates: int) -> dict:
    """The sampler's fresh draws per update, eager and after a reseeded
    graph replay, and their correlation across updates."""
    episode = pose_episode(0.05, device, capture=False)
    sampler = episode.planner.sampler
    scale = torch.as_tensor(diagonal_scale(ex.mppi_configuration().covariance), dtype=torch.float32,
                            device=device)
    shape = (sampler.steps, sampler.dof, sampler.rollouts)
    generators, host_inputs = sampler.graph_rng()
    generator = generators[0]
    drawn = torch.nonzero(scale > 0).flatten()  # the dofs with a variance
    drawn_scale = scale[drawn][None, :, None]

    def draw():
        from assistedmanipulation_tpu_torch.ops.gaussian import sample_noise

        return sample_noise(generator, scale, shape, dim=1).index_select(1, drawn) / drawn_scale

    key, seeds, eager = key_from_seed(0), [], []
    for _ in range(updates):
        key, seed = split_key(key)
        seeds.append(tuple(seed.tolist()))
        sampler.seed_replay(seed)
        eager.append(draw())
    replayed_equal = None
    if device.type == "cuda":
        from assistedmanipulation_tpu_torch import graphs

        graph = graphs.CapturedGraph(draw, generators, host_inputs)
        key, replayed_equal = key_from_seed(0), True
        for u in range(updates):
            key, seed = split_key(key)
            sampler.seed_replay(seed)
            out = graph.replay()
            replayed_equal &= bool(torch.equal(out, eager[u]))
    z = torch.stack(eager).double().reshape(updates, -1)
    z = z - z.mean(dim=1, keepdim=True)
    z = z / z.norm(dim=1, keepdim=True)
    successive = (z[:-1] * z[1:]).sum(dim=1)
    gate = CORRELATION_SIGMAS / float(np.sqrt(z.shape[1]))
    report = {
        "updates": updates, "draws_per_update": int(z.shape[1]),
        "distinct_seed_words": len(set(seeds)),
        "successive_correlation_max_abs": float(successive.abs().max()),
        "successive_correlation_mean": float(successive.mean()),
        "gate": gate,
        "replayed_bitwise_eager": replayed_equal,
        "ok": len(set(seeds)) == updates and float(successive.abs().max()) < gate and replayed_equal is not False,
    }
    print(f"draws: {json.dumps(report)}", flush=True)
    return report


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    parser.add_argument("--out", default=os.path.join(ROOT, "build", "torch_pose_diagnosis"))
    parser.add_argument("--parts", default="seeds,same_draws,float64,draws")
    parser.add_argument("--seeds", default=",".join(str(s) for s in range(10)))
    parser.add_argument("--duration", type=float, default=15.0)
    parser.add_argument("--dtype", default="float32", choices=("float32", "float64"),
                        help="the same_draws part's dtype")
    parser.add_argument("--draw-seed", type=int, default=DRAW_SEED, help="the same_draws part's draws")
    args = parser.parse_args(argv)
    dtype = getattr(torch, args.dtype)
    device = resolve_device(args.device)
    os.makedirs(args.out, exist_ok=True)
    parts = [part for part in args.parts.split(",") if part]
    identity = ex.device_identity(device)
    print(f"device: {identity['device']}, power limit {identity['power_limit']}", flush=True)
    seeds = [int(s) for s in args.seeds.split(",")]
    payload = {"cell": "pose/unassisted", "duration": args.duration, "jax_band": JAX_BAND, **identity}
    start = time.perf_counter()
    if "draws" in parts:
        payload["draws"] = draws_part(device, int(round(args.duration / 0.05)))
    if "same_draws" in parts:
        child, path = start_cpu_same_draws(args.duration, args.draw_seed, args.out, dtype)
    if "seeds" in parts:
        payload["seeds"] = seeds_part(seeds, args.duration, device)
    if "float64" in parts:
        payload["float64"] = seeds_part(seeds[:3], args.duration, device, torch.float64)
    if "same_draws" in parts:
        payload["same_draws"] = same_draws_part(args.duration, device, args.draw_seed, child, path, dtype)
    payload["wall_s"] = time.perf_counter() - start
    path = os.path.join(args.out, "torch_pose_diagnosis.json")
    with open(path, "w") as handle:
        json.dump(payload, handle, indent=1)
    print(json.dumps({key: value for key, value in payload.items()}), flush=True)
    print(f"wrote {path}", flush=True)
    return 0 if payload.get("draws", {}).get("ok", True) else 1


if __name__ == "__main__":
    sys.exit(main())
