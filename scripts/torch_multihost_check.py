"""Two ranks of the sharded flagship against its single-process twin.

The port's counterpart of scripts/multihost_check.py. It spawns 2 ranks
that join one ``torch.distributed`` process group (a ``file://`` rendezvous
in ``--store``), build ``parallel/flagship.build_flagship(mesh=...)`` for
each case on a 1-D ``("rollouts",)`` mesh or a 2-D ``("scenarios",
"rollouts")`` mesh of 2 x 1, and run ``--updates`` updates from the same
seed. Then this process runs the twin, ``build_flagship(sampler_shards=n)``
with n the mesh's rollout axis, on the same device, and compares every
update: noise, costs, weights, gradient, optimal control and rollout-0
states. Cases marked exact must be equal to the bit; the others within
SCENARIO_TOLERANCE. The ranks must also agree with each other on everything
they replicate, and each must have launched its kernel once per update (no
launch on the CPU, where the plain versions run); the twin launches n
times per update.

Cases (``--cases``, comma-separated):

- ``fused``: the serving flagship on the 1-D mesh (kernel 1 on the card),
  exact;
- ``inkernel``: ``inkernel_rng=True`` on the 1-D mesh (kernel 3), exact;
- ``vmap``: ``backend="vmap"`` on the 1-D mesh (the plant in plain
  PyTorch, through ``sharding.shard_rollout_fn``), exact;
- ``resimulate``: ``optimal_rollout_mode="resimulate"`` on the 1-D mesh
  (kernel 1, then kernel 2 at R = 1 replicated on each rank), exact;
- ``scenario``: ``scenarios=--scenarios`` on the 2 x 1 mesh, two-pass
  (kernel 2 on the card), each rank scoring its half of the ensemble;
- ``scenario-safety``: the same with ``safety=True``;
- ``scenario-vmap``: the same on ``backend="vmap"``.

Two ranks on one card run gloo, whose collectives stage CUDA tensors
through the host; NCCL refuses two ranks on one device. The ranks' solves/s
(eager, after UNTIMED_UPDATES updates, the outputs copied on the device
each update) and the time per collective are printed, not targets: two
processes share one card.

Usage:
    python scripts/torch_multihost_check.py [--device cpu|cuda] [--backend gloo]
        [--rollouts 9998] [--steps 50] [--updates 20] [--scenarios 4]
        [--cases fused,inkernel,scenario] [--store DIR] [--timeout 900] [--out FILE]

Prints one JSON line (and writes it to ``--out``); exits non-zero if a
comparison fails. It needs ``--device cuda`` on a card, and builds the
kernels before it spawns the ranks.
"""

from __future__ import annotations

import argparse
import json
import multiprocessing
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

RANKS = 2
SEED = 0
# The scenario cases against the twin: the noise bitwise, the rest within
# this of max(|twin|, 1). Float32 rounding is all that may differ there.
SCENARIO_TOLERANCE = 1e-4
CASES = {
    # name: (mesh "1d" or "2d", build_flagship options, exact)
    "fused": ("1d", {}, True),
    "inkernel": ("1d", {"inkernel_rng": True}, True),
    "vmap": ("1d", {"backend": "vmap"}, True),
    "resimulate": ("1d", {"optimal_rollout_mode": "resimulate"}, True),
    "scenario": ("2d", {}, False),
    "scenario-safety": ("2d", {"safety": True}, False),
    "scenario-vmap": ("2d", {"backend": "vmap"}, False),
}
COLLECTIVE_REPEATS = 20
# Updates run before the ranks' clock starts (the first one loads the
# kernels and checks their topology); every update is compared.
UNTIMED_UPDATES = 2


def _options(case: str, args) -> dict:
    mesh, options, _ = CASES[case]
    return {**options, "scenarios": args.scenarios} if mesh == "2d" else dict(options)


def _times(args, device) -> torch.Tensor:
    return torch.arange(1, args.updates + 1, dtype=torch.float32, device=device) * 0.01


def _record(info, state) -> dict:
    """One update's outputs the comparison reads, copied on the device."""
    return {
        "costs": info.costs.clone(),
        "weights": info.weights.clone(),
        "gradient": info.gradient.clone(),
        "states": info.optimal_rollout_states.clone(),
        "optimal_control": state.optimal_control.clone(),
        "optimal_cost": info.optimal_cost.clone(),
    }


def _to_host(records: list) -> list:
    return [{name: value.cpu() for name, value in record.items()} for record in records]


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize()


def _collective_ms(mesh, args, device) -> dict:
    """Milliseconds per call of the update's collectives at this run's
    shapes, over COLLECTIVE_REPEATS calls each."""
    from assistedmanipulation_tpu_torch.parallel import sharding

    group = mesh.get_group(sharding.ROLLOUT_AXIS)
    block = (args.rollouts + 2) // RANKS
    calls = {
        "costs_all_gather": lambda: sharding._all_gather(torch.zeros((block, 2), device=device), group),
        "partial_all_gather": lambda: sharding._all_gather(torch.zeros((args.steps, 12), device=device), group),
        "states_broadcast": lambda: sharding._broadcast_first(torch.zeros((args.steps, 24), device=device), group),
    }
    out = {}
    for name, call in calls.items():
        call()
        _sync(device)
        t0 = time.perf_counter()
        for _ in range(COLLECTIVE_REPEATS):
            call()
        _sync(device)
        out[name] = (time.perf_counter() - t0) * 1e3 / COLLECTIVE_REPEATS
    return out


def check_shard_rollout_fn(rank: int, meshes: dict, device) -> dict:
    """``sharding.shard_rollout_fn`` on made-up rollout functions: a
    costs-only one on the 1-D mesh (each rank's block of 3 costs is its
    rank), a paired one whose states are its rank, and on the 2 x 1 mesh a
    scenario ensemble under ``scenario_weights`` (1, 3), each rank's
    scenario scoring its slice's wrench. Raises on a wrong result."""
    from assistedmanipulation_tpu_torch.objectives.assisted_manipulation import ForecastContext
    from assistedmanipulation_tpu_torch.parallel import sharding

    noise = torch.zeros((3, 4, 12), device=device)

    def costs_only(noise, optimal_shifted, x0, time, ctx):
        return torch.full((noise.shape[0], 2), float(rank), device=noise.device)

    costs = sharding.shard_rollout_fn(costs_only, meshes["1d"])(noise, None, None, None, None)
    if costs.tolist() != [[0.0, 0.0]] * 3 + [[1.0, 1.0]] * 3:
        raise AssertionError(f"costs-only shard_rollout_fn gave {costs.tolist()}")

    def paired(noise, optimal_shifted, x0, time, ctx):
        return costs_only(noise, optimal_shifted, x0, time, ctx), torch.full((4, 31), float(rank), device=noise.device)

    costs, states = sharding.shard_rollout_fn(paired, meshes["1d"])(noise, None, None, None, None)
    if costs.shape != (6, 2) or bool((states != 0).any()):
        raise AssertionError("paired shard_rollout_fn: wrong costs or states not the first shard's")

    def wrench_cost(noise, optimal_shifted, x0, time, ctx):
        return ctx.wrench_horizon[0, 0].expand(noise.shape[0], 2).clone()

    horizons = torch.zeros((2, 5, 6), device=device)
    horizons[:, :, 0] = torch.tensor([[2.0], [6.0]], device=device)  # scenario c's wrench: 2, 6
    ctx = sharding.shard_ctx(ForecastContext(horizons, torch.zeros((), device=device), 0.01, 0.04), meshes["2d"])
    weighted = sharding.shard_rollout_fn(
        wrench_cost, meshes["2d"], scenario_axis=sharding.SCENARIO_AXIS, scenario_weights=[1.0, 3.0]
    )(noise, None, None, None, ctx)
    if weighted.tolist() != [[5.0, 5.0]] * 3:  # (1 x 2 + 3 x 6) / 4
        raise AssertionError(f"scenario-weighted shard_rollout_fn gave {weighted.tolist()}")
    return {"costs_only": True, "paired": True, "scenario_weights": True}


def rank_main(rank: int, args, out_dir: str) -> None:
    """One rank: every case on its mesh; its records to ``out_dir``."""
    torch.set_num_threads(1)
    from assistedmanipulation_tpu_torch.kernels import build
    from assistedmanipulation_tpu_torch.parallel import sharding
    from assistedmanipulation_tpu_torch.parallel.flagship import build_flagship

    device = torch.device(args.device)
    sharding.initialize_multi_host(
        f"file://{os.path.join(args.store, 'rendezvous')}", RANKS, rank, args.backend, device
    )
    try:
        meshes = {"1d": sharding.make_mesh(device.type), "2d": sharding.make_scenario_mesh(RANKS, device.type)}
        if rank == 0:
            try:
                sharding.make_scenario_mesh(RANKS + 1, device.type)
            except ValueError:
                pass
            else:
                raise AssertionError("make_scenario_mesh took a scenario count that does not divide the world")
        out = {"cases": {}, "collective_ms": _collective_ms(meshes["1d"], args, device),
               "shard_rollout_fn": check_shard_rollout_fn(rank, meshes, device)}
        for case in args.cases:
            mesh = meshes[CASES[case][0]]
            flagship = build_flagship(args.rollouts, args.steps, device=device, mesh=mesh, **_options(case, args))
            ctx, times = flagship.make_ctx(), _times(args, device)
            state = flagship.init(seed=SEED)
            records = []
            build.reset_launch_counts()
            for k in range(args.updates):
                if k == UNTIMED_UPDATES:
                    _sync(device)
                    t0 = time.perf_counter()
                state, info = flagship.update(state, flagship.x0, times[k], ctx)
                records.append(_record(info, state))
            _sync(device)
            wall = time.perf_counter() - t0
            whole = sharding.gather_planner_state(flagship.planner, state, mesh)
            out["cases"][case] = {
                "records": _to_host(records),
                "noise": whole.noise.cpu() if rank == 0 else None,
                "launches": dict(build.LAUNCHES),
                "solves_per_s": (args.updates - UNTIMED_UPDATES) / wall,
                "held_noise_shape": list(state.noise.shape),
                "ctx_scenarios": int(ctx.wrench_horizon.shape[0]) if ctx.wrench_horizon.dim() == 3 else 1,
            }
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        torch.distributed.destroy_process_group()


def _bitwise(a: torch.Tensor, b: torch.Tensor) -> bool:
    if a.shape != b.shape:
        return False
    if a.is_floating_point():
        kind = torch.int32 if a.dtype == torch.float32 else torch.int64
        a, b = a.contiguous().view(kind), b.contiguous().view(kind)
    return torch.equal(a, b)


def _error(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| / max(|want|, 1), NaN patterns required equal."""
    if not torch.equal(torch.isnan(got), torch.isnan(want)):
        return float("inf")
    rel = (got.double() - want.double()).abs() / want.double().abs().clamp(min=1.0)
    return float(rel.nan_to_num().max()) if rel.numel() else 0.0


def run_twin(case: str, args) -> dict:
    """The case's single-process twin on this device: records and noise."""
    from assistedmanipulation_tpu_torch.kernels import build
    from assistedmanipulation_tpu_torch.kernels.cuda_rollout import noise_to_logical
    from assistedmanipulation_tpu_torch.parallel.flagship import build_flagship

    device = torch.device(args.device)
    shards = RANKS if CASES[case][0] == "1d" else 1
    flagship = build_flagship(args.rollouts, args.steps, device=device, sampler_shards=shards, **_options(case, args))
    ctx, times = flagship.make_ctx(), _times(args, device)
    state = flagship.init(seed=SEED)
    records = []
    build.reset_launch_counts()
    for k in range(args.updates):
        state, info = flagship.update(state, flagship.x0, times[k], ctx)
        records.append(_record(info, state))
    return {"records": _to_host(records), "noise": state.noise.cpu(), "launches": dict(build.LAUNCHES), "shards": shards,
            "logical_noise_shape": list(noise_to_logical(state.noise).shape)}


def compare(case: str, ranks: list, twin: dict, args) -> dict:
    """The ranks against each other and against the twin; the report."""
    exact = CASES[case][2]
    first, second = (rank["cases"][case] for rank in ranks)
    report = {"exact": exact, "updates": args.updates, "solves_per_s": [first["solves_per_s"], second["solves_per_s"]],
              "rank_launches": first["launches"], "twin_launches": twin["launches"],
              "held_noise_shape": first["held_noise_shape"], "ctx_scenarios": first["ctx_scenarios"]}
    failures = []
    for k, (a, b) in enumerate(zip(first["records"], second["records"])):
        for name in a:
            if not _bitwise(a[name], b[name]):
                failures.append(f"update {k}: the ranks' {name} differ")
    report["noise_bitwise"] = _bitwise(first["noise"], twin["noise"])
    if not report["noise_bitwise"]:
        failures.append("noise differs from the twin's")
    errors = {}
    for k, (got, want) in enumerate(zip(first["records"], twin["records"])):
        for name in got:
            if exact and not _bitwise(got[name], want[name]):
                failures.append(f"update {k}: {name} differs from the twin's")
            errors[name] = max(errors.get(name, 0.0), _error(got[name], want[name]))
    report["max_rel_err"] = errors
    report["bitwise"] = all(
        _bitwise(got[name], want[name]) for got, want in zip(first["records"], twin["records"]) for name in got
    )
    if not exact and max(errors.values()) > SCENARIO_TOLERANCE:
        failures.append(f"errors {errors} beyond {SCENARIO_TOLERANCE}")
    options = _options(case, args)
    kernels = {}  # kernel: launches per update and shard
    if options.get("backend") != "vmap":
        if options.get("inkernel_rng"):
            kernels["inkernel_rng_sample_rollout"] = 1
        elif "scenarios" in options:
            kernels["rollout"] = 1
        else:
            kernels["fused_sample_rollout"] = 1
    resimulated = options.get("optimal_rollout_mode") == "resimulate"
    for who, launches, shards in (("rank", first["launches"], 1), ("twin", twin["launches"], twin["shards"])):
        expected = {name: 0 for name in launches}
        if args.device == "cuda":
            for name, per_shard in kernels.items():
                expected[name] = per_shard * shards * args.updates
            if resimulated:  # the re-rollout at R = 1, once per update whatever the shards
                expected["rollout"] += args.updates
        if launches != expected:
            failures.append(f"{who} launches {launches}, expected {expected}")
    report["failures"] = failures
    report["ok"] = not failures
    return report


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    parser.add_argument("--backend", default="gloo")
    parser.add_argument("--rollouts", type=int, default=9_998)
    parser.add_argument("--steps", type=int, default=50)
    parser.add_argument("--updates", type=int, default=20)
    parser.add_argument("--scenarios", type=int, default=4)
    parser.add_argument("--cases", default="fused,inkernel,scenario")
    parser.add_argument("--store", default=None, help="directory for the rendezvous file and the ranks' records")
    parser.add_argument("--timeout", type=float, default=900.0)
    parser.add_argument("--out", default=None)
    args = parser.parse_args(argv)
    if args.updates <= UNTIMED_UPDATES:
        parser.error(f"--updates must exceed the {UNTIMED_UPDATES} untimed ones")
    args.cases = [case for case in args.cases.split(",") if case]
    unknown = [case for case in args.cases if case not in CASES]
    if unknown:
        parser.error(f"unknown cases {unknown}; expected some of {sorted(CASES)}")
    if args.device == "cuda":
        if not torch.cuda.is_available():
            print("torch_multihost_check: --device cuda needs a CUDA device", file=sys.stderr)
            return 2
        from assistedmanipulation_tpu_torch.kernels import build

        build.build()  # once, before the ranks would race to
    torch.set_num_threads(1)
    with tempfile.TemporaryDirectory() as scratch:
        args.store = args.store or scratch
        context = multiprocessing.get_context("spawn")
        t0 = time.perf_counter()
        processes = [context.Process(target=rank_main, args=(rank, args, args.store)) for rank in range(RANKS)]
        for process in processes:
            process.start()
        try:
            deadline = time.monotonic() + args.timeout
            for process in processes:
                process.join(max(deadline - time.monotonic(), 0.0))
        finally:
            for process in processes:
                if process.is_alive():
                    process.terminate()
                    process.join(10)
        ranks_seconds = time.perf_counter() - t0
        codes = [process.exitcode for process in processes]
        if codes != [0] * RANKS:
            print(f"torch_multihost_check: ranks exited with {codes}", file=sys.stderr)
            return 1
        ranks = [torch.load(os.path.join(args.store, f"rank{rank}.pt")) for rank in range(RANKS)]
    cases = {case: compare(case, ranks, run_twin(case, args), args) for case in args.cases}
    result = {
        "processes": RANKS,
        "device": torch.cuda.get_device_name(0) if args.device == "cuda" else "cpu",
        "backend": args.backend,
        "rollouts": args.rollouts + 2,
        "steps": args.steps,
        "scenarios": args.scenarios,
        "ranks_seconds": ranks_seconds,
        "collective_ms": ranks[0]["collective_ms"],
        "shard_rollout_fn": ranks[0]["shard_rollout_fn"],
        "cases": cases,
        "ok": all(case["ok"] for case in cases.values()),
    }
    line = json.dumps(result)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)
    return 0 if result["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
