"""Scaling of the sharded flagship: solves/s against the rollout shards.

The port of scripts/scaling_bench.py. The measured program is the flagship
(``parallel/flagship.build_flagship``) on kernel 1, the fused
sample+rollout kernel, as in the JAX script (its pallas backend):

- ``overhead``: the same total rollout work (``--rollouts-per-device`` x
  the largest size) unsharded and over ``build_flagship(sampler_shards=n)``,
  the mesh's one-process twin, on one device: n blocks with their own seed
  words, one kernel-1 launch each per update, run in turn; on the card
  each update is one CUDA graph (``capture=True``: what a controller runs,
  and the counterpart of the JAX script's compiled program). Median of
  ``--repeats`` runs of ``--iters`` timed updates each (after one untimed
  update, the capture on the card). Kernel 1's launches per update are counted
  (``kernels/build.LAUNCHES``) and must be n on the card (0 on the CPU,
  where the plain version runs). On one card the twin's shards run one
  after another, and a launch lasts one rollout's chain whatever its
  block, so the efficiency is expected near 1 / n.
- ``weak``: the rollouts grow with the ranks (``--rollouts-per-device`` x
  n); n = 1 in this process, n > 1 as n ranks of one
  ``torch.distributed`` group over gloo on a 1-D
  mesh (``sharding.make_mesh``), rank 0's rate, eager (a gloo collective
  cannot be captured; n = 1 eager too). On one card the ranks share it
  (``weak_caveat``), as the JAX script's fake mesh shares one machine's
  cores.
- ``collectives``: what one update sends, counted on the ranks: every
  ``torch.distributed`` collective the update calls (a counting wrapper
  around the calls), with the bytes it moves (the gathered or broadcast
  tensors), on the 1-D meshes of the sizes above 1 and on the 2 x (n / 2)
  scenario mesh (``make_scenario_mesh(2)``, 2 scenarios) of the largest
  even size. The JAX script read its counts from the compiled program.

NCCL and more than one card are not measured by this script's runs on one
card: ranks on one card must use gloo.

Usage:
    python3 scripts/torch_scaling_bench.py [--device cuda|cpu]
        [--mode weak|overhead|both|collectives] [--rollouts-per-device 1024]
        [--steps 50] [--iters 10] [--repeats 3] [--sizes 1,2,4,8]
        [--out FILE]

Prints one JSON line per row and writes the payload (the JAX script's keys
plus ``device`` and ``power_limit``) to ``--out`` only.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import multiprocessing
import os
import sys
import tempfile
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from assistedmanipulation_tpu_torch import resolve_device  # noqa: E402
from assistedmanipulation_tpu_torch.kernels import build  # noqa: E402
from assistedmanipulation_tpu_torch.parallel.flagship import build_flagship  # noqa: E402

import scripts.torch_experiments as ex  # noqa: E402

KERNEL = "fused_sample_rollout"
COLLECTIVES = ("all_gather", "broadcast", "all_reduce", "reduce_scatter", "all_to_all")
RANKS_TIMEOUT_S = 900.0  # the spawned ranks of one mode, together


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def timed_rate(flagship, iters: int, device) -> tuple:
    """(solves/s over ``iters`` updates after one untimed one, kernel-1
    launches per timed update)."""
    ctx = flagship.make_ctx()
    times = torch.arange(1, iters + 1, dtype=torch.float32, device=device) * 0.01
    state, _ = flagship.update(flagship.init(0), flagship.x0, times[0] * 0, ctx)
    _sync(device)
    build.reset_launch_counts()
    start = time.perf_counter()
    for i in range(iters):
        state, _ = flagship.update(state, flagship.x0, times[i], ctx)
    _sync(device)
    elapsed = time.perf_counter() - start
    return iters / elapsed, build.LAUNCHES[KERNEL] / iters


def overhead_row(n: int, total: int, args, device) -> dict:
    """The same total rollouts over ``n`` shards of the one-process twin."""
    rates, launches = [], set()
    for _ in range(args.repeats):
        flagship = build_flagship(total, args.steps, device=device, sampler_shards=n,
                                  capture=device.type == "cuda")
        rate, per_update = timed_rate(flagship, args.iters, device)
        rates.append(rate)
        launches.add(per_update)
    expected = n if device.type == "cuda" else 0
    if launches != {expected}:
        raise AssertionError(f"{n} shards: kernel-1 launches per update {sorted(launches)}, expected {expected}")
    rates.sort()
    return {
        "devices": n,
        "rollouts": flagship.planner.rollout_count,
        "solves_per_s": round(rates[len(rates) // 2], 2),
        "solves_per_s_runs": [round(r, 2) for r in rates],
        "kernel1_launches_per_update": expected,
        # One process: the twin's blocks meet in host order, with no collective.
        "collectives": {"ops": {}, "payload_bytes": 0},
    }


@contextlib.contextmanager
def counted_collectives():
    """This process's ``torch.distributed`` collectives wrapped with a
    counter inside the block: yields the list each call appends (op,
    bytes of the tensors it gathers or broadcasts) to."""
    import torch.distributed as dist

    calls, saved = [], {name: getattr(dist, name) for name in COLLECTIVES}

    def wrap(name, fn):
        def counted(*args, **kwargs):
            out = fn(*args, **kwargs)
            tensors = args[0] if isinstance(args[0], (list, tuple)) else [args[0]]  # the output list or tensor
            calls.append((name.replace("_", "-"), sum(t.numel() * t.element_size() for t in tensors)))
            return out

        return counted

    for name, fn in saved.items():
        setattr(dist, name, wrap(name, fn))
    try:
        yield calls
    finally:
        for name, fn in saved.items():
            setattr(dist, name, fn)


def update_collectives(flagship) -> dict:
    """The collectives of one update of a mesh flagship (after an
    uncounted first update): their counts, bytes and calls in order."""
    ctx = flagship.make_ctx()
    state, _ = flagship.update(flagship.init(0), flagship.x0, 0.0, ctx)
    with counted_collectives() as calls:
        flagship.update(state, flagship.x0, 0.01, ctx)
    ops = {}
    for op, _ in calls:
        ops[op] = ops.get(op, 0) + 1
    return {"ops": ops, "payload_bytes": sum(size for _, size in calls), "calls": calls}


def rank_main(rank: int, world: int, job: str, args, store: str) -> None:
    """One rank of ``job``: "weak" times the 1-D mesh flagship;
    "collectives" counts one update's collectives on the 1-D mesh, and
    "collectives+2d" also on the 2 x (world / 2) scenario mesh of the same
    ranks. Writes its result to ``store``."""
    torch.set_num_threads(1)
    from assistedmanipulation_tpu_torch.parallel import sharding

    device = torch.device(args.device)
    sharding.initialize_multi_host(f"file://{os.path.join(store, 'rendezvous')}", world, rank, "gloo", device)
    try:
        rollouts = args.rollouts_per_device * world - 2
        mesh = sharding.make_mesh(device.type)
        if job == "weak":
            flagship = build_flagship(rollouts, args.steps, device=device, mesh=mesh)
            rate, launches = timed_rate(flagship, args.iters, device)
            out = {"solves_per_s": rate, "launches": launches, "rollouts": flagship.planner.rollout_count}
        else:
            out = {"1d": update_collectives(build_flagship(rollouts, args.steps, device=device, mesh=mesh))}
            if job == "collectives+2d":
                out["2d"] = update_collectives(build_flagship(
                    rollouts, args.steps, device=device, mesh=sharding.make_scenario_mesh(2, device.type),
                    scenarios=2))
        torch.save(out, os.path.join(store, f"rank{rank}.pt"))
    finally:
        torch.distributed.destroy_process_group()


def run_ranks(job: str, world: int, args) -> list:
    """``world`` spawned ranks of ``job``; their results in rank order."""
    with tempfile.TemporaryDirectory() as store:
        context = multiprocessing.get_context("spawn")
        processes = [context.Process(target=rank_main, args=(rank, world, job, args, store)) for rank in range(world)]
        for process in processes:
            process.start()
        deadline = time.monotonic() + RANKS_TIMEOUT_S
        try:
            for process in processes:
                process.join(max(deadline - time.monotonic(), 0.0))
        finally:
            for process in processes:
                if process.is_alive():
                    process.terminate()
                    process.join(10)
        codes = [process.exitcode for process in processes]
        if codes != [0] * world:
            raise RuntimeError(f"{job} on {world} ranks: the ranks exited with {codes}")
        return [torch.load(os.path.join(store, f"rank{rank}.pt")) for rank in range(world)]


def collective_rows(world: int, args, two_d: bool) -> list:
    """The rows of ``world`` ranks: the 1-D mesh, and with ``two_d`` the
    2 x (world / 2) scenario mesh; every rank must count the same."""
    ranks = run_ranks("collectives+2d" if two_d else "collectives", world, args)
    rows = []
    for mesh in ("1d", "2d") if two_d else ("1d",):
        counts = [{"ops": r[mesh]["ops"], "payload_bytes": r[mesh]["payload_bytes"]} for r in ranks]
        if any(c != counts[0] for c in counts):
            raise AssertionError(f"{mesh} mesh of {world} ranks: the ranks' collectives differ: {counts}")
        row = {"devices": world, "mesh": "1d_rollouts" if mesh == "1d" else "2d_scenarios_x_rollouts"}
        if mesh == "2d":
            row["scenarios"] = 2
        row.update(rollouts=args.rollouts_per_device * world, collectives=counts[0], calls=ranks[0][mesh]["calls"])
        rows.append(row)
    return rows


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    parser.add_argument("--mode", choices=("weak", "overhead", "both", "collectives"), default="both")
    parser.add_argument("--rollouts-per-device", type=int, default=1024)
    parser.add_argument("--steps", type=int, default=50)
    parser.add_argument("--iters", type=int, default=10)
    parser.add_argument("--repeats", type=int, default=3, help="overhead mode: median-of-N runs per size")
    parser.add_argument("--sizes", default="1,2,4,8", help="rollout shards (overhead) or ranks (weak, collectives)")
    parser.add_argument("--out", default=None, help="write the results JSON here")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    sizes = sorted(int(n) for n in args.sizes.split(","))
    identity = ex.device_identity(device)
    print(f"device: {identity['device']}, power limit {identity['power_limit']}", flush=True)
    if device.type == "cuda":
        build.build()  # once, before spawned ranks would race to
    results = {"platform": device.type, "backend": "cuda" if device.type == "cuda" else "plain", **identity}

    if args.mode in ("weak", "both"):
        weak = []
        for n in sizes:
            if n == 1:
                flagship = build_flagship(args.rollouts_per_device - 2, args.steps, device=device)
                rate, _ = timed_rate(flagship, args.iters, device)
                rollouts = flagship.planner.rollout_count
            else:
                rank0 = run_ranks("weak", n, args)[0]
                rate, rollouts = rank0["solves_per_s"], rank0["rollouts"]
            weak.append({"devices": n, "rollouts": rollouts, "solves_per_s": round(rate, 2),
                         "rollouts_per_s": round(rate * rollouts)})
        for row in weak:
            row["weak_scaling_efficiency"] = round(row["solves_per_s"] / weak[0]["solves_per_s"], 3)
            print(json.dumps(row), flush=True)
        results["weak"] = weak
        results["weak_caveat"] = (
            f"the ranks share one {device.type} device ({identity['device']}) through gloo: weak "
            "scaling here measures their contention, not an interconnect; NCCL and more than one card unmeasured"
        )

    if args.mode in ("overhead", "both"):
        total = args.rollouts_per_device * sizes[-1] - 2
        overhead = [overhead_row(n, total, args, device) for n in sizes if (total + 2) % n == 0]
        for row in overhead:
            row["sharding_efficiency_same_work"] = round(row["solves_per_s"] / overhead[0]["solves_per_s"], 3)
            print(json.dumps(row), flush=True)
        results["overhead"] = overhead

    if args.mode == "collectives":
        even = [n for n in sizes if n > 1 and n % 2 == 0]
        rows = [row for n in sizes if n > 1 for row in collective_rows(n, args, bool(even) and n == max(even))]
        for row in rows:
            print(json.dumps(row), flush=True)
        results["collectives_fused"] = rows
        results["collectives_note"] = (
            "counted on the ranks: every torch.distributed collective one update calls, with the bytes of the "
            "tensors it gathers or broadcasts"
        )

    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as handle:
            json.dump(results, handle, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
