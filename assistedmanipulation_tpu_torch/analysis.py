"""Offline analysis of experiment runs (reference src/analysis.py; the
port's own copy of assistedmanipulation_tpu/analysis.py, plain NumPy).

Reads the CSV tree a harness run writes (the reference schema) and produces
every figure class the reference analysis script can draw:

- per-run plots (analysis.py:128-348): reference error (error.png),
  overview panel (overview.png: optimal cost / observed force / tank
  energy / reference error), per-channel control timeseries (control.png),
  per-joint position timeseries (joints.png), the MPPI optimal rollout per
  control channel (optimal_rollout.png), and per-term objective costs
  (objective.png);
- multi-run comparison plots (analysis.py:350-437): user force magnitude,
  reference error, and end-effector velocity magnitude over time across
  runs, plus the pid force/reference summary text files
  (analysis.py:485-504);
- the summary bar chart (analysis.py:439-474) from measured data instead of
  hard-coded constants.

The metrics (``Run.summary``, ``analyse_single(plot=False)``,
``analyse_multiple(plot=False)``) need NumPy alone. Drawing imports
matplotlib when asked; without it, a plot raises ImportError.

CLI (``--no-plot`` prints the metrics and draws nothing):
  python -m assistedmanipulation_tpu_torch.analysis single [--no-plot] <run_folder>
  python -m assistedmanipulation_tpu_torch.analysis multiple [--no-plot] <run_folder>...
  python -m assistedmanipulation_tpu_torch.analysis barchart <experiments.json> <out.png>
  python -m assistedmanipulation_tpu_torch.analysis animate <run_folder> [out.gif]
  python -m assistedmanipulation_tpu_torch.analysis watch <run_folder> [live.png]
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
from typing import Optional

import numpy as np

# Column -> unit for the control timeseries (analysis.py:276-294).
CONTROL_UNITS = {
    "vx": "m/s",
    "vy": "m/s",
    "rotation": "rad/s",
    **{f"tau{i}": "Nm" for i in range(1, 8)},
    "gripper_x": "m",
    "gripper_y": "m",
}

JOINT_UNITS = {
    "x": "m",
    "y": "m",
    "yaw": "rad",
    **{f"arm{i}": "rad" for i in range(1, 8)},
    "gripper_x": "m",
    "gripper_y": "m",
}


def _read_csv(path: str):
    """Minimal CSV reader -> dict of column arrays (no pandas dependency on
    the hot path; pandas is available if plotting is requested)."""
    with open(path) as handle:
        header = handle.readline().strip().split(",")
        rows = [line.strip().split(",") for line in handle if line.strip()]
    if not rows:
        return {name: np.zeros(0) for name in header}
    data = np.asarray(rows, dtype=np.float64)
    return {name: data[:, i] for i, name in enumerate(header)}


def _norm_over_time(table: dict) -> tuple[np.ndarray, np.ndarray]:
    """(time, row-wise L2 norm of all non-time columns) — the reference's
    plot_time_norm (analysis.py:148-157)."""
    keys = [k for k in table if k not in ("time", "update", "update_time")]
    stacked = np.stack([table[k] for k in keys], axis=-1)
    return table["time"], np.linalg.norm(stacked, axis=-1)


@dataclasses.dataclass
class Run:
    """Dataclass mirror of one run's CSV tree (analysis.py:15-126)."""

    folder: str
    name: str = ""
    joints: Optional[dict] = None
    control: Optional[dict] = None
    ee_position: Optional[dict] = None
    ee_angular_velocity: Optional[dict] = None
    tank_energy: Optional[dict] = None
    power: Optional[dict] = None
    optimal_cost: Optional[dict] = None
    optimal_rollout: Optional[dict] = None
    update: Optional[dict] = None
    objective: Optional[dict] = None
    pid_control: Optional[dict] = None
    pid_error: Optional[dict] = None
    pid_reference: Optional[dict] = None
    ee_orientation: Optional[dict] = None
    torque_reference: Optional[dict] = None

    @classmethod
    def load(cls, folder: str) -> "Run":
        def maybe(*parts):
            path = os.path.join(folder, *parts)
            return _read_csv(path) if os.path.exists(path) else None

        # "20240101120000_circle" -> "Circle" (analysis.py:114-116).
        stem = os.path.basename(os.path.normpath(folder))
        parts = stem.split("_")[1:] or [stem]
        name = " ".join(parts)
        name = name[:1].upper() + name[1:] if name else stem

        return cls(
            folder=folder,
            name=name,
            joints=maybe("dynamics", "joints.csv"),
            control=maybe("dynamics", "control.csv"),
            ee_position=maybe("dynamics", "end_effector_position.csv"),
            ee_angular_velocity=maybe(
                "dynamics", "end_effector_angular_velocity.csv"
            ),
            tank_energy=maybe("dynamics", "tank_energy.csv"),
            power=maybe("dynamics", "power.csv"),
            optimal_cost=maybe("mppi", "optimal_cost.csv"),
            optimal_rollout=maybe("mppi", "optimal_rollout.csv"),
            update=maybe("mppi", "update.csv"),
            objective=maybe("objective", "costs.csv"),
            pid_control=maybe("pid", "force", "control.csv"),
            pid_error=maybe("pid", "force", "error.csv"),
            pid_reference=maybe("pid", "force", "reference.csv"),
            ee_orientation=maybe("dynamics", "end_effector_orientation.csv"),
            torque_reference=maybe("pid", "torque", "reference.csv"),
        )

    # -- metrics (analysis.py:350-504) ---------------------------------------

    def mean_user_force(self) -> Optional[float]:
        """Mean magnitude of the PID (human) force."""
        if self.pid_control is None:
            return None
        return float(_norm_over_time(self.pid_control)[1].mean())

    def tracking_rmse(self) -> Optional[float]:
        """RMSE between the end effector and the PID reference trajectory."""
        if self.pid_reference is None or self.ee_position is None:
            return None
        reference = np.stack(
            [self.pid_reference[k] for k in ("reference0", "reference1", "reference2")],
            axis=-1,
        )
        position = np.stack(
            [self.ee_position[k] for k in ("x", "y", "z")], axis=-1
        )
        n = min(len(reference), len(position))
        error = reference[:n] - position[:n]
        return float(np.sqrt(np.mean(np.sum(error**2, axis=-1))))

    def mean_solve_duration(self) -> Optional[float]:
        if self.update is None or len(self.update["update_duration"]) == 0:
            return None
        return float(self.update["update_duration"].mean())

    def summary(self) -> dict:
        return {
            "folder": self.folder,
            "mean_user_force_N": self.mean_user_force(),
            "tracking_rmse_m": self.tracking_rmse(),
            "mean_solve_duration_s": self.mean_solve_duration(),
            "final_tank_energy": (
                float(self.tank_energy["energy"][-1])
                if self.tank_energy is not None and len(self.tank_energy["energy"])
                else None
            ),
        }


# -- plot helpers (lazy matplotlib import; Agg backend) -----------------------


def _plt():
    try:
        import matplotlib
    except ImportError as error:
        raise ImportError(
            "drawing needs matplotlib, which is not installed; the metrics work without it "
            "(analyse_single(plot=False), analyse_multiple(plot=False), the CLI's --no-plot)"
        ) from error

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def plot_timeseries(table: dict, units: dict, out: str, y_scale: str = "min_max"):
    """One stacked subplot per column, the reference's generic timeseries
    panel (analysis.py:194-274): y_scale in {'around_zero', 'from_zero',
    'min_max'}."""
    plt = _plt()
    columns = [k for k in table if k not in ("time", "update", "update_time")]
    figure, all_axes = plt.subplots(
        len(columns), 1, figsize=(10, max(len(columns), 2)), layout="constrained"
    )
    if len(columns) == 1:
        all_axes = [all_axes]
    time = table["time"]
    for column, axes in zip(columns, all_axes):
        series = table[column]
        axes.plot(time, series)
        axes.grid(True, color="lightgrey")
        y_min, y_max = float(series.min()), float(series.max())
        if y_scale == "around_zero":
            limit = max(abs(y_min), abs(y_max), 0.05) * 1.1
            y_min, y_max = -limit, limit
        elif y_scale == "from_zero":
            y_min = 0.0
            if abs(y_max) < 1e-3:
                y_max = 1.0
        elif abs(y_max - y_min) < 1e-3:  # min_max
            y_min, y_max = y_min - 1.0, y_max + 1.0
        axes.set_ylim(y_min, y_max)
        axes.set_xlim(0.0, float(time.max()) if len(time) else 1.0)
        unit = units.get(column, "")
        axes.set_ylabel(
            f"{column.replace('_', ' ')}" + (f" [{unit}]" if unit else ""),
            fontsize=8,
        )
        if column != columns[-1]:
            axes.set_xticklabels([])
    all_axes[-1].set_xlabel("Time [s]")
    figure.savefig(out, dpi=120)
    plt.close(figure)
    return out


def plot_error(run: Run, out: str):
    """Reference error norm over time (analysis.py:313-336)."""
    if run.pid_error is None:
        return None
    plt = _plt()
    time, error = _norm_over_time(run.pid_error)
    figure = plt.figure(figsize=(8, 4), layout="tight")
    axis = figure.gca()
    axis.plot(time, error)
    axis.set_xlim(0.0, float(time.max()))
    axis.set_ylim(ymin=0.0)
    axis.set_title("Reference Error of User Model over Time")
    axis.set_xlabel("Time [s]")
    axis.set_ylabel("Error [m]")
    figure.savefig(out, dpi=120)
    plt.close(figure)
    return out


def plot_overview(run: Run, out: str):
    """The 4-panel 'useful' overview (analysis.py:183-192)."""
    plt = _plt()
    figure, axes = plt.subplots(4, 1, figsize=(10, 10), layout="constrained")
    axes[0].set_title("Optimal Cost")
    if run.optimal_cost is not None:
        axes[0].plot(run.optimal_cost["time"], run.optimal_cost["cost"])
        axes[0].set_yscale("symlog")
    axes[1].set_title("Observed End Effector Force [N]")
    if run.pid_control is not None:
        axes[1].plot(*_norm_over_time(run.pid_control))
    axes[2].set_title("Energy Tank Evolution [J]")
    if run.tank_energy is not None:
        axes[2].plot(run.tank_energy["time"], run.tank_energy["energy"])
    axes[3].set_title("Reference Position Error [m]")
    if run.pid_error is not None:
        axes[3].plot(*_norm_over_time(run.pid_error))
    axes[3].set_xlabel("Time [s]")
    figure.savefig(out, dpi=120)
    plt.close(figure)
    return out


def plot_objective(run: Run, out: str):
    """Per-term objective costs (analysis.py:296-311)."""
    if run.objective is None:
        return None
    return plot_timeseries(run.objective, {}, out, y_scale="from_zero")


def plot_optimal_rollout(run: Run, out: str):
    """Optimal control sequence per channel over updates — the repo analog
    of plotting mppi/optimal_rollout.csv (MppiResults, analysis.py:24-30)."""
    if run.optimal_rollout is None:
        return None
    return plot_timeseries(
        run.optimal_rollout,
        {f"control{i}": u for i, u in enumerate(CONTROL_UNITS.values())},
        out,
        y_scale="around_zero",
    )


def analyse_single(folder: str, plot: bool = True) -> dict:
    """Per-run summary + the full reference figure set (analysis.py:338-348)."""
    run = Run.load(folder)
    summary = run.summary()
    for key, value in summary.items():
        print(f"  {key}: {value}")

    if plot:
        try:
            wrote = [
                plot_error(run, os.path.join(folder, "error.png")),
                plot_overview(run, os.path.join(folder, "overview.png")),
                run.control
                and plot_timeseries(
                    run.control,
                    CONTROL_UNITS,
                    os.path.join(folder, "control.png"),
                    y_scale="around_zero",
                ),
                run.joints
                and plot_timeseries(
                    run.joints, JOINT_UNITS, os.path.join(folder, "joints.png")
                ),
                plot_objective(run, os.path.join(folder, "objective.png")),
                plot_optimal_rollout(
                    run, os.path.join(folder, "optimal_rollout.png")
                ),
            ]
            for path in wrote:
                if path:
                    print(f"  wrote {path}")
        except ImportError:
            raise
        except Exception as error:
            print(f"  plotting skipped: {error}")
    return summary


# -- multi-run comparisons (analysis.py:350-504) -------------------------------


def _plot_norm_multi(runs, table_attr: str, ylabel: str, out: str):
    plt = _plt()
    figure = plt.figure(figsize=(7, 4), layout="tight")
    axes = figure.gca()
    drew = False
    for run in runs:
        table = getattr(run, table_attr)
        if table is None:
            continue
        axes.plot(*_norm_over_time(table), label=run.name)
        drew = True
    if not drew:
        plt.close(figure)
        return None
    axes.grid()
    axes.set_ylim(ymin=0.0)
    axes.set_xlabel("Time [s]")
    axes.set_ylabel(ylabel)
    axes.legend()
    figure.savefig(out, dpi=120)
    plt.close(figure)
    return out


def analyse_multiple(folders, plot: bool = True) -> list:
    """Comparison table + the reference's multi-run figures and summary
    text files (analysis.py:350-504)."""
    runs = [Run.load(folder) for folder in folders]
    rows = [run.summary() for run in runs]
    width = max(len(os.path.basename(r["folder"])) for r in rows)
    print(
        f"{'run':<{width}}  {'force[N]':>10}  {'rmse[m]':>10}  {'solve[ms]':>10}"
    )
    for row in rows:
        force = row["mean_user_force_N"]
        rmse = row["tracking_rmse_m"]
        solve = row["mean_solve_duration_s"]
        print(
            f"{os.path.basename(row['folder']):<{width}}  "
            f"{force if force is None else f'{force:10.2f}'}  "
            f"{rmse if rmse is None else f'{rmse:10.4f}'}  "
            f"{solve if solve is None else f'{solve * 1e3:10.2f}'}"
        )

    parent = os.path.dirname(os.path.normpath(folders[0])) or "."
    stem = os.path.basename(os.path.normpath(parent)) or "runs"
    if plot:
        try:
            for path in (
                _plot_norm_multi(
                    runs,
                    "pid_control",
                    "Force [N]",
                    os.path.join(parent, f"{stem}_effort.png"),
                ),
                _plot_norm_multi(
                    runs,
                    "pid_error",
                    "User Trajectory Error [m]",
                    os.path.join(parent, f"{stem}_reference_error.png"),
                ),
                _plot_norm_multi(
                    runs,
                    "ee_angular_velocity",
                    "End-Effector Velocity [m/s]",
                    os.path.join(parent, f"{stem}_velocity.png"),
                ),
            ):
                if path:
                    print(f"wrote {path}")
        except ImportError:
            raise
        except Exception as error:
            print(f"plotting skipped: {error}")

    # Summary text files (analysis.py:485-504).
    with open(os.path.join(parent, "pid_force_summary.txt"), "w") as handle:
        handle.write("name, mean, std, min, max\n")
        for run in runs:
            if run.pid_control is None:
                continue
            time, force = _norm_over_time(run.pid_control)
            force = force[time > 0.01]
            handle.write(
                f'"{run.name}", {force.mean()}, {force.std()}, '
                f"{force.min()}, {force.max()}\n"
            )
    with open(os.path.join(parent, "pid_reference_summary.txt"), "w") as handle:
        handle.write("name, rmse, mean, std, min, max\n")
        for run in runs:
            if run.pid_error is None:
                continue
            time, error = _norm_over_time(run.pid_error)
            error = error[time > 0.01]
            rmse = float(np.sqrt(np.square(error).mean()))
            handle.write(
                f'"{run.name}", {rmse}, {error.mean()}, {error.std()}, '
                f"{error.min()}, {error.max()}\n"
            )
    return rows


def animate(folder: str, out: str = None, fps: int = 20, stride: int = 10):
    """Scene animation from a run's CSV tree — the live-observability analog
    of the reference's RaiSim Unity rendering (simulator.cpp:37: every run
    launched a visualizer server; the target sphere + applied-force arrow
    visuals are external_wrench.cpp:160-166, trajectory playback visuals
    trajectory.cpp:127-141). Headless here: a matplotlib 3-D animation of

    - the full reference trajectory (the human's intent, faint),
    - the end-effector trace up to the current frame,
    - the current reference target marker,
    - the applied human-force arrow at the end effector (scaled),
    - the mobile base ground position from the joint states.

    Writes a GIF (PillowWriter — no ffmpeg dependency) next to the run
    folder unless ``out`` is given. ``stride`` subsamples sim ticks into
    frames (10 -> one frame per 50 ms at the 5 ms sim step)."""
    run = Run.load(folder)
    scene = _scene_data(run, folder)
    plt = _plt()
    from matplotlib import animation

    frames = np.arange(0, len(scene["time"]), max(1, stride))
    figure = plt.figure(figsize=(6, 6))
    ax = figure.add_subplot(projection="3d")

    def draw(k):
        _draw_scene(ax, scene, frames[k])

    mov = animation.FuncAnimation(figure, draw, frames=len(frames))
    out = out or os.path.join(folder, "scene.gif")
    mov.save(out, writer=animation.PillowWriter(fps=fps), dpi=70)
    plt.close(figure)
    return out


def _scene_data(run: "Run", folder: str) -> dict:
    """The scene tensors + fixed camera bounds for one run's CSV tree."""
    if run.ee_position is None:
        raise FileNotFoundError(
            f"{folder} has no dynamics/end_effector_position.csv"
        )
    time = run.ee_position["time"]
    ee = np.stack([run.ee_position[k] for k in ("x", "y", "z")], axis=-1)
    reference = force = None
    if run.pid_reference is not None:
        reference = np.stack(
            [run.pid_reference[f"reference{i}"] for i in range(3)], axis=-1
        )
    if run.pid_control is not None:
        cols = [k for k in run.pid_control if k.startswith("control")]
        force = np.stack(
            [run.pid_control[k] for k in cols[:3]], axis=-1
        )
    base = None
    if run.joints is not None:
        base = np.stack(
            [run.joints["x"], run.joints["y"], np.zeros_like(run.joints["x"])],
            axis=-1,
        )
    # Orientation triads (the slerp scenario): EE quaternion + the torque
    # PID's reference quaternion, both logged xyzw.
    ee_quat = ref_quat = None
    if run.ee_orientation is not None:
        ee_quat = np.stack(
            [run.ee_orientation[k] for k in ("x", "y", "z", "w")], axis=-1
        )
    if run.torque_reference is not None and len(run.torque_reference["time"]):
        ref_quat = np.stack(
            [run.torque_reference[f"reference{i}"] for i in range(4)], axis=-1
        )
    # Truncate to the shortest stream: a live (in-progress) run's CSVs can
    # disagree by a tick at the tail.
    n = min(
        len(a)
        for a in (time, ee, reference, force, base, ee_quat, ref_quat)
        if a is not None
    )
    time, ee = time[:n], ee[:n]
    reference = reference[:n] if reference is not None else None
    force = force[:n] if force is not None else None
    base = base[:n] if base is not None else None
    ee_quat = ee_quat[:n] if ee_quat is not None else None
    ref_quat = ref_quat[:n] if ref_quat is not None else None

    # Fixed bounds over the whole run so the camera doesn't swim.
    points = [ee] + [p for p in (reference, base) if p is not None]
    stacked = np.concatenate(points, axis=0)
    low, high = stacked.min(axis=0), stacked.max(axis=0)
    pad = 0.15 * np.maximum(high - low, 0.2)
    low, high = low - pad, high + pad
    force_scale = 0.0
    if force is not None:
        peak = np.linalg.norm(force, axis=-1).max()
        # Arrow length: peak force spans ~40% of the scene.
        force_scale = 0.4 * float((high - low).max()) / max(peak, 1e-9)
    return {
        "time": time,
        "ee": ee,
        "reference": reference,
        "force": force,
        "base": base,
        "ee_quat": ee_quat,
        "ref_quat": ref_quat,
        "triad_scale": 0.25 * float((high - low).max()),
        "low": low,
        "high": high,
        "force_scale": force_scale,
        "title": os.path.basename(os.path.normpath(folder)),
    }


def _quat_xyzw_axes(q: np.ndarray) -> np.ndarray:
    """Rotation-matrix columns (body x/y/z axes in world) from one xyzw
    quaternion."""
    x, y, z, w = q / max(np.linalg.norm(q), 1e-12)
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ]
    )


def _draw_scene(ax, scene: dict, i: int):
    """One scene frame (shared by animate / watch)."""
    ax.cla()
    ee = scene["ee"]
    reference = scene["reference"]
    base = scene["base"]
    force = scene["force"]
    if reference is not None:
        ax.plot(*reference.T, color="0.8", lw=1.0, label="reference")
        ax.scatter(*reference[i], color="tab:green", s=60, marker="o",
                   label="target")
    ax.plot(*ee[: i + 1].T, color="tab:blue", lw=1.5, label="end effector")
    ax.scatter(*ee[i], color="tab:blue", s=40)
    if base is not None:
        ax.scatter(*base[i], color="tab:gray", s=80, marker="s",
                   label="base")
        ax.plot(*np.stack([base[i], ee[i]]).T, color="0.6", lw=0.8)
    if force is not None:
        vector = force[i] * scene["force_scale"]
        ax.quiver(*ee[i], *vector, color="tab:red", lw=2,
                  label="human force")
    if scene.get("ref_quat") is not None and scene.get("ee_quat") is not None:
        # Orientation triads (slerp scenario): solid = EE body axes,
        # dashed/faint = the torque PID's reference orientation.
        scale = scene["triad_scale"]
        ee_axes = _quat_xyzw_axes(scene["ee_quat"][i]) * scale
        ref_axes = _quat_xyzw_axes(scene["ref_quat"][i]) * scale
        for k, color in enumerate(("tab:red", "tab:green", "tab:blue")):
            ax.quiver(*ee[i], *ee_axes[:, k], color=color, lw=1.5,
                      label="EE orientation" if k == 0 else None)
            ax.quiver(*ee[i], *ref_axes[:, k], color=color, lw=1.0,
                      alpha=0.35,
                      label="reference orientation" if k == 0 else None)
    ax.set_xlim(scene["low"][0], scene["high"][0])
    ax.set_ylim(scene["low"][1], scene["high"][1])
    ax.set_zlim(scene["low"][2], scene["high"][2])
    ax.set_xlabel("x [m]")
    ax.set_ylabel("y [m]")
    ax.set_zlabel("z [m]")
    ax.set_title(f"{scene['title']}  t = {scene['time'][i]:.2f} s")
    ax.legend(loc="upper left", fontsize=8)


def watch(folder: str, out: str = None, interval: float = 0.5,
          iterations: int = None, show: bool = None):
    """LIVE observation of an in-progress run — the reference attaches a
    RaiSim Unity server to every running simulation (simulator.cpp:37);
    this is the headless-capable equivalent: poll the run folder's growing
    CSV tree and re-render the current scene frame every ``interval``
    seconds, to an interactive matplotlib window when a display exists
    (``show=True``) and always to ``<folder>/live.png``. Start a host-
    engine run (`--test circle --out runs`) in one terminal and
    ``analysis watch runs/circle_*/`` in another; stops when the run stops
    growing (two idle polls) or after ``iterations`` polls."""
    import time as walltime

    plt = _plt()
    if show is None:
        show = bool(os.environ.get("DISPLAY"))
    out = out or os.path.join(folder, "live.png")
    figure = plt.figure(figsize=(6, 6))
    ax = figure.add_subplot(projection="3d")
    if show:
        plt.ion()
        figure.show()
    last_len = -1
    idle = 0
    polls = 0
    written = 0
    while iterations is None or polls < iterations:
        polls += 1
        try:
            scene = _scene_data(Run.load(folder), folder)
        except (FileNotFoundError, KeyError, IndexError, ValueError):
            walltime.sleep(interval)  # CSVs not there / mid-write yet
            continue
        n = len(scene["time"])
        if n == 0:
            walltime.sleep(interval)
            continue
        if n == last_len:
            idle += 1
            if idle >= 2 and written:
                break  # run finished (nothing new for two polls)
        else:
            idle = 0
            last_len = n
            _draw_scene(ax, scene, n - 1)
            figure.savefig(out, dpi=70)
            written += 1
            if show:
                figure.canvas.draw_idle()
                figure.canvas.flush_events()
        walltime.sleep(interval)
    plt.close(figure)
    return out


def barchart(experiments_json: str, out: str, metric: str = "mean_force"):
    """Mean-user-force (or RMSE) bar chart by trajectory x strategy
    (analysis.py:439-474) — from measured experiments.json, not the
    reference's hard-coded constants."""
    plt = _plt()
    with open(experiments_json) as handle:
        payload = json.load(handle)
    results = payload["results"]
    names = list(results.keys())
    strategies = list(next(iter(results.values())).keys())
    x = np.arange(len(names))
    width = 0.8 / len(strategies)
    figure, ax = plt.subplots(layout="constrained")
    for i, strategy in enumerate(strategies):
        values = [results[name][strategy][metric] for name in names]
        rects = ax.bar(x + width * i, values, width, label=strategy)
        ax.bar_label(rects, padding=3, fmt="%.1f", fontsize=6)
    ax.set_ylabel(
        "Mean User Force [N]" if metric == "mean_force" else metric
    )
    ax.set_title("Mean User Effort by Trajectory and Wrench Forecast")
    ax.set_xticks(x + 0.4 - width / 2, [n.replace("_", " ") for n in names])
    ax.legend(loc="upper left")
    figure.savefig(out, dpi=120)
    plt.close(figure)
    print(f"wrote {out}")
    return out


def main(argv=None) -> int:
    argv = list(argv if argv is not None else sys.argv[1:])
    plot = "--no-plot" not in argv
    argv = [arg for arg in argv if arg != "--no-plot"]
    if len(argv) < 2 or argv[0] not in (
        "single", "multiple", "barchart", "animate", "watch"
    ):
        print(__doc__)
        return 1
    if argv[0] == "single":
        analyse_single(argv[1], plot=plot)
    elif argv[0] == "barchart":
        barchart(argv[1], argv[2] if len(argv) > 2 else "barchart.png")
    elif argv[0] == "animate":
        print(animate(argv[1], argv[2] if len(argv) > 2 else None))
    elif argv[0] == "watch":
        print(watch(argv[1], argv[2] if len(argv) > 2 else None))
    else:
        analyse_multiple(argv[1:], plot=plot)
    return 0


if __name__ == "__main__":
    sys.exit(main())
