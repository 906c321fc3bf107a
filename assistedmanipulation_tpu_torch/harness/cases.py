"""Scenario test cases (reference src/test/case/); port of
assistedmanipulation_tpu/harness/cases.py.

- ``base``: simulator + actor with the assisted-manipulation objective and
  the master DEFAULT_CONFIGURATION (base.hpp:61-196), full CSV logging.
- ``external_wrench``: adds the PID human model pulling the end effector
  toward a reference trajectory by applying wrench
  (external_wrench.cpp:168-234).
- ``circle`` / ``figure_eight`` / ``lissajous`` / ``rectangle`` / ``pose`` /
  ``slerp`` / ``lagrangian``: config patches over external_wrench
  (circle.hpp:37-58 et al.) — the experiment matrix.
- ``reach``: TrackPoint objective patch over base (reach.hpp:48-67).
- ``angles``: quaternion round-trip check (angles.hpp:27-35).
- ``trajectory``: trajectory generator playback to CSV (trajectory.cpp:
  144-169, headless).
- ``forecast``: the forecast unit checks (forecast.cpp:14-160).

Tests compose by patching other tests' defaults (DEFAULT_PATCH class attr),
the reference's merge-patch composition. JSON merge-patch cannot express
"disable the optional forecast" (pose.hpp:50-60), hence an explicit
``forecast.enabled`` flag.

Two engines: "host", the per-tick loop (``BaseTest.step``), and "episode",
the whole experiment as sim/episode.Episode on the device (one CUDA graph
per controller period on a CUDA device) with the CSV tree written after
the run.

Checkpoint/resume (host engine): ``checkpoint_interval > 0`` snapshots the
live state to ``<folder>/checkpoint.npz`` (checkpoint.py) every that many
simulated seconds, with each CSV's size; ``BaseTest.resume`` (the CLI's
``--resume``) truncates the CSV tree to the snapshot, deletes the CSVs made
after it, and continues the run.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from .. import config as cfg
from ..forecast import forecast as fc
from ..logging.csv_logger import (
    CSVWriter,
    DynamicsLogger,
    ForecastLogger,
    MPPILogger,
    ObjectiveLogger,
    PIDLogger,
)
from ..sim import pid as pid_module
from ..sim import trajectories
from ..sim.actor import Actor, Configuration as ActorConfiguration
from .runner import register_test


def _host(value) -> np.ndarray:
    """A tensor (or a tree of them, field by field) as float64 numpy: one
    device-to-host copy per field."""
    if isinstance(value, tuple):
        return type(value)(*(_host(field) for field in value))
    return value.detach().to(torch.float64).cpu().numpy()


@dataclasses.dataclass
class BaseConfiguration:
    """Master defaults (base.hpp:61-196): sim dt 0.005 s, duration 15 s,
    MPPI 50+2 rollouts / horizon 0.3 s / 20 Hz controller."""

    duration: float = 15.0
    time_step: float = 0.005
    # Checkpoint/resume: snapshot the full live state (plant, planner with
    # its key and elite noise, forecast filter, PID states, rate countdowns)
    # to <folder>/checkpoint.npz every this many SIMULATED seconds (0 =
    # disabled). ``--resume <run_folder>`` truncates the CSV tree to the
    # snapshot and continues the run bit-exactly. Host engine only.
    checkpoint_interval: float = 0.0
    # "host": per-tick loop, reference-faithful interleaving + live logging.
    # "episode": the whole experiment on the device (sim/episode.py), the
    # CSV tree written after the run.
    engine: str = "host"
    # Pace the host engine to wall clock at 1/time_step Hz — the harness
    # analog of the reference's raisim::TimedLoop (base.cpp:157). Unlike the
    # reference (which silently drops late ticks) overruns are COUNTED and
    # written to pacing.json in the run folder. Host engine only.
    realtime: bool = False
    actor: ActorConfiguration = dataclasses.field(default_factory=ActorConfiguration)


@register_test("base")
class BaseTest:
    """Canonical sim: actor + loggers, no external wrench (base.hpp:15)."""

    CONFIG_CLASS = BaseConfiguration
    DEFAULT_PATCH: dict = {}

    def __init__(self, folder: str, patch: dict = None, duration: float = None, device="cuda",
                 dtype=torch.float32):
        merged = cfg.merge_patch(dict(self.DEFAULT_PATCH), patch or {})
        self.configuration = cfg.patched(self.CONFIG_CLASS(), merged)
        if duration is not None:
            self.configuration.duration = duration
        self.folder = folder
        self.device = torch.device(device)

        self.actor = Actor(self.configuration.actor, self.configuration.time_step, dtype=dtype, device=self.device)
        planner = self.actor.planner
        # optimal_rollout_mode="batch" is accepted: the zero-noise rollout's
        # per-step states stream out of the batch, so optimal_rollout.csv and
        # optimal_cost.csv stay populated (one update of lag, documented at
        # mppi.Configuration.optimal_rollout_mode).
        self.mppi_logger = MPPILogger(
            os.path.join(folder, "mppi"), planner.rollout_count, planner.plant.control_dof, planner.steps
        )
        self.dynamics_logger = DynamicsLogger(os.path.join(folder, "dynamics"))
        self.forecast_logger = (
            ForecastLogger(os.path.join(folder, "forecast")) if self.actor.dynamics_forecast is not None else None
        )
        term_names = getattr(self.actor.objective, "TERM_NAMES", None)
        if term_names is None:
            term_names = ("point", "joint_limit", "self_collision", "reach")
        self.objective_logger = ObjectiveLogger(os.path.join(folder, "objective"), term_names)
        self.time = 0.0
        self._last_logged_forecast = -1.0
        self._start_tick = 0
        self.extra_setup(folder)

    def extra_setup(self, folder: str):
        pass

    def pre_step(self, time):
        """Subclass hook: runs before actor.act each tick."""

    def _time(self, time) -> torch.Tensor:
        return torch.tensor(time, dtype=self.actor.dtype, device=self.device)

    def step(self):
        """One sim tick (base.cpp:128-148): act, then log."""
        import time as walltime

        self.pre_step(self.time)
        start = walltime.perf_counter()
        self.actor.act(self.time)
        duration = walltime.perf_counter() - start

        planner_state = self.actor.planner_state
        if self.actor.last_update_info is not None:
            self.mppi_logger.log(
                int(planner_state.update_count),
                self.time,
                self.actor.last_update_info,
                planner_state.optimal_control,
                duration,
                self.actor.configuration.mppi.time_step,
            )
        self.dynamics_logger.log(self.time, self.actor.x, self.actor.aux, self.actor.control)
        if (
            self.forecast_logger is not None
            and self.actor.last_forecast_rollout is not None
            and float(self.actor.ctx.start_time) != self._last_logged_forecast
        ):
            self._last_logged_forecast = float(self.actor.ctx.start_time)
            self.forecast_logger.log(
                self._last_logged_forecast,
                self.actor.dynamics_forecast.configuration.time_step,
                self.actor.last_forecast_rollout,
            )
        terms = self.actor.objective.terms(
            self.actor.x, self.actor.control, self.actor.aux, self._time(self.time), self.actor.ctx
        )
        self.objective_logger.log(self.time, terms)
        self.time += self.configuration.time_step

    def run(self) -> bool:
        if self.configuration.engine == "episode":
            if self.configuration.realtime:
                raise ValueError(
                    "realtime pacing requires the host engine (the episode engine runs the whole "
                    "experiment on the device)"
                )
            return self._run_episode()
        import json as jsonlib
        import time as walltime

        ticks = int(self.configuration.duration / self.configuration.time_step)
        progress_every = max(1, ticks // 20)
        # Flush the CSV tree every ~1 s of WALL time so a live observer sees
        # the run grow instead of buffered-empty files.
        paced = self.configuration.realtime
        dt = self.configuration.time_step
        interval = self.configuration.checkpoint_interval
        next_checkpoint = self.time + interval if interval > 0 else float("inf")
        overruns = 0
        start_wall = walltime.perf_counter()
        next_deadline = start_wall + dt
        next_flush = start_wall + 1.0
        for i in range(self._start_tick, ticks):
            self.step()
            if self.time >= next_checkpoint - 1e-9:
                self.write_checkpoint(i + 1)
                next_checkpoint += interval
            if walltime.perf_counter() >= next_flush:
                self.flush_loggers()
                next_flush = walltime.perf_counter() + 1.0
            if paced:
                # TimedLoop semantics (base.cpp:157): sleep out the rest of
                # the slot; a late tick counts as an overrun and the clock
                # resynchronizes (the reference silently skips the wait).
                now = walltime.perf_counter()
                if now > next_deadline:
                    overruns += 1
                    next_deadline = now + dt
                else:
                    walltime.sleep(next_deadline - now)
                    next_deadline += dt
            if i % progress_every == 0:
                print(".", end="", flush=True)
        print()
        if paced:
            elapsed = walltime.perf_counter() - start_wall
            pacing = {
                "tick_hz": round(1.0 / dt, 1),
                "ticks": ticks,
                "overruns": overruns,
                "overrun_rate": round(overruns / max(1, ticks), 4),
                "wall_s": round(elapsed, 3),
                "simulated_s": round(ticks * dt, 3),
                "realtime_factor": round(ticks * dt / elapsed, 4),
            }
            with open(os.path.join(self.folder, "pacing.json"), "w") as f:
                jsonlib.dump(pacing, f, indent=1)
            print(
                f"realtime pacing: {pacing['overruns']}/{pacing['ticks']} "
                f"overruns at {pacing['tick_hz']} Hz "
                f"(realtime factor {pacing['realtime_factor']})"
            )
        return bool(torch.isfinite(self.actor.x).all())

    # --- checkpoint / resume ------------------------------------------------

    def _ctx_template(self):
        """A ForecastContext of the live one's structure, for restore (its
        shapes follow the forecast configuration)."""
        from ..objectives.assisted_manipulation import ForecastContext

        forecast = self.actor.dynamics_forecast.configuration
        like = dict(dtype=self.actor.dtype, device=self.device)
        return ForecastContext(
            wrench_horizon=torch.zeros((forecast.steps + 1, 6), **like),
            start_time=torch.zeros((), **like),
            time_step=forecast.time_step,
            horizon=forecast.horizon,
        )

    def _checkpoint_state(self, template: bool = False):
        """The live-state tree a checkpoint captures: plant state, the whole
        planner state (optimal control, elite noise, key, SG history),
        forecast filter state, rate countdowns. ``template=True`` builds
        the restore template from a fresh test."""
        actor = self.actor
        tree = {
            "x": actor.x,
            # aux is the PREVIOUS tick's pre-step aux (the plant step
            # returns the pre-step aux with that step's solved
            # accelerations), so it is saved, not recomputed from x.
            "aux": actor.aux,
            "planner_state": actor.planner_state,
            "control": actor.control,
            "trajectory_countdown": np.asarray(actor._trajectory_countdown),
            "forecast_countdown": np.asarray(actor._forecast_countdown),
        }
        if actor.wrench_forecast is not None:
            tree["forecast_state"] = actor.forecast_state
        if actor.dynamics_forecast is not None:
            tree["ctx"] = self._ctx_template() if template else actor.ctx
        return tree

    def _restore_state(self, tree, metadata):
        """The restored tree (on the actor's device, in its dtype, the
        planner's key on the host) into the actor; what a tick leaves
        pending (the wrench, the last forecast rollout) starts empty."""
        actor = self.actor
        actor.x = tree["x"]
        actor.aux = tree["aux"]
        actor.planner_state = tree["planner_state"]
        actor.control = tree["control"]
        actor._trajectory_countdown = int(tree["trajectory_countdown"])
        actor._forecast_countdown = int(tree["forecast_countdown"])
        actor._pending_wrench = torch.zeros(6, dtype=actor.dtype, device=actor.device)
        actor.last_forecast_rollout = None
        actor.last_update_info = None
        if "forecast_state" in tree:
            actor.forecast_state = tree["forecast_state"]
        if "ctx" in tree:
            # The planner reads time_step and horizon as Python floats.
            ctx = tree["ctx"]
            actor.ctx = ctx._replace(time_step=float(ctx.time_step), horizon=float(ctx.horizon))
        self.time = float(metadata["time"])
        self._start_tick = int(metadata["tick"])
        self.mppi_logger._last_update = metadata["mppi_last_update"]
        self._last_logged_forecast = metadata["last_logged_forecast"]

    def write_checkpoint(self, tick: int):
        """Flush the CSV tree and snapshot the live state with each CSV's
        size in bytes (resume truncates each CSV back to it)."""
        from .. import checkpoint as checkpoint_module

        self.flush_loggers()
        sizes = {}
        for dirpath, _, files in os.walk(self.folder):
            for name in files:
                if name.endswith(".csv"):
                    path = os.path.join(dirpath, name)
                    sizes[os.path.relpath(path, self.folder)] = os.path.getsize(path)
        checkpoint_module.save_checkpoint(
            os.path.join(self.folder, "checkpoint.npz"),
            self._checkpoint_state(),
            metadata={
                "test": type(self).TEST_NAME,
                "time": self.time,
                "tick": tick,
                "dtype": str(self.actor.dtype).removeprefix("torch."),
                "mppi_last_update": self.mppi_logger._last_update,
                "last_logged_forecast": self._last_logged_forecast,
                "file_sizes": sizes,
            },
        )

    @classmethod
    def resume(cls, run_folder: str, device="cuda"):
        """Rebuild this test over an existing run folder on ``device`` and
        continue from its checkpoint: each CSV the snapshot lists truncates
        to its size then, every other CSV under the folder (made after the
        snapshot) is deleted, and the loggers reopen in append mode, so the
        finished tree is the uninterrupted run's (apart from the
        host-measured update durations)."""
        import json as jsonlib

        from .. import checkpoint as checkpoint_module
        from ..logging import csv_logger

        path = os.path.join(run_folder, "checkpoint.npz")
        metadata = checkpoint_module.load_metadata(path)
        with open(os.path.join(run_folder, "configuration.json")) as handle:
            tree = jsonlib.load(handle)
        if tree.get("engine") == "episode":
            raise ValueError("resume requires the host engine")
        sizes = metadata["file_sizes"]
        for dirpath, _, files in os.walk(run_folder):
            for name in files:
                target = os.path.join(dirpath, name)
                rel = os.path.relpath(target, run_folder)
                if rel in sizes:
                    os.truncate(target, sizes[rel])
                elif name.endswith(".csv"):
                    os.remove(target)
        with csv_logger.append_mode():
            test = cls(folder=run_folder, patch=tree, device=device, dtype=getattr(torch, metadata["dtype"]))
        state = checkpoint_module.restore_checkpoint(path, test._checkpoint_state(template=True))
        test._restore_state(state, metadata)
        return test

    # --- episode engine: the experiment on the device, CSVs after the run --

    def _episode_human(self):
        """(trajectory, pid_configuration, wrench_enabled, orientation,
        torque_pid_configuration, torque_enabled) for the human model; base
        has none (base.hpp:15)."""
        return (trajectories.PointTrajectory(trajectories.PointConfiguration()), None, False, None, None, False)

    def _run_episode(self) -> bool:
        import time as walltime

        from ..sim.episode import Episode, EpisodeConfiguration

        acfg = self.configuration.actor
        (
            trajectory,
            pid_configuration,
            wrench_enabled,
            orientation_trajectory,
            torque_pid_configuration,
            torque_enabled,
        ) = self._episode_human()
        forecast_enabled = acfg.forecast is not None and acfg.forecast.enabled
        if forecast_enabled:
            strategy = fc.create(acfg.forecast.end_effector_wrench_forecast)
            forecast_cfg = acfg.forecast.configuration
            forecast_dt = forecast_cfg.time_step
            forecast_horizon = forecast_cfg.horizon
        else:
            # As the JAX harness: the Episode's default Kalman, with zero
            # wrench in and zero out when the human model is off.
            strategy = None
            forecast_dt, forecast_horizon = acfg.mppi.time_step, acfg.mppi.horizon

        episode = Episode(
            acfg.mppi,
            self.actor.objective,
            trajectory,
            EpisodeConfiguration(
                duration=self.configuration.duration,
                time_step=self.configuration.time_step,
                controller_rate=acfg.controller_rate,
                forecast_time_step=forecast_dt,
                forecast_horizon=forecast_horizon,
                wrench_enabled=wrench_enabled,
                torque_enabled=torque_enabled,
            ),
            wrench_strategy=strategy,
            robot_configuration=acfg.dynamics,
            pid_configuration=pid_configuration,
            dtype=self.actor.dtype,
            collect_logs=True,
            filter_fn=self.actor.planner.filter_fn,
            orientation_trajectory=orientation_trajectory,
            torque_pid_configuration=torque_pid_configuration,
            device=self.device,
        )
        start = walltime.perf_counter()
        outputs, logs = episode.run(seed=0)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        wall = walltime.perf_counter() - start
        simulated = episode.ticks * self.configuration.time_step
        mode = "captured, one CUDA graph per controller period" if episode.capture else "eager"
        print(
            f"episode: {episode.ticks} ticks in {wall:.3f}s on {self.device} ({mode}), "
            f"real-time factor {simulated / wall:.4f}"
        )
        self._write_episode_logs(episode, outputs, logs, wall)
        return bool(torch.isfinite(logs.x).all())

    def _write_episode_logs(self, episode, outputs, logs, wall):
        """The CSV tree from the run's device tensors: one batched
        derive_aux over the logged states and one batched objective
        evaluation over the update ticks, on the run's device, then one
        device-to-host copy per field."""
        from ..models import frankaridgeback as fr
        from ..objectives.assisted_manipulation import ForecastContext

        dt = self.configuration.time_step
        ticks = episode.ticks
        times = np.arange(ticks) * dt
        fired = logs.update_fired.cpu().numpy()
        update_ticks = np.flatnonzero(fired)
        mppi_dt = self.actor.configuration.mppi.time_step
        forecast_dt = episode.dynamics_forecast.configuration.time_step
        forecast_horizon = episode.dynamics_forecast.configuration.horizon

        aux = fr.derive_aux(episode.model, logs.x)
        update_index = torch.as_tensor(update_ticks, device=logs.x.device)
        # The update ticks' objective terms in one vmapped call; each update
        # reads its own forecast horizon.
        wrench = logs.forecast.wrench  # (U, H, 6)
        wrench_nodes = torch.cat([wrench, wrench[:, -1:]], dim=1)
        times_fired = torch.as_tensor(times[update_ticks], dtype=self.actor.dtype, device=logs.x.device)
        objective = self.actor.objective

        def terms(x, u, a, t, w):
            return objective.terms(x, u, a, t, ForecastContext(w, t, forecast_dt, forecast_horizon))

        aux_fired = type(aux)(*(
            type(field)(*(f[update_index] for f in field)) if isinstance(field, tuple) else field[update_index]
            for field in aux
        ))
        terms_all = torch.func.vmap(terms)(
            logs.x[update_index], outputs.control[update_index], aux_fired, times_fired, wrench_nodes
        )
        terms_all = {name: _host(value) for name, value in terms_all.items()}

        x_np = _host(logs.x)
        control_np = _host(outputs.control)

        class _Row:
            """Lightweight aux view: just the fields DynamicsLogger reads,
            pre-fetched as stacked host arrays (one transfer, not 3000)."""

            __slots__ = ("ee_position", "ee_orientation", "ee_linear_velocity", "ee_angular_velocity",
                         "ee_linear_acceleration", "ee_angular_acceleration", "joint_power")

        ee_pos = _host(aux.ee_position)
        ee_quat = _host(aux.ee_orientation)
        ee_lin = _host(aux.ee_linear_velocity)
        ee_ang = _host(aux.ee_angular_velocity)
        # Accelerations + joint power come from the run itself (they need
        # the solved qdd and applied torque, EpisodeLogs fields).
        ee_lin_acc = _host(logs.ee_linear_acceleration)
        ee_ang_acc = _host(logs.ee_angular_acceleration)
        joint_power = _host(logs.joint_power)
        for i in range(ticks):
            row = _Row()
            row.ee_position = ee_pos[i]
            row.ee_orientation = ee_quat[i]
            row.ee_linear_velocity = ee_lin[i]
            row.ee_angular_velocity = ee_ang[i]
            row.ee_linear_acceleration = ee_lin_acc[i]
            row.ee_angular_acceleration = ee_ang_acc[i]
            row.joint_power = float(joint_power[i])
            self.dynamics_logger.log(float(times[i]), x_np[i], row, control_np[i])

        mean_duration = wall / max(len(update_ticks), 1)
        info_np = _host(logs.update_info)
        optimal_np = _host(logs.optimal_control)
        forecast_np = _host(logs.forecast)
        for count, i in enumerate(update_ticks, start=1):
            t = float(times[i])
            info_row = type(info_np)(*(field[count - 1] for field in info_np))
            self.mppi_logger.log(count, t, info_row, optimal_np[count - 1], mean_duration, mppi_dt)
            if self.forecast_logger is not None:
                roll_row = type(forecast_np)(*(field[count - 1] for field in forecast_np))
                self.forecast_logger.log(t, forecast_dt, roll_row)
            self.objective_logger.log(t, {k: v[count - 1] for k, v in terms_all.items()})
        self._log_episode_extras(times, logs)

    def _log_episode_extras(self, times, logs):
        """Subclass hook (the external-wrench family logs the PID here)."""

    def flush_loggers(self):
        """Push buffered CSV rows to disk mid-run (live observability)."""
        self.mppi_logger.flush()
        self.dynamics_logger.flush()
        if self.forecast_logger is not None:
            self.forecast_logger.flush()
        self.objective_logger.flush()
        pid_logger = getattr(self, "pid_logger", None)
        if pid_logger is not None:
            pid_logger.flush()
        torque_pid_logger = getattr(self, "torque_pid_logger", None)
        if torque_pid_logger is not None:
            torque_pid_logger.flush()

    def close(self):
        self.mppi_logger.close()
        self.dynamics_logger.close()
        if self.forecast_logger is not None:
            self.forecast_logger.close()
        self.objective_logger.close()


@dataclasses.dataclass
class ExternalWrenchConfiguration(BaseConfiguration):
    """base + the human model (external_wrench.hpp)."""

    position: trajectories.PositionConfiguration = dataclasses.field(
        default_factory=trajectories.PositionConfiguration
    )
    orientation: trajectories.OrientationConfiguration = None
    force_pid: pid_module.Configuration = dataclasses.field(default_factory=lambda: pid_module.HUMAN_POINT_CONTROL)
    # The torque PID exists whenever the case does (the reference constructs
    # it and its logger unconditionally, external_wrench.cpp:88-117) but
    # only drives the wrench torque channel when torque_enabled — the
    # reference's intended-but-dead path (external_wrench.cpp:214-221 is
    # commented out; QuaternionPID::update is empty, pid.cpp:122-125). The
    # default preserves the reference's zero-torque behavior.
    torque_pid: pid_module.Configuration = dataclasses.field(
        default_factory=lambda: pid_module.HUMAN_ORIENTATION_CONTROL
    )
    torque_enabled: bool = False


@register_test("external_wrench")
class ExternalWrenchTest(BaseTest):
    """PID human model applies wrench toward a reference trajectory
    (external_wrench.cpp:168-234)."""

    CONFIG_CLASS = ExternalWrenchConfiguration

    def extra_setup(self, folder: str):
        configuration = self.configuration
        dtype = self.actor.dtype
        self.position = trajectories.create_position(configuration.position)
        self.orientation = (
            trajectories.create_orientation(configuration.orientation)
            if configuration.orientation is not None
            else None
        )
        self.force_pid = pid_module.PID(configuration.force_pid)
        self.force_pid_state = self.force_pid.init(dtype, self.device)
        self.pid_logger = PIDLogger(os.path.join(folder, "pid", "force"), configuration.force_pid.n)
        # Constructed unconditionally like the reference
        # (external_wrench.cpp:88-117): the torque logger exists (header-only
        # CSVs) even when the torque path never fires.
        self.torque_pid = pid_module.QuaternionPID(configuration.torque_pid)
        self.torque_pid_state = self.torque_pid.init(dtype, self.device)
        self.torque_pid_logger = PIDLogger(
            os.path.join(folder, "pid", "torque"), configuration.torque_pid.n, reference_n=4
        )

    def pre_step(self, time):
        """Human wrench = PID(reference(t) - ee_position)
        (external_wrench.cpp:185-231). The orientation/torque path is
        commented out in the reference and stays off by default; with
        ``torque_enabled`` the quaternion PID drives the torque channel
        toward the orientation trajectory (the intended semantics of
        external_wrench.cpp:214-221)."""
        dtype = self.actor.dtype
        t = self._time(time)
        reference = self.position.position(torch.tensor(float(time), dtype=torch.float64, device=self.device))
        self.force_pid_state = self.force_pid.set_reference(self.force_pid_state, reference)
        self.force_pid_state = self.force_pid.update(self.force_pid_state, self.actor.aux.ee_position.to(dtype), t)
        self.pid_logger.log(time, self.force_pid_state)

        torque = torch.zeros(3, dtype=dtype, device=self.device)
        if self.orientation is not None and self.configuration.torque_enabled:
            reference_quat = self.orientation.orientation(
                torch.tensor(float(time), dtype=torch.float64, device=self.device)
            ).to(dtype)
            self.torque_pid_state = self.torque_pid.update_quaternion(
                self.torque_pid_state, self.actor.aux.ee_orientation.to(dtype), reference_quat, t
            )
            torque = self.torque_pid_state.control
            # Log with the quaternion reference in xyzw (reference_dof=4,
            # external_wrench.cpp:105-110; Eigen coeffs order like
            # dynamics/end_effector_orientation.csv).
            self.torque_pid_logger.log(
                time, self.torque_pid_state._replace(reference=reference_quat[[1, 2, 3, 0]])
            )

        wrench = torch.cat([self.force_pid_state.control.to(dtype), torque])
        self.actor.add_end_effector_wrench(wrench, time)

    def _checkpoint_state(self, template: bool = False):
        tree = super()._checkpoint_state(template)
        tree["force_pid_state"] = self.force_pid_state
        tree["torque_pid_state"] = self.torque_pid_state
        return tree

    def _restore_state(self, tree, metadata):
        super()._restore_state(tree, metadata)
        self.force_pid_state = tree["force_pid_state"]
        self.torque_pid_state = tree["torque_pid_state"]

    def _episode_human(self):
        return (
            self.position,
            self.configuration.force_pid,
            True,
            self.orientation,
            self.configuration.torque_pid,
            self.configuration.torque_enabled,
        )

    def _log_episode_extras(self, times, logs):
        pid_np = _host(logs.pid)

        class _Row:
            __slots__ = ("reference", "last_error", "cumulative_error", "saturation", "control")

        for i in range(len(times)):
            row = _Row()
            row.reference = pid_np.reference[i]
            row.last_error = pid_np.last_error[i]
            row.cumulative_error = pid_np.cumulative_error[i]
            row.saturation = pid_np.saturation[i]
            row.control = pid_np.control[i]
            self.pid_logger.log(float(times[i]), row)

        if self.orientation is not None and self.configuration.torque_enabled:
            torque_np = _host(logs.torque_pid)
            quat_np = _host(logs.torque_reference)
            for i in range(len(times)):
                row = _Row()
                # wxyz -> xyzw for the CSV (Eigen coeffs order).
                q = quat_np[i]
                row.reference = np.array([q[1], q[2], q[3], q[0]])
                row.last_error = torque_np.last_error[i]
                row.cumulative_error = torque_np.cumulative_error[i]
                row.saturation = torque_np.saturation[i]
                row.control = torque_np.control[i]
                self.torque_pid_logger.log(float(times[i]), row)

    def close(self):
        super().close()
        self.pid_logger.close()
        self.torque_pid_logger.close()


# --- the experiment matrix: trajectory patches (circle.hpp:37-58 etc.) -------


@register_test("circle")
class CircleTest(ExternalWrenchTest):
    DEFAULT_PATCH = {"position": {"type": "circle"}}


@register_test("figure_eight")
class FigureEightTest(ExternalWrenchTest):
    DEFAULT_PATCH = {"position": {"type": "figure_eight"}}


@register_test("lissajous")
class LissajousTest(ExternalWrenchTest):
    DEFAULT_PATCH = {"position": {"type": "lissajous"}}


@register_test("rectangle")
class RectangleTest(ExternalWrenchTest):
    DEFAULT_PATCH = {"position": {"type": "rectangle"}}


@register_test("pose")
class PoseTest(ExternalWrenchTest):
    DEFAULT_PATCH = {"position": {"type": "point", "point": {"point": [1.0, 1.0, 1.0]}}}


@register_test("slerp")
class SlerpTest(ExternalWrenchTest):
    """Oscillating SLERP orientation trajectory + point position patched
    onto external_wrench — the reference's ``slerp`` CLI case
    (slerp.hpp:14-67; the generator is trajectory.cpp:289-325, t =
    (sin(t)+1)/2). The reference's torque path is dead code, so
    ``torque_enabled`` defaults to False for parity; True drives the wrench
    torque channel from the working quaternion PID."""

    DEFAULT_PATCH = {
        "position": {"type": "point", "point": {"point": [1.0, 1.0, 1.0]}},
        "orientation": {"type": "slerp"},
    }


@register_test("lagrangian")
class LagrangianTest(ExternalWrenchTest):
    """The alternative-dynamics-backend case — the reference's runnable
    pinocchio scenario (test/case/pinocchio.hpp:11-60): the PLANT steps on
    the autodiff Euler-Lagrange backend (models/lagrangian.py) while the
    MPPI rollouts keep the analytic CRBA/RNEA dynamics — the mixed
    plant/rollout configuration ActorDynamics::create selects
    (actor_dynamics.hpp:146-213). Same circle scenario as the experiment
    matrix so the CSV trees are directly comparable across backends."""

    DEFAULT_PATCH = {
        "position": {"type": "circle"},
        "actor": {"dynamics": {"dynamics_type": "lagrangian", "rollout_dynamics_type": "analytic"}},
    }


@register_test("reach")
class ReachTest(BaseTest):
    """TrackPoint objective patch over base (reach.hpp:48-67)."""

    DEFAULT_PATCH = {"actor": {"objective": {"type": "track_point"}, "forecast": {"enabled": False}}}


class _HostCase:
    """A case that runs on the host alone (no actor): the device is
    resolved by the suite and unused."""

    def __init__(self, folder: str, patch: dict = None, duration: float = None, device="cuda"):
        self.configuration = {}
        self.folder = folder
        self.duration = duration

    def close(self):
        pass


@register_test("trajectory")
class TrajectoryPlaybackTest(_HostCase):
    """Sample each trajectory generator to CSV (the reference renders them
    in the visualizer, trajectory.cpp:144-169; headless here)."""

    def __init__(self, folder: str, patch: dict = None, duration: float = None, device="cuda"):
        super().__init__(folder, patch, duration, device)
        self.duration = duration or 10.0
        self.configuration = {"duration": self.duration}

    def run(self) -> bool:
        cases = {
            "circle": trajectories.CircularTrajectory(trajectories.CircularConfiguration()),
            "rectangle": trajectories.RectangularTrajectory(trajectories.RectangularConfiguration()),
            "lissajous": trajectories.LissajousTrajectory(trajectories.LissajousConfiguration()),
            "figure_eight": trajectories.FigureEightTrajectory(trajectories.FigureEightConfiguration()),
        }
        times = np.arange(0.0, self.duration, 0.05)
        for name, trajectory in cases.items():
            writer = CSVWriter(os.path.join(self.folder, f"{name}.csv"), ["time", "x", "y", "z"])
            positions = trajectory.position(torch.as_tensor(times)).numpy()
            for t, p in zip(times, positions):
                writer.write(float(t), p)
            writer.close()
            if not np.isfinite(positions).all():
                return False
        return True


@register_test("forecast")
class ForecastTest(_HostCase):
    """The reference's forecast unit checks behind the CLI registry
    (forecast.cpp:14-160): LOCF carry-forward/expiry (forecast.cpp:23-60),
    the windowed-average golden sequence (forecast.cpp:62-101), and the
    order-1 Kalman linear-tracking run, logged to kalman.csv for offline
    inspection like the reference's visual check (forecast.cpp:103-160).
    On the CPU, in float64."""

    def run(self) -> bool:
        ok = True
        f64 = torch.float64

        def t(value):
            return torch.tensor(value, dtype=f64)

        # LOCF: carries the last observation until the validity horizon,
        # then zero (forecast.cpp:23-60).
        locf = fc.LOCFForecast(fc.LOCFConfiguration(horizon=0.3, states=3))
        state = locf.init(f64, "cpu")
        state = locf.update(state, np.array([1.0, 2.0, 3.0]), 1.0)
        ok &= np.allclose(locf.forecast(state, t(1.2)).numpy(), [1, 2, 3])
        ok &= np.allclose(locf.forecast(state, t(1.5)).numpy(), [0, 0, 0])

        # Average: the reference's exact golden sequence (forecast.cpp:62-101).
        avg = fc.AverageForecast(fc.AverageConfiguration(states=3, window=1.0, max_measurements=32))
        state = avg.init(f64, "cpu")
        ok &= np.allclose(avg.forecast(state, t(0.0)).numpy(), 0.0)
        state = avg.update(state, np.array([0.0, 1.0, 0.0]), 1.01)
        ok &= np.allclose(avg.forecast(state, t(5.0)).numpy(), [0, 1.0, 0])
        state = avg.update(state, np.array([0.0, 1.5, 0.0]), 1.5)
        ok &= np.allclose(avg.forecast(state, t(10.0)).numpy(), [0, 1.25, 0])
        state = avg.update(state, np.array([1.0, 1.0, 1.0]), 3.0)
        ok &= np.allclose(avg.forecast(state, t(3.0)).numpy(), [1, 1, 1])

        # Kalman order-1 on a linear signal, logged to CSV
        # (forecast.cpp:103-160): the forecast must extrapolate the slope.
        config = fc.KalmanForecastConfiguration(observed_states=6, order=1, time_step=0.01, horizon=0.3)
        kalman = fc.KalmanForecast(config)
        state = kalman.init(f64, "cpu")
        slope = np.array([2.0, -1.0, 0.5, 0.0, 0.0, 1.0])
        writer = CSVWriter(
            os.path.join(self.folder, "kalman.csv"),
            ["time"] + [f"measurement_{i}" for i in range(6)] + [f"forecast_{i}" for i in range(6)],
        )
        time = 0.0
        for i in range(50):
            time = i * 0.01
            state = kalman.update(state, slope * time, time)
            prediction = kalman.forecast(state, t(time + 0.2)).numpy()
            writer.write(time, slope * time, prediction)
        writer.close()
        ok &= np.allclose(kalman.forecast(state, t(time + 0.2)).numpy(), slope * (time + 0.2), atol=0.02)
        # Beyond the horizon: zero (forecast.cpp:348-350).
        ok &= np.allclose(kalman.forecast(state, t(time + 0.5)).numpy(), 0.0)
        return bool(ok)


@register_test("angles")
class AnglesTest(_HostCase):
    """Quaternion <-> ZXZ euler round trip (angles.hpp:27-35)."""

    def run(self) -> bool:
        from ..ops import rotations as rot

        x = torch.tensor([0.0, 0.0, np.pi / 8], dtype=torch.float64)
        q = rot.euler_zxz_to_quat(x)
        back = rot.quat_to_euler_zxz(q)
        q2 = rot.euler_zxz_to_quat(back)
        return bool(np.allclose(rot.quat_to_matrix(q).numpy(), rot.quat_to_matrix(q2).numpy(), atol=1e-5))
