"""CSV logging tree matching the reference schema (src/logging/); port of
assistedmanipulation_tpu/logging/csv_logger.py.

Every run writes the same directory layout as the reference so the analysis
tooling ports over:

- mppi/{costs,weights,gradient,optimal_rollout,optimal_cost,update}.csv
  (logging/mppi.cpp:23-63)
- dynamics/{joints,control,end_effector_position,end_effector_orientation,
  end_effector_linear_velocity,end_effector_angular_velocity,
  end_effector_linear_acceleration,end_effector_angular_acceleration,
  power,tank_energy}.csv (logging/frankaridgeback.cpp:12-84)
- forecast/* (logging/frankaridgeback.cpp:150-222): the same set prefixed
  with update_time, plus wrench.csv
- objective/*.csv per cost term (logging/assisted_manipulation.cpp)
- pid/{force,torque}/*.csv (logging/pid.cpp)

The writers buffer rows in memory and flush on close (or every
``flush_every`` rows) — the sim loop must not block on disk. This is the
JAX package's pure-Python writer path (its native writer writes the same
bytes). The loggers take tensors on any device (or numpy arrays): the
tensors of one row batch move to the host in one copy.
"""

from __future__ import annotations

import os
from typing import Iterable, Optional

import numpy as np
import torch


def _to_host(*values) -> list:
    """``values`` with every tensor among them as a float64 numpy array of
    its shape: the tensors move to the host in one copy. Other values are
    returned as they are."""
    tensors = [value for value in values if isinstance(value, torch.Tensor)]
    if not tensors:
        return list(values)
    flat = torch.cat([tensor.detach().reshape(-1).to(torch.float64) for tensor in tensors]).cpu().numpy()
    out, offset = [], 0
    for value in values:
        if isinstance(value, torch.Tensor):
            out.append(flat[offset : offset + value.numel()].reshape(value.shape))
            offset += value.numel()
        else:
            out.append(value)
    return out


def _flatten(values) -> list:
    flat = []
    for value in values:
        if isinstance(value, (list, tuple, np.ndarray)):
            flat.extend(np.asarray(value).reshape(-1).tolist())
        elif hasattr(value, "tolist"):  # tensors / numpy scalars
            item = value.tolist()
            if isinstance(item, list):
                flat.extend(
                    np.asarray(item).reshape(-1).tolist()
                )
            else:
                flat.append(item)
        else:
            flat.append(value)
    return flat


# Resume support: while True, CSVWriters open their files in APPEND mode
# without rewriting the header, so a restored run continues the existing
# CSV tree in place. Set via ``append_mode()`` around logger construction.
_APPEND_MODE = False


class append_mode:
    """Context manager: construct CSVWriters in append-to-existing mode."""

    def __enter__(self):
        global _APPEND_MODE
        self._previous = _APPEND_MODE
        _APPEND_MODE = True

    def __exit__(self, *exc):
        global _APPEND_MODE
        _APPEND_MODE = self._previous


class CSVWriter:
    """Buffered single-file CSV writer (logger::CSV, csv.hpp:23-177).

    Iterable values auto-expand into comma-separated columns
    (csv.hpp:99-173)."""

    def __init__(self, path: str, header: Iterable[str], flush_every: int = 256):
        os.makedirs(os.path.dirname(path), exist_ok=True)
        self.path = path
        header_line = ",".join(str(h) for h in _flatten(header))
        self._rows: list[str] = []
        self._flush_every = flush_every
        if _APPEND_MODE and os.path.exists(path):
            self._handle = open(path, "a", buffering=1 << 16)
        else:
            self._handle = open(path, "w", buffering=1 << 16)
            self._handle.write(header_line + "\n")

    def write(self, *values):
        row = _flatten(values)
        self._rows.append(",".join(repr(v) if isinstance(v, float) else str(v) for v in row))
        if len(self._rows) >= self._flush_every:
            self.flush()

    def flush(self):
        if self._rows:
            self._handle.write("\n".join(self._rows) + "\n")
            self._rows.clear()
        # Push through the 64 KiB file buffer too: live observers
        # (analysis.watch) read the tree while the run is in progress.
        self._handle.flush()

    def close(self):
        self.flush()
        self._handle.close()


def expanded_header(prefix: str, count: int) -> list[str]:
    """header expansion for vector columns (csv.hpp:50-56 style)."""
    return [f"{prefix}{i}" for i in range(count)]


class MPPILogger:
    """Per-update MPPI CSVs (logger::MPPI, logging/mppi.cpp:23-135)."""

    def __init__(self, folder: str, rollouts: int, control_dof: int, steps: int):
        self._costs = CSVWriter(
            os.path.join(folder, "costs.csv"),
            ["update", "time"] + expanded_header("cost", rollouts),
        )
        self._weights = CSVWriter(
            os.path.join(folder, "weights.csv"),
            ["update", "time"] + expanded_header("weight", rollouts),
        )
        self._gradient = CSVWriter(
            os.path.join(folder, "gradient.csv"),
            ["update", "time"] + expanded_header("gradient", control_dof),
        )
        self._optimal_rollout = CSVWriter(
            os.path.join(folder, "optimal_rollout.csv"),
            ["update", "time"] + expanded_header("control", control_dof),
        )
        self._optimal_cost = CSVWriter(
            os.path.join(folder, "optimal_cost.csv"), ["update", "time", "cost"]
        )
        self._update = CSVWriter(
            os.path.join(folder, "update.csv"),
            ["update", "time", "update_duration"],
        )
        self._steps = steps
        self._last_update = -1

    def log(self, update_count, time, info, optimal_control, update_duration, time_step):
        """Log one planner update (dedupe by update counter,
        logging/mppi.cpp:86-88)."""
        if update_count == self._last_update:
            return
        self._last_update = update_count
        costs, weights, gradient, optimal, optimal_cost = (
            np.asarray(value, dtype=np.float64)
            for value in _to_host(info.costs, info.weights, info.gradient, optimal_control, info.optimal_cost)
        )
        self._costs.write(update_count, time, costs)
        self._weights.write(update_count, time, weights)
        for step in range(self._steps):
            t = time + step * time_step
            self._gradient.write(update_count, t, gradient[step])
            self._optimal_rollout.write(update_count, t, optimal[step])
        self._optimal_cost.write(update_count, time, float(optimal_cost))
        self._update.write(update_count, time, float(update_duration))

    def flush(self):
        for writer in (
            self._costs,
            self._weights,
            self._gradient,
            self._optimal_rollout,
            self._optimal_cost,
            self._update,
        ):
            writer.flush()

    def close(self):
        for writer in (
            self._costs,
            self._weights,
            self._gradient,
            self._optimal_rollout,
            self._optimal_cost,
            self._update,
        ):
            writer.close()


class DynamicsLogger:
    """Plant-state CSVs (logger::FrankaRidgebackDynamics,
    logging/frankaridgeback.cpp:12-147)."""

    def __init__(self, folder: str):
        self._joints = CSVWriter(
            os.path.join(folder, "joints.csv"),
            ["time", "x", "y", "yaw"]
            + [f"arm{i}" for i in range(1, 8)]
            + ["gripper_x", "gripper_y"],
        )
        self._control = CSVWriter(
            os.path.join(folder, "control.csv"),
            ["time", "vx", "vy", "rotation"]
            + [f"tau{i}" for i in range(1, 8)]
            + ["gripper_x", "gripper_y"],
        )
        self._position = CSVWriter(
            os.path.join(folder, "end_effector_position.csv"),
            ["time", "x", "y", "z"],
        )
        self._orientation = CSVWriter(
            os.path.join(folder, "end_effector_orientation.csv"),
            ["time", "x", "y", "z", "w"],
        )
        self._linear_velocity = CSVWriter(
            os.path.join(folder, "end_effector_linear_velocity.csv"),
            ["time", "vx", "vy", "vz"],
        )
        self._angular_velocity = CSVWriter(
            os.path.join(folder, "end_effector_angular_velocity.csv"),
            ["time", "wx", "wy", "wz"],
        )
        self._linear_acceleration = CSVWriter(
            os.path.join(folder, "end_effector_linear_acceleration.csv"),
            ["time", "ax", "ay", "az"],
        )
        self._angular_acceleration = CSVWriter(
            os.path.join(folder, "end_effector_angular_acceleration.csv"),
            ["time", "alpha_x", "alpha_y", "alpha_z"],
        )
        self._power = CSVWriter(os.path.join(folder, "power.csv"), ["time", "power"])
        self._energy = CSVWriter(
            os.path.join(folder, "tank_energy.csv"), ["time", "energy"]
        )

    def log(self, time, x, aux, control, joint_power=None):
        if joint_power is None:
            joint_power = getattr(aux, "joint_power", 0.0)
        (
            x, control, position, q, linear_velocity, angular_velocity, linear_acceleration,
            angular_acceleration, joint_power,
        ) = (
            np.asarray(value, dtype=np.float64)
            for value in _to_host(
                x, control, aux.ee_position, aux.ee_orientation, aux.ee_linear_velocity,
                aux.ee_angular_velocity, aux.ee_linear_acceleration, aux.ee_angular_acceleration, joint_power,
            )
        )
        self._joints.write(time, x[:12])
        self._control.write(time, control)
        self._position.write(time, position)
        # Reference logs (x, y, z, w) Eigen order.
        self._orientation.write(time, [q[1], q[2], q[3], q[0]])
        self._linear_velocity.write(time, linear_velocity)
        self._angular_velocity.write(time, angular_velocity)
        self._linear_acceleration.write(time, linear_acceleration)
        self._angular_acceleration.write(time, angular_acceleration)
        self._power.write(time, float(joint_power))
        self._energy.write(time, float(x[30]))

    def flush(self):
        for writer in (
            self._joints,
            self._control,
            self._position,
            self._orientation,
            self._linear_velocity,
            self._angular_velocity,
            self._linear_acceleration,
            self._angular_acceleration,
            self._power,
            self._energy,
        ):
            writer.flush()

    def close(self):
        for writer in (
            self._joints,
            self._control,
            self._position,
            self._orientation,
            self._linear_velocity,
            self._angular_velocity,
            self._linear_acceleration,
            self._angular_acceleration,
            self._power,
            self._energy,
        ):
            writer.close()


class ForecastLogger:
    """Forecast-horizon CSVs (logger::FrankaRidgebackDynamicsForecast,
    logging/frankaridgeback.cpp:150-294): the reference's full stream set —
    joints, EE pose/velocity/acceleration, power, tank energy, wrench.

    Known reference quirk NOT copied (PARITY.md): the reference writes TWO
    rows per step into power.csv under one 'power' header (joint power then
    external power, logging/frankaridgeback.cpp:280-283); here they are two
    columns of one row."""

    def __init__(self, folder: str):
        self._joints = CSVWriter(
            os.path.join(folder, "joints.csv"),
            ["time", "x", "y", "yaw"]
            + [f"arm{i}" for i in range(1, 8)]
            + ["gripper_x", "gripper_y"],
        )
        self._position = CSVWriter(
            os.path.join(folder, "end_effector_position.csv"),
            ["update_time", "time", "x", "y", "z"],
        )
        self._orientation = CSVWriter(
            os.path.join(folder, "end_effector_orientation.csv"),
            ["update_time", "time", "x", "y", "z", "w"],
        )
        self._linear_velocity = CSVWriter(
            os.path.join(folder, "end_effector_linear_velocity.csv"),
            ["update_time", "time", "vx", "vy", "vz"],
        )
        self._angular_velocity = CSVWriter(
            os.path.join(folder, "end_effector_angular_velocity.csv"),
            ["update_time", "time", "wx", "wy", "wz"],
        )
        self._linear_acceleration = CSVWriter(
            os.path.join(folder, "end_effector_linear_acceleration.csv"),
            ["update_time", "time", "ax", "ay", "az"],
        )
        self._angular_acceleration = CSVWriter(
            os.path.join(folder, "end_effector_angular_acceleration.csv"),
            ["update_time", "time", "alpha_x", "alpha_y", "alpha_z"],
        )
        self._power = CSVWriter(
            os.path.join(folder, "power.csv"),
            ["update_time", "time", "joint_power", "external_power"],
        )
        self._wrench = CSVWriter(
            os.path.join(folder, "wrench.csv"),
            ["update_time", "time", "fx", "fy", "fz", "tau_x", "tau_y", "tau_z"],
        )
        self._energy = CSVWriter(
            os.path.join(folder, "tank_energy.csv"),
            ["update_time", "time", "energy"],
        )

    def log(self, update_time, time_step, rollout):
        (
            joints, positions, orientations, lin_vel, ang_vel, lin_acc, ang_acc, joint_power,
            external_power, energy, wrench,
        ) = (
            np.asarray(value, dtype=np.float64)
            for value in _to_host(
                rollout.joint_positions, rollout.ee_positions, rollout.ee_orientations,
                rollout.ee_linear_velocities, rollout.ee_angular_velocities, rollout.ee_linear_accelerations,
                rollout.ee_angular_accelerations, rollout.joint_power, rollout.external_power,
                rollout.energy, rollout.wrench,
            )
        )
        for step in range(positions.shape[0]):
            t = update_time + step * time_step
            self._joints.write(update_time, joints[step])
            self._position.write(update_time, t, positions[step])
            q = orientations[step]
            # Reference logs coeffs() = (x, y, z, w) Eigen order.
            self._orientation.write(update_time, t, [q[1], q[2], q[3], q[0]])
            self._linear_velocity.write(update_time, t, lin_vel[step])
            self._angular_velocity.write(update_time, t, ang_vel[step])
            self._linear_acceleration.write(update_time, t, lin_acc[step])
            self._angular_acceleration.write(update_time, t, ang_acc[step])
            self._power.write(
                update_time, t, float(joint_power[step]), float(external_power[step])
            )
            self._wrench.write(update_time, t, wrench[step])
            self._energy.write(update_time, t, float(energy[step]))

    def flush(self):
        for writer in (
            self._joints,
            self._position,
            self._orientation,
            self._linear_velocity,
            self._angular_velocity,
            self._linear_acceleration,
            self._angular_acceleration,
            self._power,
            self._wrench,
            self._energy,
        ):
            writer.flush()

    def close(self):
        for writer in (
            self._joints,
            self._position,
            self._orientation,
            self._linear_velocity,
            self._angular_velocity,
            self._linear_acceleration,
            self._angular_acceleration,
            self._power,
            self._wrench,
            self._energy,
        ):
            writer.close()


class ObjectiveLogger:
    """Per-term objective cost CSVs (logger::AssistedManipulation,
    logging/assisted_manipulation.cpp)."""

    def __init__(self, folder: str, term_names):
        self._writer = CSVWriter(
            os.path.join(folder, "costs.csv"),
            ["time"] + list(term_names) + ["total"],
        )
        self._terms = list(term_names)

    def log(self, time, terms: dict):
        values = [float(value) for value in _to_host(*(terms[name] for name in self._terms))]
        self._writer.write(time, values, sum(values))

    def flush(self):
        self._writer.flush()

    def close(self):
        self._writer.close()


class PIDLogger:
    """PID CSVs (logger::PID, logging/pid.cpp)."""

    def __init__(self, folder: str, n: int, reference_n: int = None):
        """``reference_n`` decouples the reference dof from the control dof —
        the torque PID logs a quaternion reference (reference_dof=4,
        control_dof=3, external_wrench.cpp:105-110)."""
        self._reference = CSVWriter(
            os.path.join(folder, "reference.csv"),
            ["time"] + expanded_header("reference", reference_n or n),
        )
        self._error = CSVWriter(
            os.path.join(folder, "error.csv"), ["time"] + expanded_header("error", n)
        )
        self._cumulative = CSVWriter(
            os.path.join(folder, "cumulative_error.csv"),
            ["time"] + expanded_header("cumulative_error", n),
        )
        self._saturation = CSVWriter(
            os.path.join(folder, "saturation.csv"),
            ["time"] + expanded_header("saturation", n),
        )
        self._control = CSVWriter(
            os.path.join(folder, "control.csv"),
            ["time"] + expanded_header("control", n),
        )

    def log(self, time, pid_state):
        reference, error, cumulative, saturation, control = (
            np.asarray(value, dtype=np.float64)
            for value in _to_host(
                pid_state.reference, pid_state.last_error, pid_state.cumulative_error,
                pid_state.saturation, pid_state.control,
            )
        )
        self._reference.write(time, reference)
        self._error.write(time, error)
        self._cumulative.write(time, cumulative)
        self._saturation.write(time, saturation)
        self._control.write(time, control)

    def flush(self):
        for writer in (
            self._reference,
            self._error,
            self._cumulative,
            self._saturation,
            self._control,
        ):
            writer.flush()

    def close(self):
        for writer in (
            self._reference,
            self._error,
            self._cumulative,
            self._saturation,
            self._control,
        ):
            writer.close()
