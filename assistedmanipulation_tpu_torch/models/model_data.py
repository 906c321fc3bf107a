"""Robot model spec loader (port of assistedmanipulation_tpu/models/model_data.py).

Loads the JSON emitted by the JAX package's scripts/extract_model.py (a copy
ships beside this module) into host numpy arrays plus the static topology
masks the rollout math needs. The default model is the Franka-Ridgeback
12-joint chain. Everything here is a host constant: the plain rollout
unrolls over it and the CUDA kernel receives it as launch parameters.
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np

_HERE = os.path.dirname(__file__)
DEFAULT_MODEL_PATH = os.path.join(_HERE, "frankaridgeback_model.json")

PRISMATIC = 0
REVOLUTE = 1


@dataclasses.dataclass(frozen=True)
class RobotModel:
    """Static robot description (host numpy)."""

    name: str
    n_joints: int
    parent: np.ndarray  # (J,) int, -1 = world
    joint_type: np.ndarray  # (J,) int, PRISMATIC | REVOLUTE
    axis: np.ndarray  # (J, 3) joint axis in the joint frame
    rotation: np.ndarray  # (J, 3, 3) fixed rotation parent link -> joint frame
    translation: np.ndarray  # (J, 3) fixed translation parent link -> joint
    mass: np.ndarray  # (J,) composite link mass
    com: np.ndarray  # (J, 3) composite COM in the link frame
    inertia: np.ndarray  # (J, 3, 3) composite inertia about COM, link axes
    ancestor: np.ndarray  # (J, J) bool: ancestor[i, k] = joint i moves body k
    lower_limit: np.ndarray  # (J,) position limits (NaN where unlimited)
    upper_limit: np.ndarray
    effort_limit: np.ndarray
    velocity_limit: np.ndarray
    damping: np.ndarray  # (J,) URDF viscous joint damping
    friction: np.ndarray  # (J,) URDF Coulomb dry joint friction
    # Named fixed frames: name -> (parent moving link index, R (3,3), p (3,))
    frames: dict
    link_frames: dict
    end_effector_frame: str


def _frame_map(tree) -> dict:
    return {
        name: (
            int(entry["parent"]),
            np.array(entry["rotation"], dtype=np.float64),
            np.array(entry["translation"], dtype=np.float64),
        )
        for name, entry in tree.items()
    }


def load_model(path: str = DEFAULT_MODEL_PATH) -> RobotModel:
    with open(path) as handle:
        data = json.load(handle)

    joints = data["joints"]
    n = len(joints)
    parent = np.array([j["parent"] for j in joints], dtype=np.int32)

    limits = np.full((n, 4), np.nan)
    for i, j in enumerate(joints):
        if j.get("limit"):
            limits[i] = [
                j["limit"]["lower"],
                j["limit"]["upper"],
                j["limit"]["effort"],
                j["limit"]["velocity"],
            ]

    ancestor = np.zeros((n, n), dtype=bool)
    for k in range(n):
        node = k
        while node >= 0:
            ancestor[node, k] = True
            node = parent[node]

    return RobotModel(
        name=data["name"],
        n_joints=n,
        parent=parent,
        joint_type=np.array(
            [PRISMATIC if j["type"] == "prismatic" else REVOLUTE for j in joints],
            dtype=np.int32,
        ),
        axis=np.array([j["axis"] for j in joints], dtype=np.float64),
        rotation=np.array([j["rotation"] for j in joints], dtype=np.float64),
        translation=np.array([j["translation"] for j in joints], dtype=np.float64),
        mass=np.array([l["mass"] for l in data["links"]], dtype=np.float64),
        com=np.array([l["com"] for l in data["links"]], dtype=np.float64),
        inertia=np.array([l["inertia"] for l in data["links"]], dtype=np.float64),
        ancestor=ancestor,
        lower_limit=limits[:, 0],
        upper_limit=limits[:, 1],
        effort_limit=limits[:, 2],
        velocity_limit=limits[:, 3],
        damping=np.array([j.get("damping", 0.0) for j in joints], dtype=np.float64),
        friction=np.array([j.get("friction", 0.0) for j in joints], dtype=np.float64),
        frames=_frame_map(data["frames"]),
        link_frames=_frame_map(data["link_frames"]),
        end_effector_frame=data["end_effector_frame"],
    )


_cached_model = None


def frankaridgeback_model() -> RobotModel:
    global _cached_model
    if _cached_model is None:
        _cached_model = load_model()
    return _cached_model
