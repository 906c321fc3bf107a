"""Constants of the rigid-body dynamics (port of the part of
assistedmanipulation_tpu/models/dynamics.py the rollout needs)."""

# Regulariser of the implicit Coulomb friction coefficient
# c = friction / (|v| + FRICTION_EPS) + damping.
FRICTION_EPS = 1e-3
