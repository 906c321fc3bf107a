"""Cost constants (port of the part of assistedmanipulation_tpu/ops/costs.py
the planner needs)."""

# Barrier saturation cost: a saturated barrier counts one violation, and the
# planner composes violations * MAXIMUM_COST_DEFAULT + smooth.
MAXIMUM_COST_DEFAULT = 1e10
