"""The work of kernel 2 (``pair_rollout_kernel<C>``, the two-pass rollout
against C forecast scenarios in one launch) counted from the shapes the
configuration states, against ``portbench/roofline.py``'s peaks. A frozen
copy: the program's own constants may change without moving this
yardstick.

Operations per launch: ``R x S x (STEP_FLOPS + (C - 1) x
SCENARIO_FLOPS)``. ``STEP_FLOPS`` (4,892) is one rollout-step of the step
and its seven cost terms under one scenario (``roofline.py``). Each
further scenario runs the trajectory term and its accumulations again
(``add_trajectory_cost`` and the scenario loop of ``csrc/rollout.cu``),
counted by the JAX package's rule (one operation per add, multiply,
square root and absolute value; comparisons and selects none): the dot of
the end effector's velocity with the target (5), times 1/|target|^2 (1),
|target| (a dot, 5, and a square root, 1), the signed speed (1), its error
(a difference and an absolute value, 2), the quadratic (2), the position
cost and the add into the step's smooth cost (2), the manipulability term
(1) and the discounted accumulation (2): 23.

Bytes per launch: each input read once and each output written once: the
32-float initial state, the (C, S, 8) tables, the (S, 12, R) float32
controls; the (C, R, 2) costs and the (S, 24) rollout-0 states."""

from portbench import roofline

SCENARIO_FLOPS = 23


def kernel2_flops(rollouts: int, steps: int, scenarios: int) -> float:
    return float(rollouts) * steps * (roofline.STEP_FLOPS + (scenarios - 1) * SCENARIO_FLOPS)


def kernel2_bytes(rollouts: int, steps: int, scenarios: int) -> float:
    F32 = roofline.F32
    inputs = 32 * F32 + scenarios * steps * 8 * F32 + steps * 12 * rollouts * F32
    outputs = scenarios * rollouts * 2 * F32 + steps * 24 * F32
    return float(inputs + outputs)
