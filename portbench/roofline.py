"""The chip's published peaks and the work of the kernels whose roofline
share the benchmark reports, counted from the shapes the configuration
states. A frozen copy: the program's own constants may change without
moving this yardstick.

Peaks: one NVIDIA H100 SXM at its full 700 W (NVIDIA's data sheet, dense
rates): 67 TFLOP/s in float32 outside the tensor cores, 3.35 TB/s of HBM.

Kernel 1 (``pair_sample_rollout_kernel<false>``, the fused sample and
rollout) per launch: ``R x S x STEP_FLOPS`` operations, the algorithm's
count of one rollout-step of the Franka-Ridgeback step and its seven cost
terms (4,892, counted by walking the JAX step's jaxpr, the port's
``STEP_FLOPS`` at commit 761f38a); bytes: each input read once and each
output written once: the 32-float initial state, the (S, 32) table, 3
int32 of meta, the stored and the fresh (S, 12, R) float32 noise, R keep
flags of one byte; the (S, 12, R) assembled noise, the (R, 2) costs and the
(S, 24) rollout-0 states."""

FP32_PEAK_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12
STEP_FLOPS = 4892
F32 = 4


def kernel1_flops(rollouts: int, steps: int) -> float:
    return float(rollouts) * steps * STEP_FLOPS


def kernel1_bytes(rollouts: int, steps: int) -> float:
    inputs = 32 * F32 + steps * 32 * F32 + 3 * 4 + 2 * steps * 12 * rollouts * F32 + rollouts
    outputs = steps * 12 * rollouts * F32 + rollouts * 2 * F32 + steps * 24 * F32
    return float(inputs + outputs)


def least_seconds(flops: float, bytes_moved: float) -> float:
    """The least time the chip could take: the larger of the two bounds."""
    return max(flops / FP32_PEAK_FLOPS, bytes_moved / HBM_BYTES_PER_S)
