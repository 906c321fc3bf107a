"""``filter_qp_device_ms`` (ms per update): the port's device span
``filter.qp``: the safety filter's ADMM QP (ops/admm_qp.project_box_affine)
at each re-rollout step, summed over the steps; read from the updates
recorded without the profiler."""

from portbench import spans


def read(trace):
    return spans.device_ms("filter.qp")
