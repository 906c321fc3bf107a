"""Savitzky-Golay smoothing as one linear map (ops/sg_filter.sg_apply):
the two matrix products against the step-by-step write-back it replaces
(``sg_apply_sequential``) and against the JAX package's ``sg_smooth``, for
every horizon shift, at float64.

Tolerances: float64, rtol 1e-12 and atol 1e-14 (as
tests/test_torch_mppi.py::test_sg_smooth_matches_jax): the map sums each
output in another order than the loop. At float32 the map is held to the
float64 loop within 1e-6 relative to the buffer's scale (measured 1.1e-7 at
50 steps, window 10, order 1).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from assistedmanipulation_tpu.ops import sg_filter as jax_sg
from assistedmanipulation_tpu_torch.ops import sg_filter
from torch_threads import one_torch_thread  # noqa: E402,F401  (a module fixture)

STEPS = 8
SMOOTHERS = [(10, 1), (3, 2)]  # (window, order): the flagship's, and a short quadratic one


def _filled(smoother, shift, seed):
    """A random history buffer, trimmed by ``shift`` and filled with random
    horizon controls, as sg_smooth does before it applies the filter."""
    rng = np.random.default_rng(seed)
    buffer = torch.tensor(rng.normal(size=(12, smoother.buffer_length)))
    controls = torch.tensor(rng.normal(size=(smoother.steps, 12)))
    trimmed = sg_filter.sg_trim(smoother, buffer, torch.tensor(shift))
    return buffer, controls, sg_filter.sg_fill_horizon(smoother, trimmed, controls)


@pytest.mark.parametrize("window,order", SMOOTHERS)
@pytest.mark.parametrize("shift", range(STEPS + 1))
def test_map_matches_sequential_and_jax(shift, window, order):
    smoother = sg_filter.SGSmoother(steps=STEPS, window=window, order=order)
    buffer, controls, filled = _filled(smoother, shift, seed=shift)
    got, got_buffer = sg_filter.sg_apply(smoother, filled)
    want, want_buffer = sg_filter.sg_apply_sequential(smoother, filled)
    assert got.shape == want.shape == (STEPS, 12) and got_buffer.shape == want_buffer.shape
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(got_buffer.numpy(), want_buffer.numpy(), rtol=1e-12, atol=1e-14)

    jax_smoother = jax_sg.SGSmoother(steps=STEPS, window=window, order=order)
    smoothed, new_buffer = sg_filter.sg_smooth(smoother, buffer, controls, torch.tensor(shift))
    jax_smoothed, jax_buffer = jax_sg.sg_smooth(
        jax_smoother, jnp.asarray(buffer.numpy()), jnp.asarray(controls.numpy()), jnp.asarray(shift)
    )
    np.testing.assert_allclose(smoothed.numpy(), np.asarray(jax_smoothed), rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(new_buffer.numpy(), np.asarray(jax_buffer), rtol=1e-12, atol=1e-14)


def test_maps_are_the_recurrence_on_the_identity():
    """Row j of each map is what the loop makes of a one in slot j (to the
    last bit but one: torch and numpy sum the window in other orders); the
    final-buffer map keeps the history slots before the horizon."""
    smoother = sg_filter.SGSmoother(steps=STEPS, window=10, order=1)
    filtered_map, final_map = sg_filter.sg_apply_maps(smoother)
    L = smoother.buffer_length
    assert filtered_map.shape == (L, STEPS) and final_map.shape == (L, L)
    for j in (0, 5, 10, L - 1):
        unit = torch.zeros((1, L), dtype=torch.float64)
        unit[0, j] = 1.0
        filtered, final = sg_filter.sg_apply_sequential(smoother, unit)
        np.testing.assert_allclose(filtered[:, 0].numpy(), filtered_map[j], rtol=1e-15, atol=1e-17)
        np.testing.assert_allclose(final[0].numpy(), final_map[j], rtol=1e-15, atol=1e-17)
    np.testing.assert_array_equal(final_map[:, :8], np.eye(L)[:, :8])  # slots before w - 1 untouched


def test_map_at_float32_and_launch_count():
    """At float32 within 1e-6 of the float64 loop (relative to the buffer's
    scale), from two matrix products whatever the horizon."""
    smoother = sg_filter.SGSmoother(steps=50, window=10, order=1)
    _, _, filled = _filled(smoother, 3, seed=7)
    want, want_buffer = sg_filter.sg_apply_sequential(smoother, filled)
    got, got_buffer = sg_filter.sg_apply(smoother, filled.float())
    scale = float(filled.abs().max())
    assert float((got.double() - want).abs().max()) <= 1e-6 * scale
    assert float((got_buffer.double() - want_buffer).abs().max()) <= 1e-6 * scale

    class Ops(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.names = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.names.append(func.__name__)
            return func(*args, **(kwargs or {}))

    sg_filter.sg_apply(smoother, filled)  # the float64 maps, made once
    with Ops() as ops:
        sg_filter.sg_apply(smoother, filled)
    products = [name for name in ops.names if name.startswith(("mm", "matmul", "addmm", "bmm", "mv"))]
    assert len(products) == 2, ops.names
    assert len(ops.names) == 3, ops.names  # the products and a transpose view
