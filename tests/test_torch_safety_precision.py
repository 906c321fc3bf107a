"""The port's safety filter at float32 against float64, on the CPU
(scripts/torch_safety_precision.py): the four binding cases of
tests/test_torch_safety.py and the default filter (all four limits) on each
of their inputs.

Per case, the float32 filter's control and the float64 filter's, each
stepped through the float64 plant:
- every enabled limit's violation at float32 exceeds float64's by at most
  EXCESS_TOLERANCE x max(|bound|, float64 violation, 1) (measured: at most
  2.03e-6, the default filter on the huddled slam; float32 rounding of a
  control of ~85 N m through the acceleration rows);
- |u_float32 - u_float64| <= CONTROL_TOLERANCE x max(|u_float64|, 1)
  (measured: at most 1.30e-5, the default filter near the joint bound,
  where its four limits contradict each other and the QP moves the control
  by ~5,400).
The default-filter cases also hold the port's float64 filter to the JAX
package's (1e-8, as tests/test_torch_safety.py holds the binding cases):
the violations that float64 leaves there are the reference's own.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import scripts.torch_safety_precision as precision  # noqa: E402
from assistedmanipulation_tpu import safety as jax_safety  # noqa: E402
from assistedmanipulation_tpu_torch import safety  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401  (a module fixture)

EXCESS_TOLERANCE = 1e-5
CONTROL_TOLERANCE = 5e-5


@pytest.mark.parametrize("case", list(precision.binding_cases()))
def test_float32_filter_holds_its_limits_as_float64_does(case):
    options, x, u = precision.binding_cases()[case]
    line = precision.measure(options, x, u)
    for name, excess in line["excess_rel"].items():
        assert excess <= EXCESS_TOLERANCE, (case, name, line["violation"])
    assert line["control_max_rel_diff"] <= CONTROL_TOLERANCE, (case, line["control_max_rel_diff"])
    assert line["filter_move"] > 1e-4, "the filter does not move the control"
    if case.startswith("default/"):
        want = jax.jit(jax_safety.make_safety_filter(jax_safety.Configuration()))(
            jnp.asarray(x), jnp.asarray(u), 0.0)
        got = safety.make_safety_filter(safety.Configuration())(torch.tensor(x), torch.tensor(u), 0.0)
        want = np.asarray(want)
        assert (np.abs(got.numpy() - want) <= 1e-8 * np.maximum(np.abs(want), 1.0)).all(), case
