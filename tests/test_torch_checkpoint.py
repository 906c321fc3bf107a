"""The port's checkpoint module (assistedmanipulation_tpu_torch/
checkpoint.py) against the JAX package's, on the CPU.

- A point-mass planner's state saved after 3 updates and restored onto a
  fresh ``planner.init`` continues bitwise as the uninterrupted state does
  (the same optimal control, costs and key), at float64; the Kalman
  forecast state round-trips exactly.
- Restore follows the template: a float64 state restores onto a float32
  template as float32; a template on another device (``meta`` here, the
  card's stand-in) gets its tensors there, while the planner's key, on the
  host in the template, stays on the host; Python numbers come back as
  their type.
- A mismatch of structure or of shape raises.
- Both packages read each other's files: the JAX package's
  ``save_checkpoint`` of a dict of arrays restores here to the same
  values (and paths), and the port's file restores in the JAX package;
  so does the state of the average and LOCF wrench forecasts (what a
  harness run with one of them snapshots), the ring cursor an int32.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from assistedmanipulation_tpu import checkpoint as jax_checkpoint
from assistedmanipulation_tpu.forecast import forecast as jax_forecast
from assistedmanipulation_tpu_torch import checkpoint, interop, mppi
from assistedmanipulation_tpu_torch.forecast import forecast as forecast_module
from assistedmanipulation_tpu_torch.models import point_mass
from torch_threads import one_torch_thread  # noqa: E402,F401  (a module fixture)


def _planner(dtype="float64"):
    configuration = mppi.Configuration(
        rollouts=10, keep_best_rollouts=3, time_step=0.1, horizon=0.5, covariance=np.array([0.5, 0.4]),
        control_min=-np.ones(2), control_max=np.ones(2), smoothing=mppi.Smoothing(window=4, order=1), dtype=dtype,
    )
    return mppi.Planner(configuration, point_mass.make_point_mass_plant(point_mass.PointMassConfig()), device="cpu")


def _run(planner, state, times):
    x0 = torch.zeros(4, dtype=planner.dtype)
    for time in times:
        state, _ = planner.update(state, x0, time)
    return state


def test_planner_state_roundtrip(tmp_path):
    planner = _planner()
    state = _run(planner, planner.init(seed=7), (0.0, 0.1, 0.2))
    path = str(tmp_path / "planner.ckpt.npz")
    checkpoint.save_checkpoint(path, state, metadata={"update_count": int(state.update_count)})
    assert checkpoint.load_metadata(path)["update_count"] == 3
    assert not (tmp_path / "planner.ckpt.npz.tmp").exists()

    resumed = checkpoint.restore_checkpoint(path, planner.init(seed=0))
    assert type(resumed) is mppi.PlannerState
    for name in state._fields:
        assert torch.equal(getattr(resumed, name).nan_to_num(), getattr(state, name).nan_to_num()), name

    # Continue both: identical continuation, bitwise.
    a, b = _run(planner, state, (0.3, 0.4)), _run(planner, resumed, (0.3, 0.4))
    for name in ("optimal_control", "costs", "noise", "rng", "sg_buffer"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name


def test_forecast_state_roundtrip(tmp_path):
    forecast = forecast_module.create(
        forecast_module.Configuration(
            type="kalman", kalman=forecast_module.KalmanForecastConfiguration(order=1, time_step=0.1, horizon=1.0)
        )
    )
    state = forecast.init(torch.float64, "cpu")
    for k in range(5):
        state = forecast.update(state, torch.full((6,), float(k), dtype=torch.float64), 0.1 * k)
    path = str(tmp_path / "forecast.ckpt.npz")
    checkpoint.save_checkpoint(path, state)
    resumed = checkpoint.restore_checkpoint(path, forecast.init(torch.float64, "cpu"))
    t = torch.tensor(0.6, dtype=torch.float64)
    assert torch.equal(forecast.forecast(state, t), forecast.forecast(resumed, t))


def test_restore_follows_the_template_dtype_device_and_type(tmp_path):
    planner = _planner()
    state = _run(planner, planner.init(seed=3), (0.0, 0.1))
    path = str(tmp_path / "state.npz")
    checkpoint.save_checkpoint(path, {"planner": state, "tick": 20, "time": 0.1, "flag": True})

    template32 = _planner("float32").init()
    restored = checkpoint.restore_checkpoint(path, {"planner": template32, "tick": 0, "time": 0.0, "flag": False})
    assert restored["planner"].optimal_control.dtype == torch.float32
    assert restored["planner"].update_count.dtype == torch.int32
    assert torch.equal(restored["planner"].optimal_control, state.optimal_control.float())
    assert (restored["tick"], restored["time"], restored["flag"]) == (20, 0.1, True)
    assert [type(restored[k]) for k in ("tick", "time", "flag")] == [int, float, bool]

    on_meta = template32._replace(**{
        name: getattr(template32, name).to("meta") for name in template32._fields if name != "rng"
    })
    restored = checkpoint.restore_checkpoint(path, {"planner": on_meta, "tick": 0, "time": 0.0, "flag": False})
    for name in on_meta._fields:
        want = "cpu" if name == "rng" else "meta"
        assert getattr(restored["planner"], name).device.type == want, name
    assert torch.equal(restored["planner"].rng, state.rng)


def test_structure_and_shape_mismatch_raise(tmp_path):
    planner = _planner()
    path = str(tmp_path / "bad.ckpt.npz")
    checkpoint.save_checkpoint(path, planner.init(seed=0))
    with pytest.raises(ValueError, match="structure"):
        checkpoint.restore_checkpoint(path, {"something": torch.zeros(3)})
    longer = mppi.Planner(
        mppi.Configuration(**{**_planner().configuration.__dict__, "horizon": 0.7}),
        point_mass.make_point_mass_plant(point_mass.PointMassConfig()), device="cpu",
    )
    with pytest.raises(ValueError, match="shape"):
        checkpoint.restore_checkpoint(path, longer.init())
    with pytest.raises(TypeError, match="not a tensor"):
        checkpoint.save_checkpoint(path, {"planner": planner})


def _tree():
    rng = np.random.default_rng(0)
    return {
        "x": rng.standard_normal((3, 4)).astype(np.float32),
        "nested": {"count": np.int32(7) * np.ones(2, np.int32), "time": rng.standard_normal(())},
        "list": [rng.standard_normal(5), np.arange(3, dtype=np.int64)],
    }


def test_files_cross_between_the_packages(tmp_path):
    tree = _tree()
    jax_path = str(tmp_path / "jax.npz")
    jax_checkpoint.save_checkpoint(jax_path, {k: jnp.asarray(v) if k == "x" else v for k, v in tree.items()},
                                   metadata={"tick": 5})
    template = {
        "x": torch.zeros((3, 4)),
        "nested": {"count": torch.zeros(2, dtype=torch.int32), "time": torch.zeros((), dtype=torch.float64)},
        "list": [torch.zeros(5, dtype=torch.float64), torch.zeros(3, dtype=torch.int64)],
    }
    restored = checkpoint.restore_checkpoint(jax_path, template)
    assert checkpoint.load_metadata(jax_path) == {"tick": 5}
    np.testing.assert_array_equal(restored["x"].numpy(), tree["x"])
    np.testing.assert_array_equal(restored["nested"]["count"].numpy(), tree["nested"]["count"])
    assert restored["nested"]["time"].item() == float(tree["nested"]["time"])
    for got, want in zip(restored["list"], tree["list"]):
        np.testing.assert_array_equal(got.numpy(), want)

    port_path = str(tmp_path / "port.npz")
    checkpoint.save_checkpoint(port_path, template | {"x": torch.from_numpy(tree["x"])})
    back = jax_checkpoint.restore_checkpoint(port_path, {k: jnp.asarray(v) if k == "x" else v for k, v in tree.items()})
    np.testing.assert_array_equal(np.asarray(back["x"]), tree["x"])
    np.testing.assert_array_equal(np.asarray(back["nested"]["count"]), np.zeros(2, np.int32))


@pytest.mark.parametrize("kind", ["average", "locf"])
def test_strategy_states_cross_between_the_packages(tmp_path, kind):
    options = {"average": dict(window=0.05, max_measurements=8), "locf": dict(horizon=0.05)}[kind]
    name = {"average": "AverageConfiguration", "locf": "LOCFConfiguration"}[kind]
    jax_strategy = jax_forecast.create(jax_forecast.Configuration(
        type=kind, **{kind: getattr(jax_forecast, name)(**options)}))
    strategy = forecast_module.create(forecast_module.Configuration(
        type=kind, **{kind: getattr(forecast_module, name)(**options)}))
    jax_state = jax_strategy.init(jnp.float64)
    for k in range(11):
        jax_state = jax_strategy.update(jax_state, np.full(6, float(k)), 0.01 * k)
    jax_path = str(tmp_path / "jax.npz")
    jax_checkpoint.save_checkpoint(jax_path, {"forecast_state": jax_state})
    restored = checkpoint.restore_checkpoint(jax_path, {"forecast_state": strategy.init(torch.float64, "cpu")})
    want = interop.forecast_state_to_numpy(interop.forecast_state_from_numpy(jax_state, device="cpu"))
    got = interop.forecast_state_to_numpy(restored["forecast_state"])
    for name in want:
        assert got[name].dtype == want[name].dtype, name
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)

    port_path = str(tmp_path / "port.npz")
    checkpoint.save_checkpoint(port_path, restored)
    back = jax_checkpoint.restore_checkpoint(port_path, {"forecast_state": jax_strategy.init(jnp.float64)})
    for name in want:
        np.testing.assert_array_equal(np.asarray(getattr(back["forecast_state"], name)), want[name], err_msg=name)
