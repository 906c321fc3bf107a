"""Full (non-diagonal) sampling covariance, the threshold elite select and
the configuration loaders of the port, against the JAX package at float64
on the CPU.

- ``ops/gaussian.covariance_transform`` equals the JAX one bitwise (both
  numpy); the same standard normals z give JAX's ``z @ T.T`` through the
  port's ``correlate`` (what ``PlantSampler`` applies to its draws); 200k
  port draws have the configured covariance within 5 sigma per element.
- A ``Planner`` with a non-diagonal covariance (a rank-deficient one: the
  gripper dofs carry no noise, so the transform's clamp is live) runs on
  the vmap path: against the JAX generic planner under the same
  ``noise_override``, and under the same standard normals (the JAX planner
  draws them from its key; the port gets them correlated through
  ``fresh=``), every state field within the tolerance of
  tests/test_torch_mppi.py. (The two-pass path, kernel 2's plain version
  through ``make_cuda_rollout_fn``, is held to the JAX lanes planner in
  tests/test_torch_lanes_backend.py.) The kernel samplers refuse it with
  the JAX message; a diagonal covariance draws bitwise what it drew
  before.
- ``elite_select="threshold"`` gives the lexsort's keep mask bitwise and
  JAX's threshold mask, over planted V ties, (V, S) ties at the boundary,
  NaNs and keep_best 0, 1, R - 2; full updates of every sampler (fused,
  two-pass, in-kernel RNG, vmap, lanes, the 2-shard twin) under planted
  ties are bitwise the lexsort's.
- ``mppi.configuration_from_json`` and ``safety.configuration_from_json``
  build the port's default from the JAX ``to_json`` of each default.
- The harness takes a 12 x 12 list-of-lists covariance in ``--config``.
"""

import dataclasses
import json
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from assistedmanipulation_tpu import config as jax_config
from assistedmanipulation_tpu import mppi as jax_mppi
from assistedmanipulation_tpu import safety as jax_safety
from assistedmanipulation_tpu.models import frankaridgeback as jax_fr
from assistedmanipulation_tpu.objectives.assisted_manipulation import (
    AssistedManipulation as JaxObjective,
    ForecastContext as JaxForecastContext,
)
from assistedmanipulation_tpu.ops import gaussian as jax_gaussian
from assistedmanipulation_tpu_torch import mppi, safety
from assistedmanipulation_tpu_torch.harness.runner import TestSuite
from assistedmanipulation_tpu_torch.kernels import build
from assistedmanipulation_tpu_torch.kernels.cuda_rollout import (
    CudaSampler,
    noise_from_logical,
    noise_to_logical,
)
from assistedmanipulation_tpu_torch.kernels.philox import seed_bits
from assistedmanipulation_tpu_torch.models import frankaridgeback as fr
from assistedmanipulation_tpu_torch.models.model_data import frankaridgeback_model
from assistedmanipulation_tpu_torch.objectives.assisted_manipulation import (
    AssistedManipulation,
    Configuration as ObjectiveConfiguration,
    ForecastContext,
)
from assistedmanipulation_tpu_torch.ops import gaussian
from assistedmanipulation_tpu_torch.parallel.flagship import build_flagship
from torch_threads import one_torch_thread  # noqa: E402,F401  (a module fixture)

STEPS, ROLLOUTS = 6, 22
R = ROLLOUTS + 2
# The tolerance of tests/test_torch_mppi.py's planner steps.
RTOL, ATOL = 1e-10, 1e-12


def full_covariance(seed: int = 3) -> np.ndarray:
    """An SPD-but-singular 12 x 12 covariance: the default standard
    deviations around a random correlation matrix (gripper rows zero)."""
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(12, 12))
    C = A @ A.T
    d = np.sqrt(np.diag(C))
    C = C / d[:, None] / d[None, :]
    s = np.sqrt(fr.DEFAULT_COVARIANCE)
    return s[:, None] * C * s[None, :]


COVARIANCE = full_covariance()


def configuration(module, mode="batch", **extra):
    fields = dict(
        rollouts=ROLLOUTS, keep_best_rollouts=5, time_step=0.01, horizon=STEPS * 0.01,
        covariance=COVARIANCE, control_min=fr.DEFAULT_CONTROL_MIN, control_max=fr.DEFAULT_CONTROL_MAX,
        control_default=np.zeros(12), smoothing=module.Smoothing(10, 1), dtype="float64",
        optimal_rollout_mode=mode,
    )
    return module.Configuration(**{**fields, **extra})


def contexts():
    wrench = np.zeros((11, 6))
    wrench[:, 0] = 20.0
    wrench[:, 2] = np.linspace(0.0, -6.0, 11)
    return (
        ForecastContext(torch.tensor(wrench), torch.tensor(0.0, dtype=torch.float64), 0.01, 0.095),
        JaxForecastContext(jnp.asarray(wrench), jnp.asarray(0.0, jnp.float64), 0.01, 0.095),
    )


def close(port, want, what=""):
    port = port.detach().numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    np.testing.assert_allclose(port, np.asarray(want, np.float64), rtol=RTOL, atol=ATOL, err_msg=what)


def assert_states_close(state, info, jax_state, jax_info):
    close(noise_to_logical(state.noise), jax_state.noise, "noise")
    for name in ("optimal_control", "costs", "last_shift_time", "last_update_time", "sg_buffer",
                 "sg_time", "update_count", "optimal_cost"):
        close(getattr(state, name), getattr(jax_state, name), name)
    for name in jax_info._fields:
        close(getattr(info, name), getattr(jax_info, name), f"info.{name}")


# --- the transform and the draws ------------------------------------------


def test_covariance_transform_equals_jax_bitwise():
    for covariance in (COVARIANCE, full_covariance(8), fr.DEFAULT_COVARIANCE, np.diag(fr.DEFAULT_COVARIANCE)):
        got = gaussian.covariance_transform(covariance)
        np.testing.assert_array_equal(got, jax_gaussian.covariance_transform(covariance))
        np.testing.assert_allclose(got @ got.T, np.atleast_2d(np.diag(covariance)) if covariance.ndim == 1
                                   else covariance, atol=1e-12)


def test_correlated_draws_equal_jax_on_the_same_normals():
    """z (R, S, 12) through ``correlate`` in the port's (S, 12, R) layout
    against JAX's ``z @ T.T``; and ``sample_noise`` is ``correlate`` of the
    generator's own standard normals."""
    z = np.random.default_rng(4).standard_normal((R, STEPS, 12))
    T = gaussian.covariance_transform(COVARIANCE)
    want = np.asarray(jnp.asarray(z) @ jnp.asarray(jax_gaussian.covariance_transform(COVARIANCE)).T)
    got = gaussian.correlate(noise_from_logical(torch.tensor(z)), torch.tensor(T), dim=1)
    np.testing.assert_allclose(noise_to_logical(got).numpy(), want, rtol=0, atol=1e-14)
    generator = torch.Generator().manual_seed(11)
    drawn = gaussian.sample_noise(generator, torch.tensor(T), (STEPS, 12, R), dim=1)
    normals = torch.randn((STEPS, 12, R), generator=generator.manual_seed(11), dtype=torch.float64)
    assert torch.equal(drawn, gaussian.correlate(normals, torch.tensor(T), dim=1))


def test_port_draws_have_the_configured_covariance():
    """200,000 draws of the vmap planner's sampler; each element of their
    sample covariance within 5 sigma of the configured one (Var(x_i x_j) =
    C_ii C_jj + C_ij^2 for a zero-mean Gaussian)."""
    planner = mppi.Planner(configuration(mppi), fr.make_plant(AssistedManipulation()), device="cpu")
    sampler = planner.sampler
    generator = torch.Generator().manual_seed(seed_bits(torch.tensor([5, 9], dtype=torch.int32)))
    factor = torch.tensor(sampler._factor)
    draws = gaussian.sample_noise(generator, factor, (20, 12, 10_000), dim=1)
    x = draws.permute(0, 2, 1).reshape(-1, 12).numpy()
    n = x.shape[0]
    sample = x.T @ x / n
    sigma = np.sqrt((np.outer(np.diag(COVARIANCE), np.diag(COVARIANCE)) + COVARIANCE**2) / n)
    assert (np.abs(sample - COVARIANCE) <= 5 * sigma + 1e-12).all(), np.max(np.abs(sample - COVARIANCE) / sigma)
    assert np.abs(COVARIANCE - np.diag(np.diag(COVARIANCE))).max() > 0.5  # correlations really drawn


def test_a_diagonal_covariance_draws_bitwise_as_before():
    """The scale path is untouched: a diagonal covariance draws the standard
    normals times the per-dof deviations, bitwise."""
    scale = gaussian.noise_factor(fr.DEFAULT_COVARIANCE)
    assert scale.shape == (12,)
    np.testing.assert_array_equal(scale, np.sqrt(fr.DEFAULT_COVARIANCE))
    generator = torch.Generator().manual_seed(3)
    drawn = gaussian.sample_noise(generator, torch.tensor(scale), (STEPS, 12, R), dim=1)
    normals = torch.randn((STEPS, 12, R), generator=generator.manual_seed(3), dtype=torch.float64)
    assert torch.equal(drawn, normals * torch.tensor(scale)[None, :, None])


# --- full-covariance planners -----------------------------------------------


def port_planner():
    return mppi.Planner(configuration(mppi), fr.make_plant(AssistedManipulation()), device="cpu")


@pytest.fixture(scope="module")
def jax_planner():
    return jax_mppi.Planner(configuration(jax_mppi), jax_fr.make_plant(JaxObjective()))


def test_full_covariance_planner_matches_jax_under_noise_override(jax_planner):
    planner = port_planner()
    assert planner.sampler._factor.shape == (12, 12)
    ctx, jax_ctx = contexts()
    x0 = fr.make_state("huddled")
    T = gaussian.covariance_transform(COVARIANCE)
    rng = np.random.default_rng(5)
    jax_state, state = jax_planner.init(seed=0), planner.init(seed=0)
    build.reset_launch_counts()
    for time in (0.0, 0.01, 0.03):
        override = rng.standard_normal((R - 2, STEPS, 12)) @ T.T
        jax_state, jax_info = jax_planner.update(jax_state, x0, time, jax_ctx, noise_override=override)
        state, info = planner.update(state, x0, time, ctx, noise_override=override)
        assert_states_close(state, info, jax_state, jax_info)
    assert all(count == 0 for count in build.LAUNCHES.values())


def test_full_covariance_planner_matches_jax_on_its_own_normals(jax_planner):
    """The JAX planner draws z from its key and applies T itself; the port
    gets ``correlate(z, T)`` as ``fresh=`` (elite rows keep their noise on
    both sides)."""
    planner = port_planner()
    ctx, jax_ctx = contexts()
    x0 = fr.make_state("huddled")
    T = torch.tensor(gaussian.covariance_transform(COVARIANCE))

    @jax.jit
    def normals(words):
        _, key = jax.random.split(jax.random.wrap_key_data(words, impl="threefry2x32"))
        return jax.random.normal(key, (R, STEPS, 12), jnp.float64)

    jax_state, state = jax_planner.init(seed=0), planner.init(seed=0)
    for time in (0.0, 0.01, 0.03):
        z = noise_from_logical(torch.tensor(np.asarray(normals(jax_state.rng))))
        fresh = noise_to_logical(gaussian.correlate(z, T, dim=1))
        jax_state, jax_info = jax_planner.update(jax_state, x0, time, jax_ctx)
        state, info = planner.update(state, x0, time, ctx, fresh=fresh)
        assert_states_close(state, info, jax_state, jax_info)


def test_kernel_samplers_refuse_a_full_covariance():
    cfg = configuration(mppi)
    for options in ({}, {"fused_assembly": False}, {"inkernel_rng": True}):
        sampler = CudaSampler(
            frankaridgeback_model(), ObjectiveConfiguration(), fr.Configuration(), R, STEPS, 0.01,
            np.sqrt(fr.DEFAULT_COVARIANCE), device="cpu", **options,
        )
        with pytest.raises(ValueError, match="fused_sampling requires a diagonal covariance"):
            mppi.Planner(cfg, sampler, 12, device="cpu")
        mppi.Planner(dataclasses.replace(cfg, covariance=fr.DEFAULT_COVARIANCE), sampler, 12, device="cpu")
    with pytest.raises(ValueError, match="fused_sampling requires a diagonal covariance"):
        CudaSampler(frankaridgeback_model(), ObjectiveConfiguration(), fr.Configuration(), R, STEPS, 0.01,
                    gaussian.covariance_transform(COVARIANCE), device="cpu")


def test_harness_builds_a_full_covariance_from_the_config(tmp_path):
    """``--config``'s 12 x 12 list-of-lists covariance reaches the actor's
    planner as a full covariance (one controller period, episode engine)."""
    patch = {
        "duration": 0.05, "engine": "episode",
        "actor": {"mppi": {"rollouts": 8, "keep_best_rollouts": 2, "horizon": 0.05,
                           "covariance": COVARIANCE.tolist()}, "controller_rate": 0.05},
    }
    assert TestSuite.run("circle", str(tmp_path), patch, device="cpu")
    (folder,) = [entry.path for entry in os.scandir(tmp_path)]
    with open(os.path.join(folder, "configuration.json")) as handle:
        written = json.load(handle)
    np.testing.assert_array_equal(np.asarray(written["actor"]["mppi"]["covariance"]), COVARIANCE)
    for rel in (("mppi", "gradient.csv"), ("dynamics", "control.csv")):
        with open(os.path.join(folder, *rel)) as handle:
            rows = [line for line in handle.read().splitlines()[1:] if line]
        assert rows and all(np.isfinite(float(v)) for row in rows for v in row.split(",")), rel


# --- the threshold elite select ---------------------------------------------


def planted_costs(kind: str, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if kind == "v_ties":  # V in {0, 1}: the boundary falls inside a V tie
        return np.stack([rng.integers(0, 2, R).astype(float), rng.uniform(1, 100, R)], axis=1)
    if kind == "vs_ties":  # (V, S) ties straddle the boundary: index order decides
        return np.stack([rng.integers(0, 2, R).astype(float), rng.choice([5.0, 7.5, 7.5, 7.5, 9.0], R)], axis=1)
    if kind == "nan":
        costs = np.stack([rng.integers(0, 2, R).astype(float), rng.choice([1.0, 2.0, 2.0], R)], axis=1)
        costs[rng.choice(R, 9, replace=False), 0] = np.nan
        costs[rng.choice(R, 9, replace=False), 1] = np.nan
        return costs
    if kind == "mostly_nan":  # the boundary falls among the NaNs (V = S = inf)
        costs = np.stack([np.zeros(R), rng.uniform(1, 2, R)], axis=1)
        costs[rng.choice(np.arange(2, R), R - 5, replace=False), 0] = np.nan
        return costs
    if kind == "signed_zero":
        return np.stack([np.where(rng.random(R) < 0.5, -0.0, 0.0), np.where(rng.random(R) < 0.5, -0.0, 0.0)], 1)
    raise ValueError(kind)


def meta_states(costs):
    jax_state = jax_mppi.PlannerState(
        optimal_control=jnp.zeros((STEPS, 12)), noise=jnp.zeros((R, STEPS, 12)), costs=jnp.asarray(costs),
        last_shift_time=jnp.asarray(0.0, jnp.float64), last_update_time=jnp.asarray(0.0, jnp.float64),
        sg_buffer=jnp.zeros((12, STEPS + 21)), sg_time=jnp.asarray(np.nan, jnp.float64),
        rng=jax.random.key_data(jax.random.key(0, impl="threefry2x32")),
        update_count=jnp.asarray(0, jnp.int32), optimal_cost=jnp.asarray(0.0, jnp.float64),
        update_duration=jnp.asarray(0.0, jnp.float64),
    )
    state = port_planner().init(seed=0)._replace(costs=torch.tensor(costs))
    return jax_state, state


@pytest.mark.parametrize("kind", ["v_ties", "vs_ties", "nan", "mostly_nan", "signed_zero"])
@pytest.mark.parametrize("keep", [0, 1, 5, ROLLOUTS])
def test_threshold_select_is_the_lexsort_mask(kind, keep):
    costs = planted_costs(kind, seed=keep)
    plant = fr.make_plant(AssistedManipulation())
    masks = {}
    for select in mppi.ELITE_SELECTS:
        cfg = configuration(mppi, elite_select=select, keep_best_rollouts=keep)
        planner = mppi.Planner(cfg, plant, device="cpu")
        jax_state, state = meta_states(costs)
        masks[select] = planner._sample_meta(state, torch.tensor(0.0, dtype=torch.float64))[4]
    jax_cfg = dataclasses.replace(configuration(jax_mppi), elite_select="threshold", keep_best_rollouts=keep)
    jax_mask = np.asarray(jax_mppi.Planner(jax_cfg, jax_fr.make_plant(JaxObjective()))._sample_meta(
        jax_state, jnp.asarray(0.0, jnp.float64))[4])
    assert torch.equal(masks["threshold"], masks["lexsort"])
    np.testing.assert_array_equal(masks["threshold"].numpy(), jax_mask)
    assert int(masks["threshold"].sum()) == keep and not masks["threshold"][:2].any()


def test_threshold_keep_mask_on_random_ties():
    """``threshold_keep_mask`` alone over many small random batches with
    heavy ties, against the lexsort's ranks."""
    rng = np.random.default_rng(21)
    for trial in range(200):
        n = int(rng.integers(3, 40))
        costs = np.stack([rng.integers(0, 3, n).astype(float), rng.integers(0, 4, n).astype(float)], 1)
        costs[rng.random((n, 2)) < 0.1] = np.nan
        is_static = torch.arange(n) < 2
        V, S = (torch.where(torch.isnan(c) | is_static, torch.inf, c) for c in torch.tensor(costs).T)
        keep = int(rng.integers(1, n - 1)) if n > 3 else 1
        tiebreak = torch.where(is_static, n + torch.arange(n), torch.arange(n))
        order = mppi._lexsort((tiebreak, S, V))
        rank = torch.empty_like(order)
        rank[order] = torch.arange(n)
        assert torch.equal(mppi.threshold_keep_mask(V, S, is_static, keep), rank < keep), trial


@pytest.mark.parametrize("options", [
    {}, {"fused_assembly": False}, {"inkernel_rng": True}, {"backend": "vmap"}, {"backend": "lanes"},
    {"sampler_shards": 2}, {"scenarios": 2},
], ids=["fused", "two_pass", "inkernel", "vmap", "lanes", "twin", "scenarios"])
def test_threshold_updates_are_the_lexsort_ones_in_every_sampler(options):
    """Two updates from planted (V, S) ties: the threshold planner's noise,
    costs and controls bitwise the lexsort planner's."""
    rollouts, steps = 14, 3
    costs = torch.tensor(np.stack([np.tile([0.0, 1.0], 8), np.tile([3.0, 3.0, 2.0, 3.0], 4)], axis=1))
    runs = {}
    for select in mppi.ELITE_SELECTS:
        flagship = build_flagship(rollouts, steps, device="cpu", dtype="float64", elite_select=select, **options)
        assert flagship.planner.configuration.elite_select == select
        state, ctx = flagship.init(seed=3), flagship.make_ctx()
        state = state._replace(costs=costs)
        out = []
        for k in range(2):
            state, _ = flagship.update(state, flagship.x0, torch.tensor(0.01 * (k + 1), dtype=torch.float64), ctx)
            out.append(state)
            state = state._replace(costs=costs)
        runs[select] = out
    for got, want in zip(runs["threshold"], runs["lexsort"]):
        for name in ("noise", "costs", "optimal_control"):
            assert torch.equal(getattr(got, name), getattr(want, name)), name


def test_unknown_elite_select_is_refused():
    with pytest.raises(ValueError, match="unknown elite_select"):
        mppi.Planner(configuration(mppi, elite_select="heap"), fr.make_plant(AssistedManipulation()), device="cpu")


# --- the configuration loaders ----------------------------------------------


def test_configuration_from_json_builds_the_port_default():
    tree = jax_config.to_json(jax_mppi.Configuration())
    assert set(tree) - {f.name for f in dataclasses.fields(mppi.Configuration)} == {"rng_impl", "rollout_axis"}
    assert mppi.configuration_from_json(tree) == mppi.Configuration()
    assert safety.configuration_from_json(jax_config.to_json(jax_safety.Configuration())) == safety.Configuration()
    # Fields with arrays and a nested dataclass: equal trees both ways.
    from assistedmanipulation_tpu.parallel.flagship import default_mppi_configuration as jax_default
    from assistedmanipulation_tpu_torch.config import to_json
    from assistedmanipulation_tpu_torch.parallel.flagship import default_mppi_configuration

    jax_cfg = dataclasses.replace(jax_default(30, 8), elite_select="threshold", covariance=COVARIANCE)
    jax_tree = jax_config.to_json(jax_cfg)
    port = mppi.configuration_from_json(jax_tree)
    assert port.elite_select == "threshold" and isinstance(port.smoothing, mppi.Smoothing)
    np.testing.assert_array_equal(port.covariance, COVARIANCE)
    want = to_json(dataclasses.replace(default_mppi_configuration(30, 8), elite_select="threshold",
                                       covariance=COVARIANCE))
    assert to_json(port) == want
    assert {key: value for key, value in jax_tree.items() if key not in ("rng_impl", "rollout_axis")} == want
    limits = {"velocity_maximum": [1.0] * 12, "iterations": 7, "limit_reach": False}
    port_safety = safety.configuration_from_json(jax_config.to_json(jax_safety.configuration_from_json(limits)))
    assert to_json(port_safety) == jax_config.to_json(jax_safety.configuration_from_json(limits))
