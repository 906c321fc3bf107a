"""``forecast_scenarios_device_ms`` (ms per tick): the port's device span
``forecast.scenarios``: the posterior's Cholesky factor, the scenario draws
and their roll over the horizon; read from the ticks recorded without the
profiler. None where the program marks the forecast as one span."""

from portbench import spans


def read(trace):
    return spans.device_ms("forecast.scenarios")
