"""``forecast_kalman_device_ms`` (ms per tick): the port's device span
``forecast.kalman``: the Kalman filter's measurement update and the roll of
its cached horizon; read from the ticks recorded without the profiler. None
where the program marks the forecast as one span."""

from portbench import spans


def read(trace):
    return spans.device_ms("forecast.kalman")
