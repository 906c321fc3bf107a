"""Wrench forecasting: Kalman / average / LOCF strategies and forecast
scenario ensembles (port of assistedmanipulation_tpu/forecast/)."""
