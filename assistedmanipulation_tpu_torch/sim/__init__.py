"""Simulation layer: plant stepping, actor composition, human model (port of
assistedmanipulation_tpu/sim/)."""
