"""Structured CSV logging (reference L4 schema) for offline analysis (port of
assistedmanipulation_tpu/logging/)."""
