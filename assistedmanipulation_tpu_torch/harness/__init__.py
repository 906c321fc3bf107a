"""Registry-by-name experiment harness (reference L5, src/test/); port of
assistedmanipulation_tpu/harness/."""

from .runner import TestSuite, register_test, main  # noqa: F401
from . import cases  # noqa: F401  (self-registration)
