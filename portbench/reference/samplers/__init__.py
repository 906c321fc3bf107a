"""The fresh draws of one update, one module per sampler a configuration
names (``mppi.sampler``): ``fresh_draws(setup, words, device)`` returns the
(S, 12, R) float32 N(0, diag(scale^2)) draws an update's seed words give."""
