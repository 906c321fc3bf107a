"""The plain reference the benchmark judges the port by.

Plain PyTorch and NumPy; it imports nothing of the program. The modules
beside ``update.py``, ``compare.py`` and ``keys.py`` are frozen copies of the
port's plain modules at commit 761f38a (the lanes step the rollout kernels
run per thread, the plant, the objective, the ADMM-QP safety filter, the
Savitzky-Golay pass), their imports pointed here.
"""
