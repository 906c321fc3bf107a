"""The benchmark of the PyTorch/CUDA port (``python3 portbench/run.py``)."""
