"""PyTorch/CUDA port of assistedmanipulation_tpu for NVIDIA Hopper.

The module layout mirrors the JAX package (``assistedmanipulation_tpu``) so
each ported module sits at the same relative path as its reference. The
port imports torch and never jax; the JAX package stays the reference that
``tests/test_torch_*.py`` hold it against.
"""

import torch


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on. CUDA by default; a caller that
    wants the plain PyTorch path on the CPU says ``device="cpu"``. Asking
    for CUDA where there is none raises: nothing falls back to the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "PyTorch path on the CPU"
        )
    return device
