"""PyTorch/CUDA port of the ApproxIFER coded serving system.

The JAX package ``repro`` is the reference; this package mirrors its
module layout (``core``, ``kernels``, ``models``, ``serving``,
``launch``, ``configs``) and never imports it or JAX.  Every Pallas
kernel on the ported path is a CUDA kernel written for Hopper
(``csrc/*.cu``), dispatched by the device of the tensor it is given.
"""

from __future__ import annotations

import torch

# fp32 products must run in full fp32 to match the reference: TF32 keeps
# only about three decimal digits.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``None`` means ``"cuda"``.

    With no CUDA device and no explicit ``device="cpu"`` this raises, so
    a run never carries on quietly on the CPU's plain path.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device available; pass device='cpu' to run the "
                "plain PyTorch path explicitly")
        return torch.device("cuda")
    return torch.device(device)
