"""dcnet_tpu_torch — the PyTorch/CUDA port of dcnet_tpu for NVIDIA Hopper.

A second package beside the JAX one, which stays the reference it is tested
against. It imports nothing of JAX or of `dcnet_tpu`: what it needs of that
package's framework-free code it keeps as its own copy. Module names mirror
the JAX package's, so each counterpart is easy to find. Every Pallas kernel
on a ported path becomes a hand-written CUDA kernel under `csrc/`, bound in
`kernels/`.

Entry points run on the card unless the caller passes `device="cpu"`.
"""

from __future__ import annotations

from typing import Union

import torch

__version__ = "0.1.0"

DeviceLike = Union[str, torch.device, None]


def default_device() -> torch.device:
    """The CUDA device the port runs on. Raises where there is none: the
    port never drops to the CPU unasked (pass `device="cpu"` for that)."""
    if not torch.cuda.is_available():
        raise RuntimeError("dcnet_tpu_torch runs on a CUDA device and none is "
                           "available; pass device='cpu' to run on the CPU")
    return torch.device("cuda", torch.cuda.current_device())


def resolve_device(device: DeviceLike = None) -> torch.device:
    """`device` as a torch.device; None means `default_device()`."""
    return default_device() if device is None else torch.device(device)


def resolve_dtype(name: str) -> torch.dtype:
    """The config's compute_dtype as a torch dtype: 'float32' or 'bfloat16';
    'float64' serves as an exact reference on the CPU only (the kernels take
    float32 and bfloat16 and raise on anything else)."""
    return {"float32": torch.float32, "bfloat16": torch.bfloat16,
            "float64": torch.float64}[name]
