"""Device choice and float32 policy shared by the port's entry points."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the card unless the caller names
    another. Raises when CUDA is asked for (explicitly or by default) and
    there is no CUDA device — there is no silent CPU fallback."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device available; pass device='cpu' to run on the CPU"
        )
    return dev


def set_reference_precision() -> None:
    """Full float32 in every matmul and convolution of the reference paths.

    A float32 matmul on the card is true f32 by default, but a float32
    convolution goes through cuDNN in TF32 (about three decimal digits).
    The port's plain paths are held against the JAX reference at f32, so
    the entry points turn TF32 off for both."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
