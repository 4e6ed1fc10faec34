"""PyTorch/CUDA port of gennerf_tpu for NVIDIA Hopper (H100).

The JAX package `gennerf_tpu` is the reference; this package mirrors its
layout (`ops/`, `models/`, `train/predict.py`, `tsdf/fusion.py`, `eval/`,
`utils/`) so each module has a counterpart there; `predict.py` and
`render.py` are the entry points. It imports torch, numpy and yaml only —
never jax, flax or any module of `gennerf_tpu`.

The TPU's three Pallas kernels (FPS, the separable grid decode and the
arbitrary-point decode) are CUDA C++ kernels for sm_90a in `csrc/`, built
with nvcc on first use (`ops/kernels.py`).
Entry points run on the card unless the caller passes `device="cpu"`.
"""
from .device import resolve_device, set_reference_precision

__all__ = ["resolve_device", "set_reference_precision"]
