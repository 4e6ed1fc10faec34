"""Reconstruct a dense TSDF volume from posed RGB-D frames (counterpart of
GenNerfTask.reconstruct in gennerf_tpu/train/tasks.py, for scenes without
ground truth): encode, then the dense decode and the fusion-prior clamp, or
with `sparse_band_decode` (and `mask_unobserved`) the decode of the prior's
near-surface band only.

    python -m gennerf_tpu_torch.predict --config configs/experiment/seqs_multigeo_4cm.yaml \
        --params params.npz --frames frames.npz --out tsdf.npz

`--params` is an npz of the JAX model's `params` tree with '/'-joined keys
(utils/port_params.py); without it the weights are a seeded random init.
`--frames` holds `projection` (T, 3, 4), `image` (T, 3, H, W) and `depth`
(T, H, W). Runs on the card unless `--device cpu` is given.
"""
from __future__ import annotations

import argparse
from typing import Optional, Union

import numpy as np
import torch

from .device import resolve_device, set_reference_precision
from .models.config import GenNerfConfig, config_from_dict
from .models.gen_nerf import GenNerf
from .train.predict import predict_tsdf_volume, predict_tsdf_volume_sparse
from .tsdf.fusion import apply_fusion_prior


def build_model(model_cfg: Union[dict, GenNerfConfig], device=None, seed: int = 0) -> GenNerf:
    """A GenNerf in eval mode on `device` (the card by default), its
    weights a random init drawn from `seed`."""
    device = resolve_device(device)
    cfg = model_cfg if isinstance(model_cfg, GenNerfConfig) else config_from_dict(GenNerfConfig, model_cfg)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = GenNerf(cfg)
    return model.to(device).eval()


@torch.no_grad()
def reconstruct(model: GenNerf, projection: torch.Tensor, image: torch.Tensor,
                depth: torch.Tensor, voxel_dim=None,
                generator: Optional[torch.Generator] = None,
                sel: Optional[torch.Tensor] = None,
                start: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One scene's (nx, ny, nz) f32 TSDF volume, on the model's device.

    Args:
        projection: (T, 3, 4) world->image; image: (T, 3, H, W); depth: (T, H, W).
        voxel_dim: decode grid, default the config's voxel_dim_test.
        generator: source of the encoder's presample and FPS start draws.
        sel, start: injected encoder draws (see GenNerf.encode).
    """
    set_reference_precision()
    cfg = model.cfg
    device = next(model.parameters()).device
    projection, image, depth = (torch.as_tensor(a, dtype=torch.float32).to(device)
                                for a in (projection, image, depth))
    voxel_dim = tuple(int(d) for d in (voxel_dim or cfg.voxel_dim_test))
    origin = torch.zeros(3, dtype=torch.float32, device=device)
    repr_ = model.encode(projection[None], image[None], depth[None], generator, sel, start)
    if cfg.mask_unobserved and cfg.sparse_band_decode:
        vol = predict_tsdf_volume_sparse(model, repr_, voxel_dim, cfg.voxel_size, origin,
                                         projection, depth)
    else:
        vol = predict_tsdf_volume(model, repr_, voxel_dim, cfg.voxel_size, origin)
        if cfg.mask_unobserved:
            vol = apply_fusion_prior(vol, cfg.voxel_size, origin, projection, depth)
    return vol.to(torch.float32)


def main(argv=None) -> None:
    from .utils.config import load_experiment_model_config
    from .utils.port_params import gen_nerf_params_from_flax, load_params_npz

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--config", required=True, help="configs/experiment/<name>.yaml")
    parser.add_argument("--params", help="npz of the JAX params tree ('/'-joined keys)")
    parser.add_argument("--frames", required=True, help="npz with projection, image, depth")
    parser.add_argument("--out", required=True, help="output npz (tsdf, voxel_size, origin)")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)

    model = build_model(load_experiment_model_config(args.config), args.device, args.seed)
    if args.params:
        state = gen_nerf_params_from_flax(load_params_npz(args.params))
        model.load_state_dict(state)
    with np.load(args.frames) as f:
        frames = {k: f[k] for k in ("projection", "image", "depth")}
    generator = torch.Generator().manual_seed(args.seed)
    vol = reconstruct(model, frames["projection"], frames["image"], frames["depth"],
                      generator=generator)
    np.savez(args.out, tsdf=vol.cpu().numpy(), voxel_size=model.cfg.voxel_size,
             origin=np.zeros(3, np.float32))
    print(f"wrote {args.out}: tsdf {tuple(vol.shape)}")


if __name__ == "__main__":
    main()
