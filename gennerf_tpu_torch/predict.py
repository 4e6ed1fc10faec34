"""Reconstruct a dense TSDF volume from posed RGB-D frames (counterpart of
GenNerfTask.reconstruct / VoxelNetTask.reconstruct in
gennerf_tpu/train/tasks.py and of scripts/predict.py). GenNerf: encode,
then the dense decode and the fusion-prior clamp, or with
`sparse_band_decode` (and `mask_unobserved`) the decode of the prior's
near-surface band only. VoxelNet: encode the feature volume on the decode
grid, refine it, take the finest scale's volume and clamp it with the
fusion prior under `mask_unobserved`.

    python -m gennerf_tpu_torch.predict --config configs/experiment/seqs_multigeo_4cm.yaml \
        --ckpt RUN --data-dir D [--split val.txt] --out DIR
    python -m gennerf_tpu_torch.predict --config configs/experiment/seqs_multigeo_4cm.yaml \
        --params params.npz --frames frames.npz --out tsdf.npz
    python -m gennerf_tpu_torch.predict --config configs/experiment/seqs_multigeo_4cm.yaml \
        --params last.ckpt --frames frames.npz --out tsdf.npz
    python -m gennerf_tpu_torch.predict --config configs/experiment/seqs_multigeo_voxelnet.yaml \
        --ckpt RUN --data-dir D --split val.txt --out DIR [trainer.precision=32-true]
    python -m gennerf_tpu_torch.predict \
        --config configs/experiment/seq1_frames8_evenspaced_pointnet.yaml --ckpt RUN \
        --data-dir D --split val.txt --out DIR data.voxel_dim_test=[96,96,56] ...

The weights come from `--ckpt` (a checkpoint file, or a training run's
directory or its `checkpoints/`: the best monitored epoch there, else the
latest) or `--params`, read by the file's format: an npz of the JAX
model's `params` tree with '/'-joined keys (utils/port_params.py, as the
train CLI writes it and scripts/orbax_to_npz.py converts a JAX run), or a
reference PyTorch Lightning `.ckpt` or state-dict `.pth`
(utils/port_reference.py, strict: one that lacks port parameters goes
through `tools/port_weights.py --partial` first); without either they are
a seeded random init (with the spatial encoder's backbone npz grafted
when the config names one). A params npz of a model with the spatial encoder also
holds its BatchNorm running statistics under `batch_stats/`. `--frames` holds
`projection` (T, 3, 4), `image` (T, 3, H, W) and `depth` (T, H, W). With
`--data-dir`, every scene of the split (default: data.datasets_test) comes
through the data module's predict loader (the inference path of
ScenesDataset, which moves the scene by its origin offset), is
reconstructed at voxel_dim_test and saved as DIR/{scene}.npz in the TSDF
layout with its origin at the offset and its mesh as DIR/{scene}.ply (a
warning when it is empty); its masked TSDF L1 against the scene's ground
truth is printed, and DIR/predict_meta.json records the checkpoint, its
epoch, how it was selected and the precision. The model computes in the
training precision (the config's trainer.precision: bf16-mixed for the
VoxelNet drive and for the GenNerf configs under `/trainer: tpu`, among
them the flagship seq1_frames8_evenspaced_pointnet; a checkpoint trained
in bf16 holds float32 parameters and reloads into the bf16 model). Runs on
the card unless `--device cpu` is given.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Optional, Union

import numpy as np
import torch

from .device import resolve_device, set_reference_precision
from .models.config import GenNerfConfig, VoxelNetConfig
from .models.gen_nerf import GenNerf
from .models.voxel_net import VoxelNet
from .train.predict import predict_tsdf_volume, predict_tsdf_volume_sparse
from .train.tasks import dtype_for_precision, model_config, task_for
from .tsdf.fusion import apply_fusion_prior
from .utils.spans import span


def build_model(model_cfg: Union[dict, GenNerfConfig, VoxelNetConfig], device=None,
                seed: int = 0, precision=None) -> Union[GenNerf, VoxelNet]:
    """The model of the config's `type` (GenNerf or VoxelNet) in eval mode
    on `device` (the card by default) computing in `precision`'s dtype
    (trainer.precision; default float32), its weights a random init drawn
    from `seed`, GenNerf with its config's teacher (train/tasks.py), with
    the backbone npz of `encoder.spatial.pretrained_path` grafted into the
    spatial encoder's ResNet when the config names one
    (tools/port_backbone.py)."""
    device = resolve_device(device)
    cfg = model_config(model_cfg)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = task_for(cfg).build(cfg, dtype_for_precision(precision))
    if cfg.encoder.use_spatial and cfg.encoder.spatial.pretrained_path:
        from .tools.port_backbone import graft_backbone

        graft_backbone(model, cfg.encoder.spatial.pretrained_path)
    return model.to(device).eval()


@torch.no_grad()
def reconstruct(model: Union[GenNerf, VoxelNet], projection: torch.Tensor, image: torch.Tensor,
                depth: torch.Tensor, voxel_dim=None,
                generator: Optional[torch.Generator] = None,
                sel: Optional[torch.Tensor] = None,
                start: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One scene's (nx, ny, nz) f32 TSDF volume, on the model's device; a
    feature volume is encoded on the decode grid, both at origin 0.

    Args:
        projection: (T, 3, 4) world->image; image: (T, 3, H, W); depth: (T, H, W).
        voxel_dim: decode grid, default the config's voxel_dim_test.
        generator: source of the encoder's presample and FPS start draws.
        sel, start: injected encoder draws (see GenNerf.encode; VoxelNet
            draws nothing).
    """
    with span("gennerf.reconstruct"):
        set_reference_precision()
        cfg = model.cfg
        device = next(model.parameters()).device
        projection, image, depth = (torch.as_tensor(a, dtype=torch.float32).to(device)
                                    for a in (projection, image, depth))
        voxel_dim = tuple(int(d) for d in (voxel_dim or cfg.voxel_dim_test))
        origin = torch.zeros(3, dtype=torch.float32, device=device)
        if isinstance(model, VoxelNet):
            model.eval()
            outputs, _ = model(projection[None], image[None], voxel_dim, origin)
            vol = outputs["vol_%02d_tsdf" % cfg.voxel_sizes[0]][0, 0]
            if cfg.mask_unobserved:
                vol = apply_fusion_prior(vol, cfg.voxel_size, origin, projection, depth)
            return vol.to(torch.float32)
        repr_ = model.encode(projection[None], image[None], depth[None], generator, sel, start,
                             voxel_dim, origin)
        if cfg.mask_unobserved and cfg.sparse_band_decode:
            vol = predict_tsdf_volume_sparse(model, repr_, voxel_dim, cfg.voxel_size, origin,
                                             projection, depth)
        else:
            vol = predict_tsdf_volume(model, repr_, voxel_dim, cfg.voxel_size, origin)
            if cfg.mask_unobserved:
                vol = apply_fusion_prior(vol, cfg.voxel_size, origin, projection, depth)
        return vol.to(torch.float32)


def predict_split(model: GenNerf, data_cfg: dict, out_dir: str, seed: int = 0) -> dict:
    """Reconstruct every scene of the data config's test split through the
    predict loader; save out_dir/{scene}.npz (origin at the scene's offset)
    and its mesh out_dir/{scene}.ply, and return {scene: {"l1": masked TSDF
    L1 against its ground truth, "offset": (3,) origin, "vertices": the
    mesh's vertex count}}."""
    from .data.datamodule import ScannetDataModule
    from .data.datasets import load_info_json
    from .eval.metrics import eval_tsdf
    from .tsdf.tsdf import TSDF

    os.makedirs(out_dir, exist_ok=True)
    model.eval()
    loader = ScannetDataModule(data_cfg, seed=seed).predict_dataloader()
    vs_cm = int(round(model.cfg.voxel_size * 100))
    results = {}
    generator = torch.Generator().manual_seed(seed)
    for info_file, batch in zip(loader.dataset.info_files, loader):
        scene = batch["scene"][0]
        vol = reconstruct(model, batch["projection"][0], batch["image"][0], batch["depth"][0],
                          generator=generator)
        offset = np.asarray(batch["offset"][0], np.float32).reshape(1, 3)
        pred = TSDF(model.cfg.voxel_size, torch.from_numpy(offset), vol.cpu())
        pred.save(os.path.join(out_dir, f"{scene}.npz"))
        mesh = pred.get_mesh()
        mesh.export(os.path.join(out_dir, f"{scene}.ply"))
        if mesh.is_empty:
            # a field saturated to +-1 has no zero crossing (an under-trained model)
            print(f"warning: {scene}: the extracted mesh is empty", file=sys.stderr, flush=True)
        info = load_info_json(info_file)
        result = {"offset": offset[0].tolist(), "vertices": len(mesh)}
        if f"file_name_vol_{vs_cm:02d}" in info:
            result.update(eval_tsdf(pred, TSDF.load(info[f"file_name_vol_{vs_cm:02d}"])))
        results[scene] = result
        print(f"{scene}: {json.dumps(result)}", flush=True)
    return results


def load_params(model: Union[GenNerf, VoxelNet], path: str, partial: bool = False) -> dict:
    """`--params`: a params npz (the flax tree, train.tasks.load_flax_params)
    or a reference `.ckpt` / `.pth` (utils/port_reference.load_reference,
    `partial` as there), chosen by the file's format; another format raises
    ValueError. Returns the format and the port keys left at init."""
    from .train.tasks import load_flax_params
    from .utils.port_params import load_params_npz
    from .utils.port_reference import load_reference, weights_format

    if weights_format(path) == "npz":
        load_flax_params(model, load_params_npz(path))
        return {"format": "npz", "unfilled": []}
    return {"format": "reference", "unfilled": load_reference(model, path, partial).unfilled}


def load_weights(model: Union[GenNerf, VoxelNet], ckpt: Optional[str] = None,
                 params: Optional[str] = None, precision: str = "32-true") -> dict:
    """Load the weights an entry point was given into `model`: the
    checkpoint `select_checkpoint` picks for `ckpt`, or a params file
    (`load_params`), or none (the seeded init). Returns predict_meta.json's
    record: the file, its epoch, how it was selected and the precision the
    model runs in."""
    from .train.checkpoints import load_checkpoint, select_checkpoint

    meta = {"ckpt_path": None, "epoch": None, "selected_by": None, "precision": precision}
    if ckpt:
        path, selected_by = select_checkpoint(ckpt)
        epoch = load_checkpoint(path, model)["epoch"]
        meta.update(ckpt_path=os.path.abspath(path), epoch=epoch, selected_by=selected_by)
        print(f"loaded {path} (epoch {epoch}, selected by {selected_by})", flush=True)
    elif params:
        loaded = load_params(model, params)
        meta.update(ckpt_path=os.path.abspath(params), selected_by="params",
                    params_format=loaded["format"], left_at_init=loaded["unfilled"])
    return meta


def main(argv=None):
    from .utils.config import load_experiment_config

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--config", required=True, help="configs/experiment/<name>.yaml")
    weights = parser.add_mutually_exclusive_group()
    weights.add_argument("--ckpt", help="checkpoint file, or a run or checkpoints/ directory "
                         "(its best monitored epoch, else the latest)")
    weights.add_argument("--params", help="npz of the JAX params tree ('/'-joined keys), or a "
                         "reference Lightning .ckpt or state-dict .pth")
    source = parser.add_mutually_exclusive_group(required=True)
    source.add_argument("--frames", help="npz with projection, image, depth")
    source.add_argument("--data-dir", help="dataset root: reconstruct the scenes of a split")
    parser.add_argument("--split", help="split list under --data-dir (default: data.datasets_test)")
    parser.add_argument("--out", required=True,
                        help="output npz (tsdf, voxel_size, origin); with --data-dir a directory")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("overrides", nargs="*", help="config overrides a.b.c=value "
                        "(trainer.precision=32-true for a float32 run)")
    args = parser.parse_args(argv)

    overrides = [f"paths.data_dir={os.path.abspath(args.data_dir)}"] if args.data_dir else []
    cfg = load_experiment_config(args.config, "predict", overrides + args.overrides)
    precision = str((cfg.get("trainer") or {}).get("precision", "32-true"))
    model = build_model(cfg["model"], args.device, args.seed, precision)
    meta = load_weights(model, args.ckpt, args.params, precision)
    if args.data_dir:
        data_cfg = dict(cfg["data"])
        if args.split:
            data_cfg["datasets_test"] = [args.split]
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "predict_meta.json"), "w") as f:
            json.dump(meta, f, indent=2)
        return predict_split(model, data_cfg, args.out, args.seed)
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
