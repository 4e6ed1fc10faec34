#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (gennerf_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from csrc/ with nvcc and its host library
from csrc/host/ with the host C++ compiler, then:
  1. device and build: the card's name and power limit (nvidia-smi), the
     build time, each kernel's registers and spill bytes (ptxas) and its
     HGMMA/HMMA counts (cuobjdump, where the toolkit has it); fails if a
     decode kernel spills at H=256 or is not on wgmma, or an FPS kernel
     instance spills; the host library's build seconds and whether it was
     cached;
  2. fps: the FPS kernel against its plain version on (8, 16384, 3)
     presampled depth clouds with duplicates, npoint 256 (the predict and
     the training shape of seqs_multigeo_4cm), and on (32, 16384, 3) (a
     batch_size-4 config's): 0 index mismatches at both; the plan
     the wrapper launched (cluster size, CTAs, tier), the clusters the card
     runs at once for each size, ms over back-to-back launches and of one
     call between two events, us per iteration;
  3. grid_decode: the grid-decode kernel against its plain bf16-feed
     version on tables of full-width weights at 96x96x56, H=256, 5 blocks,
     its time, TFLOP/s and share of the bf16 peak;
  4. predict: `reconstruct` of the full-width seqs_multigeo_4cm GenNerf
     (seeded random weights) on 8 rendered 120x160 frames, with the launch
     counters reset just before and read just after (and the FPS plan that
     run launched); the volume is checked
     against the same stages run through the plain versions; then a
     profiled call (device busy ms, idle share);
  5. point_decode: the point-decode kernel against its plain bf16-feed
     version on the triplane features and codes of 2^20 points in the
     test volume, its time and share of the peak there and at a view's
     coarse, fine and secant launch sizes;
  6. render: `render_views` of 4 of the frames (the K3-backed march) with
     the counters reset just before and read just after, held against the
     same march on the plain bf16-feed decode; then a profiled view;
  6b. mesh: on the render phase's weights, the 96x96x56 volume of
     `reconstruct` (K2, counters reset just before and read just after) and
     of the same stages through the plain versions, each meshed by
     `TSDF.get_mesh`: both non-empty, `eval_mesh(K2 mesh, plain mesh)` at
     F@5cm >= 0.99; the host ms of marching cubes, eval_mesh and the PLY
     write and load;
  7. predict_sparse: `reconstruct` with sparse_band_decode, and the band
     decode against the dense gather decode clamped by the prior;
  8. train: the training path of the same config (ray supervision, smooth_log
     TSDF loss, autograd, Adam with coupled L2) on `training_batch`'s scene
     of 8 frames, K1 in every step's encode: one step with K1 against the
     same step with the plain FPS on the card (same weights and draws,
     deterministic algorithms),
     then 3 warm-up and 20 timed chained `train_step`s with the counters
     reset just before and read just after (K1 launches must equal the
     steps; the loss must fall), a profiled step, the peak memory, and a
     save / reload into a fresh model and optimizer / step against the
     uninterrupted step;
  9. data: the multigeo dataset written by the port's writer (8 training
     and 2 held-out scenes of 10 frames of 120x160, ground truth at 4 and
     8 cm) into a temporary directory; ScannetDataModule of the same config
     with its 3D augmentation; 2 epochs (16 steps) of `Trainer.fit` over
     the loaders, validating every epoch with the config's monitored
     checkpoints (callbacks.model_checkpoint), with the counters reset just
     before and read just after (K1 launches must equal the steps plus
     the validation encodes, the losses and val_recon_tsdf_l1 finite,
     best_epoch() the epoch of the lowest val_combined), the loader wait
     and step times, TSDF.transform's time per item, the peak memory and a
     profiled loader-fed step; then
     data_eval: both held-out scenes through the predict CLI from the run
     directory (`--ckpt`: the best epoch, selected_by val_combined; K2
     once per scene, each of those outputs held against the plain
     bf16-feed decode of its tables; {scene}.npz and .ply), each scene
     through `evaluation.process` (every metric present and finite, the
     distances inf only for an empty mesh, the re-fusion on the card) and
     the oracle (the scene's own 4 cm fused ground truth as the prediction:
     F@5cm >= 0.99, AbsRel <= 0.02, TSDF L1 0); one held-out view
     rendered through K3, held against the plain march (the hit share
     printed), and one step with K1 against the plain-FPS step on the
     fit's first augmented 480x640 batch;
 10. spatial: configs/experiment/seqs_multigeo_spatial.yaml at full width
     (ResNet-34 stem and 3 stages at feature_scale 2.0 on the loaders'
     480x640 frames, 512 latent channels backprojected into an 80x80x40
     volume beside the pointnet triplanes, d_in 544, frame_chunk 1 with
     remat) from the port's `random:resnet34` backbone graft, on the data
     phase's dataset: one epoch of `Trainer.fit` (8 steps) and its
     validation, counters reset just before and read just after (K1 =
     steps + eval batches + tails, K2 0: the volume scene decodes in f32);
     on one loader batch the remat step against the step without remat
     (loss, gradients, running statistics, peak memory of each), K1 against
     the plain FPS, the frame_chunk encode against the one-pass encode in
     eval mode; timed and profiled train steps; a held-out `reconstruct`
     at 96x96x56 (K1 once, K2 0, finite, inside the head's range), its
     total and decode ms and a profile;
then a `kernels` JSON line, the nvidia-smi line and the final result line.
Every phase raises on failure. Needs one CUDA card; exits non-zero without.
"""
import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

SEED = 0
NUM_FRAMES, HEIGHT, WIDTH = 8, 120, 160
NPOINT, PRESAMPLE = 256, 16384
# clouds of a batch_size-4 training batch (seqs_living_gen_nerf.yaml: 4
# scenes x 8 frames); seqs_multigeo_4cm trains at batch_size 1, (8, 16384)
FPS_BATCH = 32
VOXEL_DIM = (96, 96, 56)
# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, dense bf16 tensor FLOP/s, f32 FLOP/s
PEAK_BYTES, PEAK_BF16, PEAK_F32 = 3.35e12, 989e12, 67e12
# kernel vs plain bf16-feed decode: both round the same values to bf16 but
# accumulate in another order, so a few activations round the other way
# (one bf16 step, 2^-8 of the value) and carry that through later blocks
GRID_MAX_ABS_TOL, GRID_MEAN_ABS_TOL = 5e-2, 1e-3
# the point decode rounds the same values to bf16 as its plain version and
# sums in another order: the grid decode's tolerance, for the same reason
POINT_MAX_ABS_TOL, POINT_MEAN_ABS_TOL = 5e-2, 1e-3
N_POINTS = 1 << 20
NUM_VIEWS = 4
# kernel march vs plain-decode march: a field sample within a bf16 step of
# zero can move a bracket by one step, so a few rays may flip their hit or
# their crossing; 99% of the rays must agree on the hit, and 99% of the
# rays both hit within 1e-3 m
RENDER_MASK_AGREE, RENDER_DEPTH_TOL, RENDER_DEPTH_AGREE = 0.99, 1e-3, 0.99
# sparse band decode vs dense gather decode + prior: both f32, the band's
# coordinates computed as index * step instead of the linspace formula
SPARSE_TOL = 1e-5
# a train step with K1 against the same step with the plain FPS: identical
# indices, so only the order of the scatter_add atomics differs
TRAIN_LOSS_RTOL, TRAIN_GRAD_TOL = 1e-5, 1e-4
TRAIN_WARMUP, TRAIN_STEPS = 3, 20
# the data phase: the multigeo dataset (8 training scenes, 2 held out, 10
# frames of 120x160 each), 2 epochs of one window per scene
DATA_TRAIN_SCENES, DATA_FRAMES, DATA_EPOCHS = 8, 10, 2
# save, reload into a fresh model and optimizer, one step: the same loss up
# to the atomics' order
RESUME_RTOL = 1e-5
# K2's mesh against the plain stages' mesh, and the oracle evaluation (the
# ground truth evaluated as its own prediction through the rasterizer, the
# re-fusion and the KD-tree). The oracle does not reach 1 in either
# package: their marching tetrahedra split each cube around a face
# diagonal, which leaves a quarter of the cube untiled, so every mesh has
# holes that the renders see through to the surface behind
# (tests/test_torch_eval.py holds the two packages' evaluations equal)
MESH_FSCORE_MIN, ORACLE_FSCORE_MIN, ORACLE_ABSREL_MAX = 0.99, 0.90, 0.06
# the evaluation with the re-fusion on the card against the same
# evaluation with it on the CPU: fused volumes within a few ulps
EVAL_DEVICE_TOL = 1e-4
EXPERIMENT = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "configs", "experiment", "seqs_multigeo_4cm.yaml")
# the spatial phase: the combined pointnet + ResNet-34 encoder at full width
SPATIAL_EXPERIMENT = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                  "configs", "experiment", "seqs_multigeo_spatial.yaml")
SPATIAL_BACKBONE = "random:resnet34"
SPATIAL_EPOCHS, SPATIAL_TIMED_STEPS = 1, 5
# remat against no remat on one batch, same weights and draws: the same
# arithmetic, recomputed, so the loss and the running statistics agree to
# the atomics' order of the gathers' backward, the gradients as K1's do
REMAT_LOSS_RTOL, REMAT_GRAD_TOL, REMAT_STATS_TOL = 1e-5, 1e-4, 1e-6
# frame_chunk 1 against the one-pass encode in eval mode: the same
# convolutions on a batch of 1 or of 8 frames (cuDNN may pick another
# algorithm), the volume summed in the same frame order
CHUNK_REL_TOL = 1e-5
PRIMITIVES = [
    {"type": "sphere", "center": (1.45, 1.75, 0.45), "radius": 0.45},
    {"type": "box", "min": (1.75, 1.05, 0.0), "max": (2.25, 1.55, 0.6)},
]
SCENE_CENTER = (1.6, 1.6, 0.4)


def emit(record: dict) -> None:
    print(json.dumps(record), flush=True)


def host_ms(torch, fn, reps: int, warmup: int = 1) -> float:
    """Median wall time of fn() ending in a device synchronize, in ms."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def profile_device(torch, fn, total_ms: float, card: str) -> dict:
    """Device busy ms and idle share of one fn() call: device-side events
    of one profiled call (host-side op events would count their kernels
    twice, and so would the device-side spans of annotated host ranges
    such as Optimizer.step, which carry a host event's name), against its
    unprofiled wall time; and the host ops taking the most host time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = prof.key_averages()
    host = {e.key for e in events if e.device_type == DeviceType.CPU}
    kernel_us = sorted(((e.key, e.self_device_time_total, e.count) for e in events
                        if e.device_type == DeviceType.CUDA and e.key not in host
                        and e.self_device_time_total > 0), key=lambda d: -d[1])
    host_us = sorted(((e.key, e.self_cpu_time_total, e.count) for e in events
                      if e.device_type == DeviceType.CPU), key=lambda d: -d[1])
    busy_ms = sum(d[1] for d in kernel_us) / 1e3
    return {"device_busy_ms": busy_ms, "unprofiled_total_ms": total_ms,
            "device_idle_share": 1 - busy_ms / total_ms,
            "kernels_launched": sum(d[2] for d in kernel_us),
            "fps_kernel_ms": sum(d[1] for d in kernel_us if "fps_" in d[0]) / 1e3,
            "top": [{"name": k[:80], "ms": us / 1e3, "calls": n} for k, us, n in kernel_us[:12]],
            "host_top": [{"name": k[:60], "self_ms": us / 1e3, "calls": n}
                         for k, us, n in host_us[:8]],
            "card": card}


def k1_step_vs_plain(torch, dev, model, batch: dict, seed: int) -> dict:
    """One train step's loss and gradients with K1 against the same step
    with the plain FPS patched into the encoder, on the same weights and
    draws; raises when they disagree beyond TRAIN_LOSS_RTOL and
    TRAIN_GRAD_TOL. The steps run with torch's deterministic algorithms
    (scatter_add's atomics otherwise add in any order, which a gradient
    that cancels to a small sum, like a UNet bias's on a 480x640 batch,
    magnifies to 1e-3 of its max-abs); the K1 step runs twice to show that
    floor. These launches are a comparison, not the main path."""
    import contextlib
    from unittest import mock

    from gennerf_tpu_torch.models import gen_nerf as gen_nerf_module
    from gennerf_tpu_torch.ops import kernels
    from gennerf_tpu_torch.ops.sampling import farthest_point_sample_plain
    from gennerf_tpu_torch.train.step import StepDraws, gen_nerf_forward_loss

    cfg = model.cfg
    B, T, H, W = batch["depth"].shape
    BT, HW = B * T, H * W
    R = cfg.ray.num_rays
    presample = cfg.encoder.pointnet.fps_presample
    g = torch.Generator(device=dev).manual_seed(seed)
    draws = StepDraws(sel=torch.randint(0, HW, (BT, presample), generator=g, device=dev),
                      start=torch.randint(0, presample, (BT,), generator=g, device=dev),
                      scores=torch.rand((BT, HW), generator=g, device=dev),
                      noise=torch.randn((BT, R, cfg.ray.M), generator=g, device=dev))

    def plain_fps(xyz, npoint, generator=None, start=None):
        idx = farthest_point_sample_plain(xyz, npoint, start)
        return torch.gather(xyz, 1, idx.long()[..., None].expand(-1, -1, 3)), idx

    def one_step(plain: bool):
        model.zero_grad(set_to_none=True)
        before = kernels.FPS.launches
        patch = (mock.patch.object(gen_nerf_module, "farthest_point_sample", plain_fps) if plain
                 else contextlib.nullcontext())
        with patch:
            loss, _ = gen_nerf_forward_loss(model, batch, draws=draws)
            loss.backward()
        torch.cuda.synchronize()
        return (float(loss.detach()), {n: p.grad.clone() for n, p in model.named_parameters()},
                kernels.FPS.launches - before)

    def grad_err(a, b):
        return {n: float((a[n] - b[n]).abs().max()) / max(float(b[n].abs().max()), 1e-30)
                for n in b}

    deterministic = (torch.are_deterministic_algorithms_enabled(),
                     torch.backends.cudnn.deterministic)
    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.backends.cudnn.deterministic = True
    try:
        loss_k, grads_k, k1_kernel = one_step(plain=False)
        _, grads_k2, _ = one_step(plain=False)
        loss_p, grads_p, k1_plain = one_step(plain=True)
    finally:
        torch.use_deterministic_algorithms(deterministic[0])
        torch.backends.cudnn.deterministic = deterministic[1]
    model.zero_grad(set_to_none=True)
    err = grad_err(grads_k, grads_p)
    worst = max(err, key=err.get)
    vs_plain = {"frames": [T, H, W], "loss_kernel": loss_k, "loss_plain": loss_p,
                "loss_rel_err": abs(loss_k - loss_p) / abs(loss_p),
                "worst_grad": worst, "worst_grad_err_over_max_abs": err[worst],
                "kernel_repeat_worst_grad_err": max(grad_err(grads_k2, grads_k).values()),
                "k1_launches": [k1_kernel, k1_plain]}
    if (k1_kernel, k1_plain) != (1, 0):
        raise RuntimeError(f"the K1 step launched K1 {k1_kernel} times, the plain one {k1_plain}")
    if not (vs_plain["loss_rel_err"] <= TRAIN_LOSS_RTOL and err[worst] <= TRAIN_GRAD_TOL):
        raise RuntimeError(f"train step with K1 disagrees with the plain-FPS step: {vs_plain}")
    return vs_plain


def train_phase(torch, dev, cfg_dict: dict, smi: str) -> dict:
    """Phase 8 (see the module docstring); returns the launch counts of
    the main-path steps."""
    import tempfile

    from gennerf_tpu_torch.data.synthetic import training_batch
    from gennerf_tpu_torch.ops import kernels
    from gennerf_tpu_torch.predict import build_model
    from gennerf_tpu_torch.train.checkpoints import load_checkpoint, save_checkpoint
    from gennerf_tpu_torch.train.state import make_optimizer
    from gennerf_tpu_torch.train.step import batch_to_device, train_step
    from gennerf_tpu_torch.utils.config import load_experiment_config

    clip = load_experiment_config(EXPERIMENT, "train")["trainer"].get("gradient_clip_val")
    t0 = time.perf_counter()
    batch_np = training_batch(1, NUM_FRAMES, HEIGHT, WIDTH, cfg_dict["voxel_dim_train"],
                              cfg_dict["voxel_size"], SEED)
    batch_s = time.perf_counter() - t0
    batch = batch_to_device(batch_np, dev)
    model = build_model(cfg_dict, dev, SEED)
    cfg = model.cfg
    opt = make_optimizer(model.parameters(), cfg.optimizer, clip)
    BT = NUM_FRAMES
    R, S = cfg.ray.num_rays, 1 + cfg.ray.N + cfg.ray.M

    # one step with K1 against the same step with the plain FPS on the card
    vs_plain = k1_step_vs_plain(torch, dev, model, batch, SEED)
    # the main path: chained steps, counters reset just before, read just after
    gen = torch.Generator(device=dev).manual_seed(SEED)
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    losses, step_ms = [], []
    for i in range(TRAIN_WARMUP + TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics = train_step(model, opt, batch, gen)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(metrics["combined"]))
    launches = {k.name: k.launches for k in kernels.KERNELS}
    fps_launched = dict(kernels.FPS.last_launch or {})
    peak_bytes = torch.cuda.max_memory_allocated()
    n_steps = TRAIN_WARMUP + TRAIN_STEPS
    med_ms = statistics.median(step_ms[TRAIN_WARMUP:])
    # the same steps without a synchronize between them
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(TRAIN_STEPS):
        metrics = train_step(model, opt, batch, gen)
    torch.cuda.synchronize()
    chained_ms = (time.perf_counter() - t0) * 1e3 / TRAIN_STEPS
    losses.append(float(metrics["combined"]))
    prof = profile_device(torch, lambda: train_step(model, opt, batch, gen), med_ms, smi)

    # save, reload into a fresh model and optimizer, one step
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "train.pt")
        save_checkpoint(path, model, opt, epoch=0, step=n_steps, generator=gen)
        loss_a = float(train_step(model, opt, batch, gen)["combined"])
        fresh = build_model(cfg_dict, dev, SEED + 1)
        fresh_opt = make_optimizer(fresh.parameters(), cfg.optimizer, clip)
        fresh_gen = torch.Generator(device=dev)
        load_checkpoint(path, fresh, fresh_opt, fresh_gen)
        loss_b = float(train_step(fresh, fresh_opt, batch, fresh_gen)["combined"])
    resume_rel = abs(loss_a - loss_b) / abs(loss_a)

    emit({"phase": "train", "config": "configs/experiment/seqs_multigeo_4cm.yaml",
          "batch": {"scenes": 1, "frames": [NUM_FRAMES, HEIGHT, WIDTH],
                    "voxel_dim": list(cfg.voxel_dim_train), "built_s": batch_s},
          "points_per_step": BT * R * S, "optimizer": dataclasses.asdict(cfg.optimizer),
          "gradient_clip_val": clip, "vs_plain_fps": vs_plain,
          "tolerance": {"loss_rel": TRAIN_LOSS_RTOL, "grad_over_max_abs": TRAIN_GRAD_TOL,
                        "resume_loss_rel": RESUME_RTOL},
          "steps": n_steps, "launches": launches, "k1_launches_per_step": launches["fps"] / n_steps,
          "fps_launched": fps_launched, "step_ms_median": med_ms,
          "step_ms_first": step_ms[0], "chained_ms_per_step": chained_ms,
          "loss_first": losses[0], "loss_last": losses[-1],
          "peak_memory_bytes": peak_bytes, "resume": {"loss": loss_a, "loss_resumed": loss_b,
                                                      "rel_err": resume_rel},
          "card": smi})
    emit({"phase": "train_profile", "what": "one train_step (forward, backward, Adam)",
          "k1_share": prof["fps_kernel_ms"] / prof["device_busy_ms"], **prof})
    if not all(math.isfinite(x) for x in losses) or losses[-1] >= losses[0]:
        raise RuntimeError(f"training did not lower the loss on its fixed batch: {losses}")
    if launches["fps"] != n_steps:
        raise RuntimeError(f"K1 launched {launches['fps']} times in {n_steps} train steps")
    if resume_rel > RESUME_RTOL:
        raise RuntimeError(f"the resumed step disagrees: {loss_b} against {loss_a}")
    return launches


def data_phase(torch, dev, smi: str, root: str) -> dict:
    """Phase 9 (see the module docstring): writes the multigeo dataset to
    `root`; returns the launch counts of the main-path runs (the fit, the
    held-out predict, the render)."""
    import tempfile
    from unittest import mock

    import numpy as np

    from gennerf_tpu_torch.data.datamodule import ScannetDataModule
    from gennerf_tpu_torch.data.make_multigeo import make_multigeo
    from gennerf_tpu_torch.ops import grid_decode as grid_decode_module
    from gennerf_tpu_torch.ops import kernels
    from gennerf_tpu_torch import predict as predict_cli
    from gennerf_tpu_torch.data.datasets import load_info_json, parse_splits_list
    from gennerf_tpu_torch.eval import evaluation
    from gennerf_tpu_torch.predict import build_model
    from gennerf_tpu_torch.render import render_encoded
    from gennerf_tpu_torch.train import loop as loop_module
    from gennerf_tpu_torch.train.checkpoints import CheckpointManager
    from gennerf_tpu_torch.train.loop import Trainer
    from gennerf_tpu_torch.train.predict import make_point_tsdf_fn, uses_grid_decode
    from gennerf_tpu_torch.train.state import make_optimizer
    from gennerf_tpu_torch.train.step import batch_to_device, train_step
    from gennerf_tpu_torch.tsdf import tsdf as tsdf_module
    from gennerf_tpu_torch.utils.config import load_experiment_config

    totals = {k.name: 0 for k in kernels.KERNELS}

    def add_launches():
        for k in kernels.KERNELS:
            totals[k.name] += k.launches

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        make_multigeo(root, train=DATA_TRAIN_SCENES, frames=DATA_FRAMES, height=HEIGHT,
                      width=WIDTH, voxel_sizes=(4, 8))
        write_s = time.perf_counter() - t0
        cfg = load_experiment_config(EXPERIMENT, "train", [f"paths.data_dir={root}"])
        data_cfg, trainer_cfg = cfg["data"], cfg["trainer"]
        if not (data_cfg["random_rotation_3d"] and data_cfg["random_translation_3d"]):
            raise RuntimeError("the data phase needs the config's augmentation on")
        datamodule = ScannetDataModule(data_cfg, seed=SEED)
        train_loader = datamodule.train_dataloader()
        model = build_model(cfg["model"], dev, SEED)
        opt = make_optimizer(model.parameters(), model.cfg.optimizer,
                             trainer_cfg.get("gradient_clip_val"))

        # the fit's first batch, from a second module of the same seed: the
        # fit's own loader starts at its first epoch
        t0 = time.perf_counter()
        first = next(iter(ScannetDataModule(data_cfg, seed=SEED).train_dataloader()))
        first_batch_s = time.perf_counter() - t0

        # the main path: Trainer.fit over the loaders, validating every epoch
        # with the config's monitored checkpoints, counters reset just
        # before and read just after; TSDF.transform timed in the workers,
        # the validation encodes (eval steps and reconstruction tails) counted
        transform_s = []
        real_transform = tsdf_module.TSDF.transform

        def timed_transform(self, *a, **k):
            t = time.perf_counter()
            out = real_transform(self, *a, **k)
            transform_s.append(time.perf_counter() - t)
            return out

        val_encodes, val_records = [], []

        def counted(fn):
            def wrapper(*a, **k):
                val_encodes.append(fn.__name__)
                return fn(*a, **k)
            return wrapper

        real_validate = loop_module.Trainer.validate

        def recorded_validate(self, *a, **k):
            out = real_validate(self, *a, **k)
            val_records.append(out)
            return out

        run_dir = os.path.join(tmp, "run")
        run_cfg = load_experiment_config(EXPERIMENT, "train", [f"paths.data_dir={root}",
                                                               f"paths.output_dir={run_dir}"])
        ckpt_cfg = run_cfg["callbacks"]["model_checkpoint"]
        checkpoints = CheckpointManager(ckpt_cfg["dirpath"], ckpt_cfg["save_top_k"],
                                        monitor=ckpt_cfg["monitor"], mode=ckpt_cfg["mode"])
        trainer = Trainer(model, opt, torch.Generator(device=dev).manual_seed(SEED), run_dir,
                          max_epochs=DATA_EPOCHS, check_val_every_n_epoch=1,
                          checkpoints=checkpoints)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        with mock.patch.object(tsdf_module.TSDF, "transform", timed_transform), \
                mock.patch.object(loop_module, "eval_step", counted(loop_module.eval_step)), \
                mock.patch.object(loop_module, "reconstruct", counted(loop_module.reconstruct)), \
                mock.patch.object(loop_module.Trainer, "validate", recorded_validate):
            t0 = time.perf_counter()
            trainer.fit(train_loader, datamodule.val_dataloader())
            fit_s = time.perf_counter() - t0
        fit_launches = {k.name: k.launches for k in kernels.KERNELS}
        add_launches()
        peak_bytes = torch.cuda.max_memory_allocated()
        steps = trainer.global_step  # fit raises on a non-finite loss
        waits = [t["data_wait_ms"] for t in trainer.timings]
        step_ms = [t["step_ms"] for t in trainer.timings]
        # one profiled loader-fed step: the next batch from a running loader, then the step
        it = iter(train_loader)
        next(it)
        prof = profile_device(
            torch, lambda: train_step(model, opt, batch_to_device(next(it), dev), trainer.generator),
            statistics.median(step_ms) + statistics.median(waits), smi)
        del it
        val_combined = [r["val_combined"] for r in val_records]
        recon_l1 = [r.get("val_recon_tsdf_l1") for r in val_records]
        best_epoch = checkpoints.best_epoch()
        emit({"phase": "data", "config": "configs/experiment/seqs_multigeo_4cm.yaml",
              "dataset": {"train_scenes": DATA_TRAIN_SCENES, "held_out": 2, "frames": DATA_FRAMES,
                          "image": [HEIGHT, WIDTH], "voxel_sizes_cm": [4, 8],
                          "write_s": write_s},
              "loader": {"num_workers": data_cfg.get("num_workers_train"),
                         "batch_frames": list(first["depth"].shape),
                         "volume": list(first["vol_%02d_tsdf" % round(
                             100 * data_cfg["voxel_size"])].shape),
                         "first_batch_s": first_batch_s},
              "steps": steps, "epochs": DATA_EPOCHS, "launches": fit_launches,
              "validation": {"val_combined": val_combined, "val_recon_tsdf_l1": recon_l1,
                             "encodes": {n: val_encodes.count(n) for n in set(val_encodes)},
                             "best_epoch": best_epoch, "kept_epochs": checkpoints.kept_epochs(),
                             "monitor": ckpt_cfg["monitor"], "save_top_k": ckpt_cfg["save_top_k"],
                             "local_files": sorted(
                                 os.path.relpath(os.path.join(d, f), run_dir)
                                 for d, _, fs in os.walk(os.path.join(run_dir, "local"))
                                 for f in fs)},
              "fit_s": fit_s, "step_ms_median": statistics.median(step_ms),
              "step_ms_first": step_ms[0], "data_wait_ms_median": statistics.median(waits),
              "data_wait_ms_mean": statistics.mean(waits), "data_wait_ms_first": waits[0],
              "transform_ms_per_item": 1e3 * statistics.mean(transform_s),
              "transform_calls": len(transform_s), "loss_last": trainer.metrics["train_combined"],
              "peak_memory_bytes": peak_bytes, "card": smi})
        emit({"phase": "data_profile", "what": "one loader-fed train_step (next batch + step)",
              "k1_share": prof["fps_kernel_ms"] / max(prof["device_busy_ms"], 1e-9), **prof})
        if (fit_launches["fps"] != steps + len(val_encodes)
                or steps != DATA_EPOCHS * DATA_TRAIN_SCENES):
            raise RuntimeError(f"K1 launched {fit_launches['fps']} times in {steps} steps and "
                               f"{len(val_encodes)} validation encodes")
        if fit_launches["grid_decode"] != DATA_EPOCHS:
            raise RuntimeError(f"the {DATA_EPOCHS} reconstruction tails launched K2 "
                               f"{fit_launches['grid_decode']} times")
        if len(val_records) != DATA_EPOCHS or not all(
                v is not None and math.isfinite(v) for v in recon_l1):
            raise RuntimeError(f"validation tail missing or not finite: {recon_l1}")
        if best_epoch != min(range(DATA_EPOCHS), key=lambda e: (val_combined[e], e)):
            raise RuntimeError(f"best_epoch {best_epoch} is not the lowest val_combined "
                               f"{val_combined}")

        # data_eval: the held-out scenes through the predict CLI from the run
        # directory (its best epoch), then the evaluation
        model.eval()
        head_bias = float(model.head_geo.fc.bias.detach()[0])
        if not uses_grid_decode(model):
            raise RuntimeError("the trained model does not take the grid decode")
        # each counted K2 call is kept, to be held against the plain decode
        decoded = []
        real_k2 = grid_decode_module.grid_decode_cuda

        def recording_k2(tables, weights):
            out = real_k2(tables, weights)
            decoded.append((tables, weights, out))
            return out

        pred_dir = os.path.join(tmp, "pred")
        kernels.reset_launch_counts()
        with mock.patch.object(grid_decode_module, "grid_decode_cuda", recording_k2):
            results = predict_cli.main(["--config", EXPERIMENT, "--ckpt", run_dir, "--data-dir", root,
                                        "--split", "val.txt", "--out", pred_dir,
                                        "--device", dev.type])
        torch.cuda.synchronize()
        predict_launches = {k.name: k.launches for k in kernels.KERNELS}
        add_launches()
        with open(os.path.join(pred_dir, "predict_meta.json")) as f:
            predict_meta = json.load(f)
        if (predict_meta["selected_by"], predict_meta["epoch"]) != (ckpt_cfg["monitor"], best_epoch):
            raise RuntimeError(f"predict restored {predict_meta}, not the best epoch {best_epoch}")
        if not predict_launches["grid_decode"] == len(decoded) == len(results) == 2:
            raise RuntimeError(f"held-out predict launched K2 {predict_launches['grid_decode']} "
                               f"times for {len(results)} scenes")
        # those K2 outputs against the plain bf16-feed decode of the same tables
        grid_err = []
        for tables, weights, out in decoded:
            err = (out - grid_decode_module.separable_grid_decode_plain(
                tables, weights, bf16_feeds=True)).abs()
            grid_err.append((float(err.max()), float(err.mean())))
        grid_max = max(e[0] for e in grid_err)
        grid_mean = max(e[1] for e in grid_err)
        voxel_dim = tuple(decoded[0][2].shape)
        del decoded
        eval_rec = evaluate_held_out(dev, evaluation, parse_splits_list("val.txt", root),
                                     pred_dir, os.path.join(tmp, "oracle"), load_info_json)
        emit({"phase": "data_eval", "predict_meta": predict_meta,
              "predict_launches": predict_launches, "scenes": eval_rec,
              "oracle_gates": {"fscore_min": ORACLE_FSCORE_MIN, "AbsRel_max": ORACLE_ABSREL_MAX,
                               "l1": 0.0},
              "card": smi})

        # one held-out view from the trained weights: K3's march against the plain march
        scene_batch = next(iter(datamodule.predict_dataloader()))
        scene = scene_batch["scene"][0]
        frames = {k: torch.as_tensor(scene_batch[k][0]).to(dev)
                  for k in ("projection", "image", "depth", "intrinsics", "pose")}
        with torch.no_grad():
            repr_ = model.encode(frames["projection"][None], frames["image"][None],
                                 frames["depth"][None], torch.Generator().manual_seed(SEED))
        render_args = (model, repr_, frames["depth"], frames["intrinsics"], frames["pose"])
        kernels.reset_launch_counts()
        rk = render_encoded(*render_args, make_point_tsdf_fn(model, repr_), 1)
        torch.cuda.synchronize()
        render_launches = {k.name: k.launches for k in kernels.KERNELS}
        add_launches()
        rp = render_encoded(*render_args, make_point_tsdf_fn(model, repr_, plain=True), 1)
        hk, hp = rk["ray_depth"] > 0, rp["ray_depth"] > 0
        mask_agree = float((hk == hp).mean())
        ddiff = np.abs(rk["ray_depth"] - rp["ray_depth"])[hk & hp]
        depth_agree = float((ddiff <= RENDER_DEPTH_TOL).mean()) if ddiff.size else 1.0
        emit({"phase": "data_predict", "scenes": results, "head_bias": head_bias,
              "launches": predict_launches, "voxel_dim": list(voxel_dim),
              "grid_vs_plain": {"max_abs": grid_max, "mean_abs": grid_mean},
              "grid_tolerance": {"max_abs": GRID_MAX_ABS_TOL, "mean_abs": GRID_MEAN_ABS_TOL},
              "render": {"scene": scene, "view": [int(v) for v in rk["views"]],
                         "image": list(frames["depth"].shape[-2:]),
                         "launches": render_launches, "hit_share": float(hk.mean()),
                         "hit_share_plain": float(hp.mean()),
                         "vs_plain_mask_agree": mask_agree, "vs_plain_depth_agree": depth_agree,
                         "both_hit_rays": int(ddiff.size)},
              "render_tolerance": {"mask_agree": RENDER_MASK_AGREE, "depth_m": RENDER_DEPTH_TOL,
                                   "depth_agree": RENDER_DEPTH_AGREE},
              "eval_tsdf_l1_16_steps_not_quality": {k: v.get("l1") for k, v in results.items()},
              "card": smi})
        if not (grid_max <= GRID_MAX_ABS_TOL and grid_mean <= GRID_MEAN_ABS_TOL):
            raise RuntimeError(f"K2 on trained weights disagrees: max {grid_max}, mean {grid_mean}")
        if render_launches["point_decode"] < 1:
            raise RuntimeError("the held-out render launched no point_decode kernel")
        if mask_agree < RENDER_MASK_AGREE or depth_agree < RENDER_DEPTH_AGREE:
            raise RuntimeError(f"K3 march on trained weights disagrees with the plain march: "
                               f"masks {mask_agree}, depths {depth_agree}")

        # K1 against the plain FPS on the first augmented 480x640 loader batch
        vs_plain = k1_step_vs_plain(torch, dev, model, batch_to_device(first, dev), SEED)
        emit({"phase": "data_vs_plain_fps", "vs_plain_fps": vs_plain,
              "tolerance": {"loss_rel": TRAIN_LOSS_RTOL, "grad_over_max_abs": TRAIN_GRAD_TOL},
              "card": smi})
    return totals


def spatial_phase(torch, dev, smi: str, root: str) -> dict:
    """Phase 10 (see the module docstring); returns the launch counts of
    the main-path runs (the fit with its validation, the reconstruct)."""
    from unittest import mock

    from gennerf_tpu_torch.data.datamodule import ScannetDataModule
    from gennerf_tpu_torch.models.gen_nerf import GenNerf
    from gennerf_tpu_torch.ops import kernels
    from gennerf_tpu_torch.predict import build_model, reconstruct
    from gennerf_tpu_torch.tools.port_backbone import main as port_backbone
    from gennerf_tpu_torch.train import loop as loop_module
    from gennerf_tpu_torch.train.checkpoints import CheckpointManager
    from gennerf_tpu_torch.train.loop import Trainer
    from gennerf_tpu_torch.train.predict import predict_tsdf_volume, uses_grid_decode
    from gennerf_tpu_torch.train.state import make_optimizer
    from gennerf_tpu_torch.train.step import StepDraws, batch_to_device, gen_nerf_forward_loss
    from gennerf_tpu_torch.train.step import train_step
    from gennerf_tpu_torch.utils.config import load_experiment_config

    totals = {k.name: 0 for k in kernels.KERNELS}

    def read_launches():
        counts = {k.name: k.launches for k in kernels.KERNELS}
        for name, n in counts.items():
            totals[name] += n
        return counts

    with tempfile.TemporaryDirectory() as tmp:
        backbone = os.path.join(tmp, "backbone.npz")
        port_backbone([SPATIAL_BACKBONE, backbone])
        run_dir = os.path.join(tmp, "run")
        cfg = load_experiment_config(SPATIAL_EXPERIMENT, "train", [
            f"paths.data_dir={root}", f"paths.output_dir={run_dir}",
            f"model.encoder.spatial.pretrained_path={backbone}"])
        data_cfg, trainer_cfg = cfg["data"], cfg["trainer"]
        datamodule = ScannetDataModule(data_cfg, seed=SEED)
        model = build_model(cfg["model"], dev, SEED)
        mcfg = model.cfg
        if not (mcfg.encoder.use_spatial and mcfg.encoder.use_pointnet and mcfg.remat
                and mcfg.encoder.spatial.frame_chunk == 1) or uses_grid_decode(model):
            raise RuntimeError(f"not the spatial drive config: {mcfg.encoder}")
        opt = make_optimizer(model.parameters(), mcfg.optimizer,
                             trainer_cfg.get("gradient_clip_val"))
        ckpt_cfg = cfg["callbacks"]["model_checkpoint"]
        checkpoints = CheckpointManager(ckpt_cfg["dirpath"], ckpt_cfg["save_top_k"],
                                        monitor=ckpt_cfg["monitor"], mode=ckpt_cfg["mode"])
        trainer = Trainer(model, opt, torch.Generator(device=dev).manual_seed(SEED), run_dir,
                          max_epochs=SPATIAL_EPOCHS, check_val_every_n_epoch=1,
                          checkpoints=checkpoints)
        encodes = []

        def counted(fn):
            def wrapper(*a, **k):
                encodes.append(fn.__name__)
                return fn(*a, **k)
            return wrapper

        # the main path: the fit over the loaders with its validation and
        # reconstruction tail, counters reset just before and read just after
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        with mock.patch.object(loop_module, "eval_step", counted(loop_module.eval_step)), \
                mock.patch.object(loop_module, "reconstruct", counted(loop_module.reconstruct)):
            t0 = time.perf_counter()
            trainer.fit(datamodule.train_dataloader(), datamodule.val_dataloader())
            torch.cuda.synchronize()
            fit_s = time.perf_counter() - t0
        fit_launches = read_launches()
        fit_peak = torch.cuda.max_memory_allocated()
        steps = trainer.global_step  # fit raises on a non-finite loss
        step_ms = [t["step_ms"] for t in trainer.timings]
        waits = [t["data_wait_ms"] for t in trainer.timings]
        n_eval, n_tail = encodes.count("eval_step"), encodes.count("reconstruct")
        fit_rec = {"steps": steps, "eval_batches": n_eval, "tails": n_tail,
                   "launches": fit_launches, "fit_s": fit_s,
                   "step_ms_median": statistics.median(step_ms), "step_ms_first": step_ms[0],
                   "data_wait_ms_median": statistics.median(waits),
                   "loss_last": trainer.metrics["train_combined"],
                   "val_combined": trainer.metrics.get("val_combined"),
                   "val_recon_tsdf_l1": trainer.metrics.get("val_recon_tsdf_l1"),
                   "peak_memory_bytes": fit_peak}
        if fit_launches["fps"] != steps + n_eval + n_tail or fit_launches["grid_decode"] != 0:
            raise RuntimeError(f"the spatial fit launched K1 {fit_launches['fps']} times in "
                               f"{steps} steps, {n_eval} eval batches and {n_tail} tails, K2 "
                               f"{fit_launches['grid_decode']} times")
        if not (n_tail == SPATIAL_EPOCHS and math.isfinite(fit_rec["val_recon_tsdf_l1"])):
            raise RuntimeError(f"the spatial validation tail is missing or not finite: {fit_rec}")

        # one loader batch for the comparisons and the timed steps
        batch = batch_to_device(next(iter(ScannetDataModule(data_cfg, seed=SEED)
                                          .train_dataloader())), dev)
        B, T, H, W = batch["depth"].shape
        fitted = {k: v.clone() for k, v in model.state_dict().items()}

        # remat against no remat: one forward and backward in training mode
        g = torch.Generator(device=dev).manual_seed(SEED)
        presample = mcfg.encoder.pointnet.fps_presample
        draws = StepDraws(
            sel=torch.randint(0, H * W, (B * T, presample), generator=g, device=dev),
            start=torch.randint(0, presample, (B * T,), generator=g, device=dev),
            scores=torch.rand((B * T, H * W), generator=g, device=dev),
            noise=torch.randn((B * T, mcfg.ray.num_rays, mcfg.ray.M), generator=g, device=dev))
        plain = GenNerf(dataclasses.replace(mcfg, remat=False)).to(dev)

        def forward_backward(m):
            m.load_state_dict(fitted)
            m.train()
            m.zero_grad(set_to_none=True)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t = time.perf_counter()
            loss, _ = gen_nerf_forward_loss(m, batch, draws=draws)
            loss.backward()
            torch.cuda.synchronize()
            stats = {k: v.clone() for k, v in m.state_dict().items() if "running_" in k}
            return (float(loss.detach()), {n: p.grad.clone() for n, p in m.named_parameters()},
                    stats, torch.cuda.max_memory_allocated(), (time.perf_counter() - t) * 1e3)

        loss_r, grads_r, stats_r, peak_r, ms_r = forward_backward(model)
        loss_p, grads_p, stats_p, peak_p, ms_p = forward_backward(plain)
        grad_err = {n: float((grads_r[n] - grads_p[n]).abs().max())
                    / max(float(grads_p[n].abs().max()), 1e-30) for n in grads_p}
        stats_err = max(float((stats_r[k] - stats_p[k]).abs().max())
                        / max(float(stats_p[k].abs().max()), 1e-30) for k in stats_p)
        moved = sum(not torch.equal(stats_r[k], fitted[k]) for k in stats_r)
        worst = max(grad_err, key=grad_err.get)
        remat_rec = {"loss_remat": loss_r, "loss_plain": loss_p,
                     "loss_rel_err": abs(loss_r - loss_p) / abs(loss_p),
                     "worst_grad": worst, "worst_grad_err_over_max_abs": grad_err[worst],
                     "running_stats_rel_err": stats_err, "running_stats_moved": moved,
                     "running_stats": len(stats_r), "peak_memory_bytes_remat": peak_r,
                     "peak_memory_bytes_no_remat": peak_p, "forward_backward_ms_remat": ms_r,
                     "forward_backward_ms_no_remat": ms_p,
                     "tolerance": {"loss_rel": REMAT_LOSS_RTOL, "grad_over_max_abs": REMAT_GRAD_TOL,
                                   "stats_rel": REMAT_STATS_TOL}}
        del plain, grads_r, grads_p
        if not (remat_rec["loss_rel_err"] <= REMAT_LOSS_RTOL and grad_err[worst] <= REMAT_GRAD_TOL
                and stats_err <= REMAT_STATS_TOL and moved == len(stats_r)):
            raise RuntimeError(f"the remat step disagrees with the step without remat: {remat_rec}")

        # K1 against the plain FPS on the same batch (deterministic algorithms)
        model.load_state_dict(fitted)
        model.train()
        t0 = time.perf_counter()
        vs_plain = k1_step_vs_plain(torch, dev, model, batch, SEED)
        vs_plain["three_deterministic_steps_s"] = time.perf_counter() - t0

        # frame_chunk 1 against the one-pass encode, eval mode
        model.load_state_dict(fitted)
        one_pass = GenNerf(dataclasses.replace(mcfg, encoder=dataclasses.replace(
            mcfg.encoder, spatial=dataclasses.replace(mcfg.encoder.spatial, frame_chunk=0))))
        one_pass.load_state_dict(fitted)
        one_pass = one_pass.to(dev).eval()
        model.eval()
        enc_args = (batch["projection"], batch["image"], batch["depth"], None, draws.sel,
                    draws.start, mcfg.voxel_dim_train)
        with torch.no_grad():
            chunked_repr = model.encode(*enc_args)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            one_repr = one_pass.encode(*enc_args)
            torch.cuda.synchronize()
        one_pass_peak = torch.cuda.max_memory_allocated()

        def rel(a, b):
            return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)

        chunk_rec = {"volume_rel_err": rel(chunked_repr.volume, one_repr.volume),
                     "valid_equal": bool(torch.equal(chunked_repr.valid, one_repr.valid)),
                     "planes_rel_err": max(rel(chunked_repr.planes[k], one_repr.planes[k])
                                           for k in one_repr.planes),
                     "one_pass_encode_peak_memory_bytes": one_pass_peak,
                     "tolerance_rel": CHUNK_REL_TOL}
        del one_pass, one_repr, chunked_repr
        if not (chunk_rec["volume_rel_err"] <= CHUNK_REL_TOL and chunk_rec["valid_equal"]
                and chunk_rec["planes_rel_err"] <= CHUNK_REL_TOL):
            raise RuntimeError(f"chunked and one-pass encodes disagree: {chunk_rec}")

        # timed train steps on the loader batch, and one profiled step
        model.load_state_dict(fitted)
        gen = torch.Generator(device=dev).manual_seed(SEED)
        train_ms = []
        for _ in range(2 + SPATIAL_TIMED_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            train_step(model, opt, batch, gen)
            torch.cuda.synchronize()
            train_ms.append((time.perf_counter() - t0) * 1e3)
        med_ms = statistics.median(train_ms[2:])
        prof = profile_device(torch, lambda: train_step(model, opt, batch, gen), med_ms, smi)

        # predict: one held-out scene at the test grid from the fitted weights
        model.load_state_dict(fitted)
        model.eval()
        scene = next(iter(datamodule.predict_dataloader()))
        P, image, depth = (torch.as_tensor(scene[k][0]).to(dev)
                           for k in ("projection", "image", "depth"))
        voxel_dim = tuple(mcfg.voxel_dim_test)
        kernels.reset_launch_counts()
        vol = reconstruct(model, P, image, depth, voxel_dim, torch.Generator().manual_seed(SEED))
        torch.cuda.synchronize()
        predict_launches = read_launches()
        smoothing = mcfg.mlp.head_smoothing
        if tuple(vol.shape) != voxel_dim or not torch.isfinite(vol).all() \
                or float(vol.abs().max()) > max(smoothing, 1.0):
            raise RuntimeError(f"spatial volume {tuple(vol.shape)} not finite or out of range")
        if (predict_launches["fps"], predict_launches["grid_decode"]) != (1, 0):
            raise RuntimeError(f"the spatial reconstruct launched {predict_launches}")
        total_ms = host_ms(torch, lambda: reconstruct(model, P, image, depth, voxel_dim,
                                                      torch.Generator().manual_seed(SEED)), 3)
        origin = torch.zeros(3, device=dev)
        with torch.no_grad():
            repr_ = model.encode(P[None], image[None], depth[None],
                                 torch.Generator().manual_seed(SEED), voxel_dim=voxel_dim)
        decode_ms = host_ms(torch, lambda: predict_tsdf_volume(model, repr_, voxel_dim,
                                                               mcfg.voxel_size, origin), 3)
        predict_prof = profile_device(torch, lambda: reconstruct(
            model, P, image, depth, voxel_dim, torch.Generator().manual_seed(SEED)), total_ms, smi)

        emit({"phase": "spatial", "config": "configs/experiment/seqs_multigeo_spatial.yaml",
              "backbone": SPATIAL_BACKBONE, "d_in": mcfg.encoder_latent,
              "batch": {"frames": [T, H, W], "resnet_input": [2 * H, 2 * W],
                        "voxel_dim_train": list(mcfg.voxel_dim_train)},
              "fit": fit_rec, "remat_vs_plain": remat_rec, "vs_plain_fps": vs_plain,
              "vs_plain_fps_tolerance": {"loss_rel": TRAIN_LOSS_RTOL,
                                         "grad_over_max_abs": TRAIN_GRAD_TOL},
              "chunked_vs_one_pass": chunk_rec,
              "train_step_ms": {"median": med_ms, "all": train_ms},
              "predict": {"scene": scene["scene"][0], "voxel_dim": list(voxel_dim),
                          "launches": predict_launches, "total_ms": total_ms,
                          "decode_ms": decode_ms, "out_abs_max": float(vol.abs().max())},
              "card": smi})
        emit({"phase": "spatial_profile", "what": "one loader-batch spatial train_step",
              "k1_share": prof["fps_kernel_ms"] / max(prof["device_busy_ms"], 1e-9), **prof})
        emit({"phase": "spatial_predict_profile",
              "what": "one spatial reconstruct at the test grid", **predict_prof})
    return totals


def evaluate_held_out(dev, evaluation, info_files, pred_dir: str, oracle_dir: str,
                      load_info_json) -> dict:
    """`evaluation.process` on each held-out scene's prediction (every
    metric present and finite, the distances inf only for an empty mesh),
    with the re-fusion's tensors on `dev` (the card), and on the oracle: the
    scene's own fused 4 cm ground truth written as the prediction (npz and
    its mesh), held to F@5cm >= ORACLE_FSCORE_MIN, AbsRel <=
    ORACLE_ABSREL_MAX and TSDF L1 0. Each evaluation is held against the
    same one with the re-fusion on the CPU (EVAL_DEVICE_TOL). Returns
    {scene: {"pred", "oracle", host ms each, the largest CPU difference}}."""
    from unittest import mock

    from gennerf_tpu_torch.eval.metrics import DEPTH_METRICS
    from gennerf_tpu_torch.tsdf.tsdf import TSDF
    from gennerf_tpu_torch.utils.mesh import Mesh

    keys = DEPTH_METRICS + ("l1", "dist1", "dist2", "prec", "recal", "fscore")
    devices = set()

    class RecordingFusion(evaluation.TSDFFusion):
        def integrate(self, projection, depth):
            super().integrate(projection, depth)
            devices.update(t.device.type for t in (*self.state, projection, depth))

    os.makedirs(oracle_dir)
    out = {}
    for info_file in info_files:
        info = load_info_json(info_file)
        scene = info["scene"]
        gt = TSDF.load(info["file_name_vol_04"])
        gt.save(os.path.join(oracle_dir, f"{scene}.npz"))
        gt.get_mesh().export(os.path.join(oracle_dir, f"{scene}.ply"))
        rec = {}
        for name, results_dir in (("pred", pred_dir), ("oracle", oracle_dir)):
            t0 = time.perf_counter()
            with mock.patch.object(evaluation, "TSDFFusion", RecordingFusion):
                metrics = evaluation.process(info_file, results_dir, device=dev)
            rec[f"{name}_host_ms"] = (time.perf_counter() - t0) * 1e3
            rec[name] = metrics
            empty = Mesh.load(os.path.join(results_dir, f"{scene}.ply")).is_empty
            rec[f"{name}_mesh_empty"] = empty
            bad = [k for k in keys if k not in metrics or not (
                math.isfinite(metrics[k]) or (empty and k in ("dist1", "dist2")
                                              and metrics[k] == math.inf))]
            if bad:
                raise RuntimeError(f"{scene} {name}: metrics missing or not finite: {bad} "
                                   f"in {metrics}")
            on_cpu = evaluation.process(info_file, results_dir, device="cpu")
            diff = max((abs(metrics[k] - on_cpu[k]) for k in keys
                        if math.isfinite(metrics[k]) or metrics[k] != on_cpu[k]), default=0.0)
            rec[f"{name}_vs_cpu_max_abs"] = diff
            if not diff <= EVAL_DEVICE_TOL:
                raise RuntimeError(f"{scene} {name}: the evaluation on {dev} and on the CPU "
                                   f"differ by {diff}: {metrics} against {on_cpu}")
        oracle = rec["oracle"]
        if not (oracle["fscore"] >= ORACLE_FSCORE_MIN and oracle["AbsRel"] <= ORACLE_ABSREL_MAX
                and oracle["l1"] == 0.0):
            raise RuntimeError(f"{scene}: the oracle evaluation fails its gates: {oracle}")
        out[scene] = rec
    if devices != {dev.type}:
        raise RuntimeError(f"the re-fusion ran on {devices}, not on {dev.type}")
    return out


def mesh_phase(torch, dev, model, frames, planes_ref, table_args: dict, smi: str):
    """Phase 6b (see the module docstring); returns the launch counts of
    the `reconstruct` it drives and the phase's record."""
    import tempfile

    import numpy as np

    from gennerf_tpu_torch.eval.metrics import eval_mesh
    from gennerf_tpu_torch.ops import kernels
    from gennerf_tpu_torch.ops.grid_decode import (
        extract_resnetfc_weights, grid_tables, separable_grid_decode_plain,
    )
    from gennerf_tpu_torch.ops.weight_slabs import pack_decode_weights
    from gennerf_tpu_torch.predict import reconstruct
    from gennerf_tpu_torch.tsdf.fusion import apply_fusion_prior
    from gennerf_tpu_torch.tsdf.tsdf import TSDF
    from gennerf_tpu_torch.utils.mesh import Mesh

    cfg = model.cfg
    P, image, depth = frames
    origin = torch.zeros(3, device=dev)
    kernels.reset_launch_counts()
    vol_k = reconstruct(model, P, image, depth, VOXEL_DIM, torch.Generator().manual_seed(SEED))
    torch.cuda.synchronize()
    launches = {k.name: k.launches for k in kernels.KERNELS}
    # the same stages through the plain versions: plain FPS (planes_ref),
    # the plain bf16-feed decode of these weights' tables, the prior
    weights = pack_decode_weights(extract_resnetfc_weights(
        model.mlp, model.head_geo, cfg.mlp.d_out_geo, cfg.mlp.head_smoothing), point=False)
    tables = grid_tables(planes_ref["xz"][0], planes_ref["xy"][0], planes_ref["yz"][0], origin,
                         weights, **table_args)
    vol_p = apply_fusion_prior(separable_grid_decode_plain(tables, weights, True),
                               cfg.voxel_size, origin, P, depth)
    tsdf_k, tsdf_p = (TSDF(cfg.voxel_size, torch.zeros(1, 3), v.cpu()) for v in (vol_k, vol_p))
    t0 = time.perf_counter()
    mesh_k = tsdf_k.get_mesh()
    mc_ms = (time.perf_counter() - t0) * 1e3
    mesh_p = tsdf_p.get_mesh()
    t0 = time.perf_counter()
    metrics = eval_mesh(mesh_k, mesh_p)
    eval_ms = (time.perf_counter() - t0) * 1e3
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "mesh.ply")
        t0 = time.perf_counter()
        mesh_k.export(path)
        write_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        loaded = Mesh.load(path)
        load_ms = (time.perf_counter() - t0) * 1e3
        ply_bytes = os.path.getsize(path)
    rec = {"phase": "mesh", "voxel_dim": list(VOXEL_DIM), "launches": launches,
           "vertices": len(mesh_k), "faces": len(mesh_k.faces),
           "plain_vertices": len(mesh_p), "plain_faces": len(mesh_p.faces),
           "kernel_vs_plain": metrics, "fscore_min": MESH_FSCORE_MIN,
           "marching_cubes_ms": mc_ms, "eval_mesh_ms": eval_ms, "ply_write_ms": write_ms,
           "ply_load_ms": load_ms, "ply_bytes": ply_bytes, "card": smi}
    if launches["grid_decode"] != 1:
        raise RuntimeError(f"the mesh phase's reconstruct launched K2 {launches['grid_decode']} times")
    if mesh_k.is_empty or mesh_p.is_empty:
        raise RuntimeError(f"an empty mesh: {rec}")
    if metrics["fscore"] < MESH_FSCORE_MIN:
        raise RuntimeError(f"K2's mesh disagrees with the plain mesh: {rec}")
    if not (np.array_equal(loaded.faces, mesh_k.faces)
            and np.array_equal(loaded.vertices, mesh_k.vertices.astype(np.float32))):
        raise RuntimeError("the PLY did not load back as written")
    return launches, rec


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from gennerf_tpu_torch import set_reference_precision
    from gennerf_tpu_torch.data.synthetic import ring_frames
    from gennerf_tpu_torch.models.gen_nerf import GenNerf
    from gennerf_tpu_torch.models.positional_encoding import positional_encoding
    from gennerf_tpu_torch.models.resnetfc import ResnetBlockFC
    from gennerf_tpu_torch.ops import kernels
    from gennerf_tpu_torch.ops.grid_decode import (
        extract_resnetfc_weights, grid_decode_cuda, grid_decode_flops, grid_tables,
        separable_grid_decode_plain,
    )
    from gennerf_tpu_torch.ops.projection import get_3d_points
    from gennerf_tpu_torch.ops.sampling import (
        FPS_CLUSTERS, farthest_point_sample_plain, fps_cuda, uniform_presample,
    )
    from gennerf_tpu_torch.tools.measure import FPS_INNER, build_report, check_build, cuda_ms
    from gennerf_tpu_torch.ops.weight_slabs import pack_decode_weights
    from gennerf_tpu_torch.ops.point_decode import (
        fused_resnetfc_tsdf_cuda, fused_resnetfc_tsdf_plain, pack_point_weights, point_decode_flops,
    )
    from gennerf_tpu_torch.predict import build_model, reconstruct
    from gennerf_tpu_torch.render import render_encoded, render_views
    from gennerf_tpu_torch.train.predict import (
        decode_dense, dense_grid_points, make_point_tsdf_fn, predict_tsdf_volume,
        predict_tsdf_volume_sparse, triplane_feat_fast, triplane_gather_setup, uses_grid_decode,
    )
    from gennerf_tpu_torch.tsdf.fusion import apply_fusion_prior, prior_classes
    from gennerf_tpu_torch.utils import native
    from gennerf_tpu_torch.utils.config import load_experiment_model_config

    set_reference_precision()
    dev = torch.device("cuda")

    # 1. device + build
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    emit({"phase": "device", "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda, "kind": torch.cuda.get_device_name(0)})
    t0 = time.perf_counter()
    kernels.load_library()
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    native.load_library()
    host_build_s = time.perf_counter() - t0
    report = build_report(kernels.build_info.get("ptxas", ""), kernels.build_info["path"])
    emit({"phase": "build", "seconds": build_s, "cached": kernels.build_info["cached"],
          "host_library": {"seconds": host_build_s, "cached": native.build_info["cached"],
                           "flags": native.CXX_FLAGS},
          **report, "card": smi})
    check_build(report)

    # the scene: 8 ring frames of 120x160 around the training volume's center
    frames_np = ring_frames(NUM_FRAMES, HEIGHT, WIDTH, SCENE_CENTER, PRIMITIVES, seed=SEED,
                            cameras=True)
    P, image, depth, intrinsics, poses = (torch.from_numpy(a).to(dev) for a in frames_np)

    # 2. fps: presampled depth clouds (with replacement: duplicates, ties)
    # of the 8 frames (the predict shape) and of 4 x 8 frames (the training
    # batch's shape)
    gen = torch.Generator().manual_seed(SEED)
    cloud = get_3d_points(depth, P).reshape(NUM_FRAMES, -1, 3)
    xyz = uniform_presample(cloud, PRESAMPLE, gen).contiguous()
    B, N = xyz.shape[:2]
    start = torch.randint(0, N, (B,), generator=gen).to(dev, torch.int32)
    xyz_batch = uniform_presample(cloud.repeat(FPS_BATCH // B, 1, 1), PRESAMPLE, gen).contiguous()
    start_batch = torch.randint(0, N, (FPS_BATCH,), generator=gen).to(dev, torch.int32)
    fps_instances = [r for r in report["kernels"] if r["kernel"] == "fps"]

    def fps_case(x, s):
        nb, n = x.shape[:2]
        idx_k = fps_cuda(x, NPOINT, s)
        launched = dict(kernels.FPS.last_launch)  # the plan the wrapper launched
        idx_p = farthest_point_sample_plain(x, NPOINT, s)
        torch.cuda.synchronize()
        ms = cuda_ms(torch, lambda: fps_cuda(x, NPOINT, s), reps=20, inner=FPS_INNER)
        single_ms = cuda_ms(torch, lambda: fps_cuda(x, NPOINT, s), reps=20)
        plain_ms = cuda_ms(torch, lambda: farthest_point_sample_plain(x, NPOINT, s), reps=5)
        # distance update + running min + argmax compare: 10 f32 ops per point per iteration
        ops = 10 * nb * n * NPOINT
        nbytes = x.numel() * 4 + nb * 4 + nb * NPOINT * 4
        return idx_k, idx_p, {
            "shape": [nb, n, 3], "npoint": NPOINT,
            "duplicate_points": int(n - torch.unique(x[0], dim=0).shape[0]),
            "index_mismatches": int((idx_k != idx_p).sum()), "launched": launched,
            "active_clusters": {cl: kernels.fps_plan(n, cl)["active_clusters"]
                                for cl in FPS_CLUSTERS},
            "ms": ms, "us_per_iteration": ms * 1e3 / NPOINT, "single_call_ms": single_ms,
            "plain_ms": plain_ms, "bound_ms": max(ops / PEAK_F32, nbytes / PEAK_BYTES) * 1e3}

    idx_k, idx_p, fps_rec = fps_case(xyz, start)
    _, _, fps_batch = fps_case(xyz_batch, start_batch)
    fps_ms, fps_plain_ms, fps_bound = fps_rec["ms"], fps_rec["plain_ms"], fps_rec["bound_ms"]
    emit({"phase": "fps", **fps_rec, "batch": fps_batch, "build": fps_instances, "card": smi})
    for rec in (fps_rec, fps_batch):
        if rec["index_mismatches"]:
            raise RuntimeError(f"FPS kernel disagrees with its plain version at "
                               f"{rec['index_mismatches']} indices at {rec['shape']}")

    # 3. grid_decode: full-width weights, every matrix non-zero
    cfg_dict = load_experiment_model_config(EXPERIMENT)
    model = build_model(cfg_dict, dev, SEED)
    wgen = torch.Generator().manual_seed(SEED + 1)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, ResnetBlockFC):  # fc_1 is zero at init
                fan_in = m.fc_1.weight.shape[1]
                m.fc_1.weight.copy_(torch.randn(m.fc_1.weight.shape, generator=wgen) / math.sqrt(fan_in))
                m.fc_1.bias.copy_(0.1 * torch.randn(m.fc_1.bias.shape, generator=wgen))
    cfg = model.cfg
    if not uses_grid_decode(model):
        raise RuntimeError("the full-width config does not take the grid decode")
    with torch.no_grad():
        repr_ = model.encode(P[None], image[None], depth[None], torch.Generator().manual_seed(SEED))
    weights = pack_decode_weights(extract_resnetfc_weights(
        model.mlp, model.head_geo, cfg.mlp.d_out_geo, cfg.mlp.head_smoothing), point=False)
    extent = [d * cfg.voxel_size for d in cfg.voxel_dim_train]
    table_args = dict(
        voxel_dim=VOXEL_DIM, voxel_size=cfg.voxel_size, num_freqs=cfg.code.num_freqs,
        freq_factor=cfg.code.freq_factor, include_input=cfg.code.include_input,
        padding=cfg.encoder.pointnet.padding, coord_center=tuple(e / 2 for e in extent),
        coord_scale=max(extent))
    planes = repr_.planes
    tables = grid_tables(planes["xz"][0], planes["xy"][0], planes["yz"][0],
                         torch.zeros(3, device=dev), weights, **table_args)
    vol_k = grid_decode_cuda(tables, weights)
    vol_p = separable_grid_decode_plain(tables, weights, bf16_feeds=True)
    torch.cuda.synchronize()
    err = (vol_k - vol_p).abs()
    grid_max, grid_mean = float(err.max()), float(err.mean())
    grid_ms = cuda_ms(torch, lambda: grid_decode_cuda(tables, weights), reps=10)
    grid_plain_ms = cuda_ms(torch, lambda: separable_grid_decode_plain(tables, weights, True), reps=3)
    H, nb = weights["w0"].shape[-1], weights["w0"].shape[0]
    grid_flops = grid_decode_flops(VOXEL_DIM, H, nb)
    grid_bytes = (sum(t.numel() for t in tables) * 4 + sum(
        weights[k].numel() * weights[k].element_size() for k in ("k_slabs", "k_b0", "k_b1", "k_w_last"))
                  + math.prod(VOXEL_DIM) * 4)
    grid_bound = max(grid_flops / PEAK_BF16, grid_bytes / PEAK_BYTES) * 1e3
    emit({"phase": "grid_decode", "voxel_dim": list(VOXEL_DIM), "H": H, "n_blocks": nb,
          "max_abs_err": grid_max, "mean_abs_err": grid_mean,
          "tolerance": {"max_abs": GRID_MAX_ABS_TOL, "mean_abs": GRID_MEAN_ABS_TOL},
          "out_abs_max": float(vol_p.abs().max()), "ms": grid_ms, "plain_ms": grid_plain_ms,
          "flops": grid_flops, "bound_ms": grid_bound,
          "tflops_per_s": grid_flops / grid_ms / 1e9,
          "peak_share": grid_flops / grid_ms * 1e3 / PEAK_BF16, "card": smi})
    if not (torch.isfinite(vol_k).all() and grid_max <= GRID_MAX_ABS_TOL
            and grid_mean <= GRID_MEAN_ABS_TOL):
        raise RuntimeError(f"grid-decode kernel disagrees: max {grid_max}, mean {grid_mean}")

    # 4. predict: the main path, counters reset just before, read just after
    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    vol = reconstruct(model, P, image, depth, VOXEL_DIM, torch.Generator().manual_seed(SEED))
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    launches = {k.name: k.launches for k in kernels.KERNELS}
    fps_launched = dict(kernels.FPS.last_launch or {})
    smoothing = cfg.mlp.head_smoothing
    if tuple(vol.shape) != VOXEL_DIM or vol.dtype != torch.float32:
        raise RuntimeError(f"bad volume {tuple(vol.shape)} {vol.dtype}")
    if not torch.isfinite(vol).all() or float(vol.abs().max()) > smoothing:
        raise RuntimeError("volume not finite or outside +-smoothing")
    for name in ("fps", "grid_decode"):
        if launches[name] < 1:
            raise RuntimeError(f"the predict path launched no {name} kernel")
    origin = torch.zeros(3, device=dev)
    near, farfront = prior_classes(VOXEL_DIM, cfg.voxel_size, origin, 3 * cfg.voxel_size, P, depth)
    unobserved = ~near & ~farfront
    if not (near.any() and farfront.any() and unobserved.any()):
        raise RuntimeError("empty prior class: the scene misses the grid")
    band = vol.reshape(-1)[near]

    # the same stages through the plain versions on the card
    gen = torch.Generator().manual_seed(SEED)
    cloud = get_3d_points(depth, P).reshape(NUM_FRAMES, -1, 3)
    xyz_ref = uniform_presample(cloud, cfg.encoder.pointnet.fps_presample, gen)
    start_ref = torch.randint(0, xyz_ref.shape[1], (NUM_FRAMES,), generator=gen)
    idx_ref = farthest_point_sample_plain(
        xyz_ref, cfg.encoder.pointnet.num_sparse_points, start_ref).long()
    sparse = torch.gather(xyz_ref, 1, idx_ref[..., None].expand(-1, -1, 3))
    with torch.no_grad():
        planes_ref = model.pointnet(model.plane_coords(sparse.reshape(1, -1, 3)))
    tables_ref = grid_tables(planes_ref["xz"][0], planes_ref["xy"][0], planes_ref["yz"][0],
                             origin, weights, **table_args)
    vol_ref = apply_fusion_prior(separable_grid_decode_plain(tables_ref, weights, True),
                                 cfg.voxel_size, origin, P, depth)
    perr = (vol - vol_ref).abs()
    pred_max, pred_mean = float(perr.max()), float(perr.mean())

    with torch.no_grad():
        encode_ms = host_ms(torch, lambda: model.encode(P[None], image[None], depth[None],
                                                         torch.Generator().manual_seed(SEED)), 3)
    decode_ms = host_ms(torch, lambda: predict_tsdf_volume(model, repr_, VOXEL_DIM,
                                                           cfg.voxel_size, origin), 3)
    prior_ms = host_ms(torch, lambda: apply_fusion_prior(vol, cfg.voxel_size, origin, P, depth), 3)
    total_ms = host_ms(torch, lambda: reconstruct(
        model, P, image, depth, VOXEL_DIM, torch.Generator().manual_seed(SEED)), 3)
    emit({"phase": "predict", "config": "configs/experiment/seqs_multigeo_4cm.yaml",
          "frames": [NUM_FRAMES, HEIGHT, WIDTH], "voxel_dim": list(VOXEL_DIM),
          "launches": launches, "fps_launched": fps_launched, "first_call_ms": first_ms,
          "near_voxels": int(near.sum()), "farfront_voxels": int((~near & farfront).sum()),
          "unobserved_voxels": int(unobserved.sum()),
          "band_min": float(band.min()), "band_max": float(band.max()),
          "vs_plain_max_abs": pred_max, "vs_plain_mean_abs": pred_mean,
          "encode_ms": encode_ms, "decode_ms": decode_ms, "prior_ms": prior_ms,
          "total_ms": total_ms, "card": smi})
    if pred_max > GRID_MAX_ABS_TOL or pred_mean > GRID_MEAN_ABS_TOL:
        raise RuntimeError(f"predict disagrees with its plain stages: max {pred_max}, mean {pred_mean}")

    # where one reconstruct's device time goes
    emit({"phase": "profile", **profile_device(torch, lambda: reconstruct(
        model, P, image, depth, VOXEL_DIM, torch.Generator().manual_seed(SEED)), total_ms, smi)})

    # 5. point_decode: 2^20 points uniform in the test volume, their
    # triplane features and codes from the grid phase's scene
    box = np.array(cfg.voxel_dim_test, np.float32) * cfg.voxel_size
    pts = torch.from_numpy(np.random.default_rng(SEED).uniform(0, box, (N_POINTS, 3))
                           .astype(np.float32)).to(dev)
    feat = triplane_feat_fast(*triplane_gather_setup(model, planes), pts[None])[0]
    code = positional_encoding(pts, cfg.code.num_freqs, cfg.code.freq_factor,
                               cfg.code.include_input)
    pweights = pack_point_weights(weights)
    pk = fused_resnetfc_tsdf_cuda(feat, code, pweights)
    pp = fused_resnetfc_tsdf_plain(feat, code, pweights, bf16_feeds=True)
    torch.cuda.synchronize()
    perr = (pk - pp).abs()
    point_max, point_mean = float(perr.max()), float(perr.mean())
    point_ms = cuda_ms(torch, lambda: fused_resnetfc_tsdf_cuda(feat, code, pweights), reps=10)
    point_plain_ms = cuda_ms(torch, lambda: fused_resnetfc_tsdf_plain(feat, code, pweights, True),
                             reps=3)
    # one view's launch sizes at 120x160: coarse 16, fine 8 and secant 1 sample per ray
    rays = HEIGHT * WIDTH
    launch_sizes = (("coarse", 16 * rays), ("fine", 8 * rays), ("secant", rays))
    launch_ms = {name: cuda_ms(torch, lambda n=n: fused_resnetfc_tsdf_cuda(feat[:n], code[:n],
                                                                          pweights), reps=10)
                 for name, n in launch_sizes}
    d_in, d_code = feat.shape[1], code.shape[1]
    point_flops = point_decode_flops(N_POINTS, d_in, d_code, H, nb)
    point_bytes = (feat.numel() + code.numel() + N_POINTS) * 4 + sum(
        t.numel() * t.element_size() for k, t in pweights.items()
        if k.startswith("k_") and isinstance(t, torch.Tensor))
    point_bound = max(point_flops / PEAK_BF16, point_bytes / PEAK_BYTES) * 1e3
    emit({"phase": "point_decode", "points": N_POINTS, "d_in": d_in, "d_code": d_code, "H": H,
          "n_blocks": nb, "max_abs_err": point_max, "mean_abs_err": point_mean,
          "tolerance": {"max_abs": POINT_MAX_ABS_TOL, "mean_abs": POINT_MEAN_ABS_TOL},
          "out_abs_max": float(pp.abs().max()), "ms": point_ms, "plain_ms": point_plain_ms,
          "flops": point_flops, "bytes": point_bytes, "bound_ms": point_bound,
          "tflops_per_s": point_flops / point_ms / 1e9,
          "peak_share": point_flops / point_ms * 1e3 / PEAK_BF16, "launch_ms": launch_ms,
          "launch_peak_share": {name: point_decode_flops(n, d_in, d_code, H, nb) / launch_ms[name]
                                * 1e3 / PEAK_BF16 for name, n in launch_sizes},
          "card": smi})
    if not (torch.isfinite(pk).all() and point_max <= POINT_MAX_ABS_TOL
            and point_mean <= POINT_MEAN_ABS_TOL):
        raise RuntimeError(f"point-decode kernel disagrees: max {point_max}, mean {point_mean}")

    # 6. render: a random field need not cross zero, so lin_out's bias moves
    # along the head until the median pre-tanh head over the grid is 0
    d_geo = cfg.mlp.d_out_geo
    with torch.no_grad():
        shift = -math.atanh(float(vol_p.median()) / smoothing)
        w_head = model.head_geo.fc.weight[0].to(torch.float64)
        model.mlp.lin_out.bias[:d_geo] += (shift * w_head / (w_head @ w_head)).to(torch.float32)
    render_args = (model, P, image, depth, intrinsics, poses)
    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = render_views(*render_args, num_views=NUM_VIEWS, generator=torch.Generator().manual_seed(SEED))
    torch.cuda.synchronize()
    render_first_ms = (time.perf_counter() - t0) * 1e3
    render_launches = {k.name: k.launches for k in kernels.KERNELS}
    if render_launches["point_decode"] < 1:
        raise RuntimeError("render_views launched no point_decode kernel")
    hit_share = (out["ray_depth"] > 0).mean(axis=(1, 2))
    if not (hit_share > 0).all() or not np.isfinite(out["depth"]).all():
        raise RuntimeError(f"a rendered view has no hit rays or non-finite depth: {hit_share}")
    # the same march on the plain bf16-feed decode, on one shared encode
    with torch.no_grad():
        repr_r = model.encode(P[None], image[None], depth[None],
                              torch.Generator().manual_seed(SEED))
    rk = render_encoded(model, repr_r, depth, intrinsics, poses, make_point_tsdf_fn(model, repr_r),
                        NUM_VIEWS)
    rp = render_encoded(model, repr_r, depth, intrinsics, poses,
                        make_point_tsdf_fn(model, repr_r, plain=True), NUM_VIEWS)
    hk, hp = rk["ray_depth"] > 0, rp["ray_depth"] > 0
    mask_agree = float((hk == hp).mean())
    both = hk & hp
    ddiff = np.abs(rk["ray_depth"] - rp["ray_depth"])[both]
    depth_agree = float((ddiff <= RENDER_DEPTH_TOL).mean())
    render_ms = host_ms(torch, lambda: render_views(
        *render_args, num_views=NUM_VIEWS, generator=torch.Generator().manual_seed(SEED)), 3)
    tsdf_k = make_point_tsdf_fn(model, repr_r)
    view_ms = host_ms(torch, lambda: render_encoded(model, repr_r, depth, intrinsics, poses,
                                                    tsdf_k, 1), 3)
    emit({"phase": "render", "config": "configs/experiment/seqs_multigeo_4cm.yaml",
          "views": [int(v) for v in out["views"]], "image": [HEIGHT, WIDTH],
          "launches": render_launches, "point_decode_launches_per_view":
          render_launches["point_decode"] / NUM_VIEWS,
          "point_decode_points_per_view": rays * (16 + 8 + 4),
          "first_call_ms": render_first_ms, "render_views_ms": render_ms,
          "host_ms_per_view": render_ms / NUM_VIEWS, "one_view_ms": view_ms,
          "rays_per_s": NUM_VIEWS * rays / (render_ms / 1e3),
          "hit_share": [float(h) for h in hit_share],
          "vs_plain_mask_agree": mask_agree, "vs_plain_depth_agree": depth_agree,
          "vs_plain_depth_diff_m": {"p99": float(np.quantile(ddiff, 0.99)),
                                    "p999": float(np.quantile(ddiff, 0.999)),
                                    "max": float(ddiff.max()),
                                    "share_over_1cm": float((ddiff > 0.01).mean())},
          "tolerance": {"mask_agree": RENDER_MASK_AGREE, "depth_m": RENDER_DEPTH_TOL,
                        "depth_agree": RENDER_DEPTH_AGREE},
          "eval_depth_random_weights_not_quality": out["mean"], "card": smi})
    if mask_agree < RENDER_MASK_AGREE or depth_agree < RENDER_DEPTH_AGREE:
        raise RuntimeError(f"kernel march disagrees with the plain march: masks {mask_agree}, "
                           f"depths {depth_agree}")
    emit({"phase": "render_profile", "what": "one view of render_encoded (K3 march)",
          **profile_device(torch, lambda: render_encoded(model, repr_r, depth, intrinsics, poses,
                                                         tsdf_k, 1), view_ms, smi)})

    # 6b. mesh: the render phase's weights cross zero inside the grid
    mesh_launches, mesh_rec = mesh_phase(torch, dev, model, (P, image, depth), planes_ref,
                                         table_args, smi)
    emit(mesh_rec)

    # 7. predict_sparse: the band decode through the user entry point, then
    # against the dense gather decode clamped by the prior on one encode
    sparse_model = GenNerf(dataclasses.replace(cfg, sparse_band_decode=True))
    sparse_model.load_state_dict(model.state_dict())
    sparse_model = sparse_model.to(dev).eval()
    kernels.reset_launch_counts()
    vol_s = reconstruct(sparse_model, P, image, depth, VOXEL_DIM, torch.Generator().manual_seed(SEED))
    torch.cuda.synchronize()
    sparse_launches = {k.name: k.launches for k in kernels.KERNELS}
    if not torch.isfinite(vol_s).all() or float(vol_s.abs().max()) > max(smoothing, 1.0):
        raise RuntimeError("sparse volume not finite or out of range")
    sparse = predict_tsdf_volume_sparse(sparse_model, repr_, VOXEL_DIM, cfg.voxel_size, origin,
                                        P, depth)
    dense = decode_dense(model, repr_, dense_grid_points(VOXEL_DIM, cfg.voxel_size, origin, dev))
    dense = apply_fusion_prior(dense.reshape(VOXEL_DIM), cfg.voxel_size, origin, P, depth)
    sparse_err = float((sparse - dense).abs().max())
    sparse_ms = host_ms(torch, lambda: reconstruct(
        sparse_model, P, image, depth, VOXEL_DIM, torch.Generator().manual_seed(SEED)), 3)
    emit({"phase": "predict_sparse", "launches": sparse_launches, "total_ms": sparse_ms,
          "band_share": float(near.float().mean()), "vs_dense_max_abs": sparse_err,
          "tolerance": SPARSE_TOL, "card": smi})
    if sparse_err > SPARSE_TOL:
        raise RuntimeError(f"sparse band decode disagrees with the dense decode: {sparse_err}")

    # 8. train: the training path, K1 in every step's encode
    train_launches = train_phase(torch, dev, cfg_dict, smi)

    with tempfile.TemporaryDirectory() as data_tmp:
        root = os.path.join(data_tmp, "multigeo")
        # 9. data: the on-disk dataset through the loaders into training, then
        # held-out predict and render from the trained weights
        data_launches = data_phase(torch, dev, smi, root)
        # 10. spatial: the ResNet feature volume beside the triplanes, trained
        # on the same dataset, then a held-out reconstruct
        spatial_launches = spatial_phase(torch, dev, smi, root)

    kernel_line = {"kernels": [
        {"name": "fps", "route": "cuda", "source": "gennerf_tpu_torch/csrc/fps.cu",
         "replaces": "gennerf_tpu/ops/pallas/fps.py:33",
         "launches": (launches["fps"] + render_launches["fps"] + mesh_launches["fps"]
                      + sparse_launches["fps"] + train_launches["fps"] + data_launches["fps"]
                      + spatial_launches["fps"]),
         "max_abs_err": float((idx_k - idx_p).abs().max()), "ms": fps_ms,
         "plain_ms": fps_plain_ms, "bound_ms": fps_bound, "bound_by": "operations",
         "library_ms": None},
        {"name": "grid_decode", "route": "cuda", "source": "gennerf_tpu_torch/csrc/grid_decode.cu",
         "replaces": "gennerf_tpu/ops/pallas/fused_decoder.py:353",
         "launches": (launches["grid_decode"] + mesh_launches["grid_decode"]
                      + data_launches["grid_decode"]),
         "max_abs_err": grid_max, "ms": grid_ms,
         "plain_ms": grid_plain_ms, "bound_ms": grid_bound,
         "bound_by": "operations" if grid_flops / PEAK_BF16 >= grid_bytes / PEAK_BYTES else "bytes",
         "library_ms": None},
        {"name": "point_decode", "route": "cuda", "source": "gennerf_tpu_torch/csrc/point_decode.cu",
         "replaces": "gennerf_tpu/ops/pallas/fused_decoder.py:53",
         "launches": render_launches["point_decode"] + data_launches["point_decode"],
         "max_abs_err": point_max, "ms": point_ms,
         "plain_ms": point_plain_ms, "bound_ms": point_bound,
         "bound_by": "operations" if point_flops / PEAK_BF16 >= point_bytes / PEAK_BYTES else "bytes",
         "library_ms": None},
    ]}
    emit(kernel_line)
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
