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
     under deterministic algorithms (loss, gradients, running statistics,
     peak memory of each), K1 against the plain FPS, the frame_chunk
     encode against the one-pass encode in eval mode; timed and profiled
     train steps; a held-out `reconstruct` at 96x96x56 (K1 once, K2 0,
     finite, inside the head's range), its total and decode ms and a
     profile;
 11. voxelnet: configs/experiment/seqs_multigeo_voxelnet.yaml at full width
     in the precision it asks for, bf16-mixed (ResNet-18 stem and 2 stages
     at feature_scale 2.0 on the loaders' 480x640 frames, 32 channels
     backprojected into an 80x80x40 volume, the 3D encoder-decoder with
     channels [32, 64, 128], the 8 and 4 cm heads), on the data phase's
     dataset: one epoch of `Trainer.fit` (8 steps) with its validation
     (val_tsdf_loss-monitored top-3, the tail's val_recon_tsdf_l1 finite),
     the kernel counters reset before the phase and all 0 after it (the
     JAX VoxelNet runs no Pallas kernel); on one loader batch the float32
     model's forward and loss on the card (TF32 off) against the CPU, the
     precision discipline (parameters and running statistics float32
     after a bf16 step; the ResNet's output bf16, the volume, the 3D
     backbone's and the heads' outputs float32; the bf16 loss near the
     float32 loss), a remat step against the step without remat; timed and
     profiled bf16 steps; the held-out scenes through the predict CLI from
     the run directory and `evaluation.process` (metrics finite, meshes
     non-empty);
 12. flagship_bf16: configs/experiment/seq1_frames8_evenspaced_pointnet.yaml
     at full width in the precision it asks for, bf16-mixed (pointnet c_dim
     64, 4 blocks, 128x128 planes, UNet depth 3, 512 sparse points, raw
     world coordinates; ResnetFC H 256, 5 blocks; 100 rays of 1 + 20 + 8
     samples; Adam 1e-4), its one cut the data keys of seqs_multigeo_4cm
     (FLAGSHIP_DATA_KEYS), on the data phase's dataset: one epoch of
     `Trainer.fit` with its validation (K1 = steps + eval batches + tails,
     K2 = tails); K1 at npoint 512 on the batch's presampled clouds against
     its plain version (0 mismatches, plan, ms, bound); a bf16 step with K1
     against the plain-FPS step; the bf16 loss against the float32 loss of
     the same weights, batch and draws (2e-2), the state float32 after a
     bf16 step, the planes and TSDF bf16, the features float32; the float32
     planes and loss on the card against the CPU (1e-4); timed and profiled
     bf16 steps (K1 once a step) and the same in float32; an epoch and a
     validation of the eikonal child in bf16 (the eikonal term finite and
     above 0), for 4 draws its float32 step on the card and on the CPU and
     its bf16 step on the card against the CPU's float64 step (the loss
     within 1e-5 of the CPU's float32 loss; the card's float32 gradients at
     most EIKONAL_NOISE_FACTOR times as far from float64 as the CPU's, the
     bf16 step's beyond that), its step ms against the flagship's; one
     bf16 step of the frustumN child and one with the gradient loss (every
     term and gradient finite, K1 once); the share of the step's samples,
     the encoded clouds and the grids whose plane coordinates are clamped;
     the held-out scenes through the predict CLI from the run directory in
     bf16 (recorded in predict_meta.json), K2 once a scene within the grid
     tolerance of the plain bf16-feed decode, `evaluation.process` finite;
     the field centred on the flagship's 190x180x50 grid (lin_out's bias
     moved so that the median pre-tanh head there is 0), one `reconstruct`
     at that grid (K2 against the plain decode with a tenth of its voxels
     live, its ms and bound); the field centred on a held-out view's box,
     K3 at d_in 64 on that view's bf16 planes against its plain bf16-feed
     version at 2^20 points (half over the planes' whole domain), and the
     view through K3 against the plain march (a tenth of the rays hitting,
     masks and depths agreeing); one bf16 step of seqs_multigeo_spatial
     (K1 once, the loss within 2e-2 of the float32 loss);
 13. distill: scans/scene_synth0 (24 frames) written by the port's
     `generate_scene`; configs/experiment/distill_synthetic.yaml and
     distill_render_synthetic.yaml at their own width (pointnet c_dim 32,
     64x64 planes, UNet depth 3, 256 sparse points; ResnetFC H 256 x 5
     with d_out_geo 64 + d_out_sem 64; the random-projection teacher, 64
     channels; float32) each through the train CLI for its 10 epochs,
     validating every 5, counters reset just before and read just after
     (K1 = steps + eval batches + tails, K2 = tails), every epoch's
     train_distill, distill_coverage (> 0 in every epoch), valid_coverage,
     train_tsdf and, in render mode, render_hit_rate, and the validations'
     val_distill; for each mode one float32 step's loss on the card
     against the CPU on the CPU's sparse and supervision points (and, in
     render mode, the CPU's march) within 1e-5, the card's own march
     against the CPU's (99% of the hit masks agree, the crossings within
     1e-3 m); timed and profiled steps of each mode; on the trained
     surface model's head (d_geo 64, lin_out 128 wide) K2 through
     `reconstruct` of the scene's test frames against the plain bf16-feed
     decode (the field centred first if a tenth of it is not live), K3 at
     2^18 points against its plain version and a test view through K3
     against the plain march; the surface experiment with use_auxiliary
     (the teacher's 64 channels backprojected beside the planes, d_in 96):
     one step, the card against the CPU, and a `reconstruct` and a
     `render_views` launching K1 twice and K2 and K3 0 times;
 14. harness: configs/experiment/seqs_multigeo_4cm.yaml at full width on
     the data phase's dataset through the train CLI's `main` in process,
     with the reference's harness groups (HARNESS_OVERRIDES: at most 6
     epochs of 3 train batches and 1 validation batch, early stopping on
     val_combined with patience 1 from epoch 2, the parameter table at
     depth 2, clear_cache, a profiler window of 2 steps, the many_loggers
     group, the config tree, the test pass), counters reset just before
     and read just after: every epoch runs 3 steps, the fit stops at the
     epoch the logged val_combined dictates, K1 = steps + eval batches +
     tails and K2 = tails, each K1 launch index-exact against the plain
     FPS on its clouds and each tail's K2 volume within the grid tolerance
     of the plain bf16-feed decode of its tables; the tfevents file read
     back (TFRecord framing, every masked CRC checked) holds every scalar
     of metrics.csv at its step, the hparams record, the val and test
     comparison renders (PNG, not all white, equal to local/'s PNGs) and
     the mesh-plugin tensors; config_tree.log and tags.log; the profiler's
     Chrome trace names the FPS kernel among its device events; then the
     epoch wall time with clear_cache off and on and the host time per
     step with the progress line and the tfevents writer off and on (on
     one repeated loader batch, in turns off, on, on, off); the train CLI
     in a subprocess, sent SIGTERM once metrics.csv shows step 2: exit 0,
     the interrupted epoch saved at the last logged step, no test pass,
     and a --resume run of one more epoch starting at the next epoch with
     a finite loss; a 2-trial learning-rate grid through
     `train.sweep` (2 records, val_combined finite);
 15. weights_options: weights in and out and the GenNerf options a
     reference checkpoint can name. A reference-named Lightning .ckpt of the
     full-width seqs_multigeo_4cm (c_dim 32, 64x64 planes, UNet depth 3, 256
     sparse points, ResnetFC H 256 x 5), fabricated with numpy, its
     hyper_parameters pickling a class of a module that does not exist (the
     field centred on the scene's test grid first), through the predict
     and render CLIs' --params on one held-out scene, counters reset just
     before and read just after (K1 twice, each index-exact against the
     plain FPS; K2 once, within the grid tolerances of the plain bf16-feed
     decode; K3 in the render), the 480x640 view through K3 against the
     plain march, the writer -> reader round trip bit for bit and the same
     weights loaded natively and through the reader giving the same
     volume bit for bit (deterministic algorithms); fabricated reference
     checkpoints of seqs_multigeo_spatial (ResNet under encoder.model.) and
     seqs_multigeo_voxelnet (backbone3d, heads3d; partial: spatial.proj),
     one float32 forward each on the card against the CPU (the feature
     volumes by the share of voxels within the tolerance; VoxelNet in
     training mode, its refine from the CPU's volume); the option
     groups of OPTION_GROUPS on seqs_multigeo_4cm: 3 float32 steps with
     injected draws and a reconstruct (counted: K1 once an encode in (a)
     and (b), 0 under voxel_hash in (c); K2 0 in (a) and (b), which the
     static route sends to the f32 decode_dense, and once in (c), whose
     triplane decoder the route sends to K2 as the JAX package does, held
     against the plain decode), the same steps on the card and the CPU on
     the CPU's points (every step's loss and the initial planes within
     OPTIONS_DEVICE_RTOL, the first step's gradients against a float64
     step on the CPU as in the eikonal check, the planes and parameters
     after the steps printed);
     PointNet++ on one (8, 16384) cloud (K1 at npoint 128, then 32 on 128
     centroids, each index-exact, its plan printed);
then a `kernels` JSON line, the nvidia-smi line and the final result line.
Every phase raises on failure. Needs one CUDA card; exits non-zero without.
"""
import contextlib
import csv
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
# remat against no remat on one batch, same weights and draws, under
# deterministic algorithms: the same arithmetic, recomputed, so the loss,
# the gradients and the running statistics agree but for the ops that
# have no deterministic version
REMAT_LOSS_RTOL, REMAT_GRAD_TOL, REMAT_STATS_TOL = 1e-5, 1e-4, 1e-6
# frame_chunk 1 against the one-pass encode in eval mode: the same
# convolutions on a batch of 1 or of 8 frames (cuDNN may pick another
# algorithm), the volume summed in the same frame order
CHUNK_REL_TOL = 1e-5
# the voxelnet phase: seqs_multigeo_voxelnet (bf16-mixed) on the data phase's dataset
VOXELNET_EXPERIMENT = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                   "configs", "experiment", "seqs_multigeo_voxelnet.yaml")
VOXELNET_EPOCHS, VOXELNET_WARMUP, VOXELNET_TIMED_STEPS = 1, 3, 7
# the float32 forward on the card (TF32 off) against the CPU, eval mode:
# cuDNN and the CPU sum each convolution in another order (1e-6 relative a
# layer); a voxel whose coarse prediction lies within that noise of the
# sparse threshold may take the other branch, so 99.99% of the voxels of
# each output must agree within 1e-4 of its largest magnitude
VOXELNET_DEVICE_TOL, VOXELNET_DEVICE_SHARE, VOXELNET_DEVICE_LOSS_RTOL = 1e-4, 0.9999, 1e-4
# the bf16-mixed loss against the float32 loss of the same weights and
# batch: each bf16 rounding is 2^-9 relative and the loss averages the
# volume's voxels, so 2e-2 is several bf16 steps
VOXELNET_BF16_LOSS_RTOL = 2e-2
# the flagship_bf16 phase: the flagship GenNerf and its eikonal and frustum
# children in bf16-mixed (their /trainer: tpu) on the data phase's dataset
_CONFIGS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "configs", "experiment")
FLAGSHIP_EXPERIMENT = os.path.join(_CONFIGS, "seq1_frames8_evenspaced_pointnet.yaml")
EIKONAL_EXPERIMENT = os.path.join(_CONFIGS, "seq1_frames8_evenspaced_eikonal.yaml")
FRUSTUM_EXPERIMENT = os.path.join(_CONFIGS, "train_tsdf_one_scene_seqs1_framesN.yaml")
# the one cut: the flagship's ScanNet scene is not in the repository, so
# these data keys come from seqs_multigeo_4cm (the multigeo dataset, 10-frame
# sequences, every window of a scene, 80x80x40 augmented crops, 96x96x56
# held-out grids); the frustumN child's 0.1 of each scene's 300-frame
# windows would leave none of a 10-frame scene
FLAGSHIP_DATA_KEYS = ("datasets_train", "datasets_val", "datasets_test", "cache_items",
                      "sequence_length", "sequence_amount_train", "sequence_amount_val",
                      "sequence_amount_test", "voxel_dim_train", "voxel_dim_val",
                      "voxel_dim_test", "random_rotation_3d", "random_translation_3d",
                      "pad_xy_3d", "pad_z_3d")
FLAGSHIP_EPOCHS, FLAGSHIP_WARMUP, FLAGSHIP_TIMED_STEPS = 1, 3, 10
# the flagship's widths (the phase checks the composed config against them)
FLAGSHIP_SHAPE = {"c_dim": 64, "hidden_dim": 32, "n_blocks": 4, "plane_resolution": 128,
                  "unet_depth": 3, "num_sparse_points": 512, "normalize_coords": False,
                  "d_hidden": 256, "mlp_blocks": 5, "num_rays": 100,
                  "voxel_dim_train": (80, 80, 40)}
# the flagship's own decode grid (voxel_dim_test), 1.71 M voxels
FLAGSHIP_GRID = (190, 180, 50)
# bf16-mixed against float32 on the same weights, batch and draws (as VoxelNet's)
FLAGSHIP_BF16_LOSS_RTOL = 2e-2
# the float32 forward on the card against the CPU: the planes over their
# max-abs and the loss, relative (cuDNN and the CPU sum in other orders)
FLAGSHIP_DEVICE_TOL = 1e-4
# the float32 eikonal step on the card against the same step on the CPU in
# float64, for each of EIKONAL_SEEDS draws: the step's weight gradients sum
# 23,200 samples' double-backward terms that cancel, so a float32 step in
# any summation order is off float64 by 1e-4 to 7e-4 of max-abs, the CPU's
# as well as the card's; the card's distance may be at most
# EIKONAL_NOISE_FACTOR times the CPU's float32 distance of the same draws,
# and the card's bf16-mixed step (the control a fault must look like) must
# lie beyond that limit; the loss is held to the CPU's float32 loss
# (TRAIN_LOSS_RTOL)
EIKONAL_SEEDS, EIKONAL_NOISE_FACTOR = 4, 5.0
# the distill phase: both distillation experiments at their own widths on
# their scene (scans/scene_synth0, 24 frames as their sequence_length asks),
# timed steps of each mode, and the surface experiment with the teacher's
# features backprojected into a volume beside the planes (use_auxiliary)
DISTILL_EXPERIMENT = os.path.join(_CONFIGS, "distill_synthetic.yaml")
DISTILL_RENDER_EXPERIMENT = os.path.join(_CONFIGS, "distill_render_synthetic.yaml")
DISTILL_FRAMES, DISTILL_WARMUP, DISTILL_TIMED_STEPS = 24, 2, 8
AUX_OVERRIDES = ("model.encoder.use_auxiliary=true", "model.encoder.auxiliary_dim=64")
# the harness phase: seqs_multigeo_4cm through the train CLI on the data
# phase's dataset with early stopping (patience 1 from epoch 2), 3 train
# batches and 1 validation batch an epoch, the profiler window, the
# many_loggers group and the test pass; then a SIGTERM save of the same
# config in a subprocess (sent once step SIGTERM_STEP is logged), its
# resume, a 2-trial learning-rate sweep, and the overheads of clear_cache
# (OVERHEAD_EPOCHS epochs a fit, the first not timed), the progress line
# and the tfevents writer (OVERHEAD_STEPS steps a fit)
HARNESS_OVERRIDES = (
    "trainer.max_epochs=6", "trainer.min_epochs=2", "trainer.limit_train_batches=3",
    "trainer.limit_val_batches=1", "trainer.check_val_every_n_epoch=1",
    "callbacks=early_stopping", "callbacks.early_stopping.patience=1",
    "callbacks.model_summary.max_depth=2", "callbacks.clear_cache=true",
    "trainer.profile_steps=2", "logger=many_loggers", "extras.print_config=true", "test=true")
HARNESS_STEPS_PER_EPOCH, HARNESS_PATIENCE, HARNESS_MIN_EPOCHS = 3, 1, 2
SIGTERM_STEP, SIGTERM_TIMEOUT_S = 2, 240
SWEEP_LRS = (1e-3, 1e-4)
OVERHEAD_STEPS, OVERHEAD_EPOCHS = 20, 3
# the weights_options phase: a reference-named checkpoint fabricated with
# numpy for seqs_multigeo_4cm, seqs_multigeo_spatial and
# seqs_multigeo_voxelnet (the latter two on OTHER_FRAMES frames of their
# loader batch, to bound the CPU's side), and seqs_multigeo_4cm with each
# group of options (OPTIONS_STEPS float32 steps); the float32 card against
# the CPU on the same sparse and supervision points: losses and planes
# within OPTIONS_DEVICE_RTOL of their largest magnitude, and
# VOXELNET_DEVICE_SHARE of a volume's voxels within it; the option groups'
# losses of every step and the planes of their initial weights within
# OPTIONS_DEVICE_RTOL, the first step's gradients on the card as near a
# float64 step on the CPU as TRAIN_GRAD_TOL of each tensor's largest
# magnitude or EIKONAL_NOISE_FACTOR times the CPU's float32 gradients (the
# planes and parameters after the steps are printed: Adam moves a
# parameter whose gradient is float32 noise by up to lr either way)
OPTION_GROUPS = {
    "a": ("mlp.use_spade=true", "mlp.use_layer_norm=true",
          "encoder.plane_merger.strategy=learn", "encoder.pointnet.unet_kwargs.merge_mode=add"),
    "b": ("encoder.pointnet.plane_type=[xz,xy,yz,grid]", "encoder.pointnet.unet3d=true"),
    "c": ("encoder.pointnet.sparsifier=voxel_hash",),
}
OPTIONS_STEPS, OPTIONS_DEVICE_RTOL, OTHER_FRAMES = 3, 1e-4, 2
FRAME_KEYS = ("projection", "image", "depth", "intrinsics", "pose")
# a field sample counts as live below 0.9 of the head's bound (tanh not
# saturated); a kernel check or a march on the flagship needs a tenth of
# its samples live and a tenth of the rays hitting, ten times the rays the
# mask gate lets disagree
FIELD_LIVE, FIELD_MIN_LIVE_SHARE, RENDER_MIN_HIT_SHARE = 0.9, 0.1, 0.1
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


@contextlib.contextmanager
def deterministic_algorithms(torch):
    """torch's deterministic algorithms (warn only, for the ops that have
    none) and cuDNN's inside, the previous settings restored on exit.
    Without them scatter_add's and index_put's atomics add in any order,
    which a gradient that cancels to a small sum, like a bias's on a
    480x640 batch, magnifies to 1e-3 of its max-abs."""
    before = (torch.are_deterministic_algorithms_enabled(),
              torch.is_deterministic_algorithms_warn_only_enabled(),
              torch.backends.cudnn.deterministic)
    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(before[0], warn_only=before[1])
        torch.backends.cudnn.deterministic = before[2]


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


def ray_draws(torch, dev, cfg, batch: dict, seed: int):
    """One ray-mode step's draws (presample, FPS starts, pixel scores, ray
    noise) on `dev` from `seed`, to run the same step twice. The pixel
    scores are a random permutation of each frame's pixels over H*W, all
    distinct: uniform float32 draws over 307,200 pixels tie about once
    among a frame's top 100, and the card's and the CPU's top-k break a
    tie differently."""
    from gennerf_tpu_torch.train.step import StepDraws

    B, T, H, W = batch["depth"].shape
    BT, HW = B * T, H * W
    presample = cfg.encoder.pointnet.fps_presample
    g = torch.Generator(device=dev).manual_seed(seed)
    return StepDraws(sel=torch.randint(0, HW, (BT, presample), generator=g, device=dev),
                     start=torch.randint(0, presample, (BT,), generator=g, device=dev),
                     scores=torch.argsort(torch.rand((BT, HW), generator=g, device=dev),
                                          dim=1).to(torch.float32) / HW,
                     noise=torch.randn((BT, cfg.ray.num_rays, cfg.ray.M), generator=g, device=dev))


def center_field(torch, model, repr_, points, chunk: int = 1 << 16) -> float:
    """Moves lin_out's geometry bias along the head's weight so that the
    median pre-tanh head over `points` (N, 3) of the scene `repr_` is 0, so
    that the field crosses zero there: the field of random or barely
    trained weights may be saturated over a whole box, and a kernel
    compared, or a march, on a saturated field shows little. Returns the
    shift of the pre-tanh head."""
    with torch.no_grad():
        geo = torch.cat([model.decode(repr_, c[None])["feat_geo"][0].double()
                         for c in points.split(chunk)])
        fc = model.head_geo.fc
        w = fc.weight[0].double()
        shift = -float((geo @ w + fc.bias.double()[0]).median())
        bias = model.mlp.lin_out.bias
        bias[:model.cfg.mlp.d_out_geo] += (shift * w / (w @ w)).to(bias.dtype)
    return shift


def plane_coverage(torch, model, points) -> dict:
    """Where (N, 3) world points fall on the triplanes: for each plane the
    share of points whose plane coordinate lies outside [0, 1] on either
    axis and on both (normalize_coordinate clamps those onto the border
    and the corners), and the share of the plane's cells (the pointnet's
    scatter targets) that the points fall in."""
    from gennerf_tpu_torch.ops.coords import coordinate2index, normalize_coordinate

    p = model.cfg.encoder.pointnet
    xyz = model.plane_coords(points.reshape(-1, 3).to(torch.float32))
    out = {}
    for plane, axes in (("xz", [0, 2]), ("xy", [0, 1]), ("yz", [1, 2])):
        uv = xyz[:, axes] / (1.0 + p.padding + 10e-6) + 0.5
        outside = (uv < 0) | (uv > 1 - 10e-6)
        cells = coordinate2index(normalize_coordinate(xyz, p.padding, plane),
                                  p.plane_resolution)
        out[plane] = {"outside_either": float(outside.any(1).double().mean()),
                      "outside_both": float(outside.all(1).double().mean()),
                      "cells_reached": cells.unique().numel() / p.plane_resolution ** 2}
    return out


def cpu_inputs(torch, dev, cfg_, batch_, draws_):
    """A context factory in which the encoder's sparse points (its FPS
    picks of the CPU's clouds) and the step's supervision points are the
    CPU's, on either device, for the card-against-CPU comparisons. Each
    device unprojects the clouds and the rays itself (its own matrix
    inverse and products, an ulp apart), which can flip a near-tie of
    FPS and so the point set, and move a point across a plane cell, a
    texel, a voxel or the eikonal gate, where the planes, the decoded
    gradient and the loss jump; the count of K1's picks on the card's
    own clouds that differ is returned beside it."""
    from unittest import mock

    from gennerf_tpu_torch.models import gen_nerf as gen_nerf_module
    from gennerf_tpu_torch.ops.projection import get_3d_points
    from gennerf_tpu_torch.ops.sampling import (
        farthest_point_sample_plain, fps_cuda, uniform_presample,
    )
    from gennerf_tpu_torch.train import step as step_module

    B_, T_, H_, W_ = batch_["depth"].shape
    pn = cfg_.encoder.pointnet
    cpu = torch.device("cpu")

    def clouds(device):
        c = get_3d_points(batch_["depth"].to(device).reshape(B_ * T_, H_, W_),
                          batch_["projection"].to(device).reshape(B_ * T_, 3, 4))
        return uniform_presample(c.reshape(B_ * T_, -1, 3), pn.fps_presample,
                                 sel=draws_.sel.to(device)).contiguous()

    cloud = clouds(cpu)
    idx = farthest_point_sample_plain(cloud, pn.num_sparse_points, draws_.start.cpu())
    sparse = torch.gather(cloud, 1, idx.long()[..., None].expand(-1, -1, 3))
    on_card = fps_cuda(clouds(dev), pn.num_sparse_points, draws_.start.to(dev, torch.int32))
    mismatches = int((on_card.cpu() != idx).sum())
    sup = step_module.sample_supervision_points(
        cfg_, {k: v.to(cpu) for k, v in batch_.items()},
        draws=draws_._replace(**{k: getattr(draws_, k).to(cpu) for k in draws_._fields
                                 if getattr(draws_, k) is not None}))

    def fps(xyz, npoint, generator=None, start=None):
        return sparse.to(xyz.device, xyz.dtype), idx.to(xyz.device)

    def supervision(cfg__, b, generator=None, draws=None):
        def to(v):
            return v.to(b["depth"].device, b["depth"].dtype) if v.is_floating_point() else \
                v.to(b["depth"].device)
        return {k: to(v) if isinstance(v, torch.Tensor) else v for k, v in sup.items()}

    def patched():
        stack = contextlib.ExitStack()
        stack.enter_context(mock.patch.object(gen_nerf_module, "farthest_point_sample", fps))
        stack.enter_context(mock.patch.object(step_module, "sample_supervision_points",
                                              supervision))
        return stack

    return patched, mismatches


def k1_step_vs_plain(torch, dev, model, batch: dict, seed: int) -> dict:
    """One train step's loss and gradients with K1 against the same step
    with the plain FPS patched into the encoder, on the same weights and
    draws; raises when they disagree beyond TRAIN_LOSS_RTOL and
    TRAIN_GRAD_TOL. The steps run under `deterministic_algorithms`; the K1
    step runs twice to show that floor. These launches are a comparison,
    not the main path."""
    from unittest import mock

    from gennerf_tpu_torch.models import gen_nerf as gen_nerf_module
    from gennerf_tpu_torch.ops import kernels
    from gennerf_tpu_torch.ops.sampling import farthest_point_sample_plain
    from gennerf_tpu_torch.train.step import gen_nerf_forward_loss

    draws = ray_draws(torch, dev, model.cfg, batch, seed)

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

    with deterministic_algorithms(torch):
        loss_k, grads_k, k1_kernel = one_step(plain=False)
        _, grads_k2, _ = one_step(plain=False)
        loss_p, grads_p, k1_plain = one_step(plain=True)
    model.zero_grad(set_to_none=True)
    err = grad_err(grads_k, grads_p)
    worst = max(err, key=err.get)
    vs_plain = {"frames": list(batch["depth"].shape[1:]), "loss_kernel": loss_k,
                "loss_plain": loss_p,
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
                          checkpoints=checkpoints, num_sanity_val_steps=0)
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
                          checkpoints=checkpoints, num_sanity_val_steps=0)
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

        # remat against no remat: one forward and backward in training mode,
        # deterministic algorithms where torch has them
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

        with deterministic_algorithms(torch):
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


def voxelnet_phase(torch, dev, smi: str, root: str) -> dict:
    """Phase 11 (see the module docstring); returns the launch counts of the
    whole phase (all 0: VoxelNet's path has no TPU kernel)."""
    from gennerf_tpu_torch import predict as predict_cli
    from gennerf_tpu_torch import set_reference_precision
    from gennerf_tpu_torch.data.datamodule import ScannetDataModule
    from gennerf_tpu_torch.data.datasets import load_info_json, parse_splits_list
    from gennerf_tpu_torch.eval import evaluation
    from gennerf_tpu_torch.models.voxel_net import VoxelNet
    from gennerf_tpu_torch.ops import kernels
    from gennerf_tpu_torch.predict import build_model
    from gennerf_tpu_torch.train.checkpoints import CheckpointManager
    from gennerf_tpu_torch.train.loop import Trainer
    from gennerf_tpu_torch.train.state import make_optimizer
    from gennerf_tpu_torch.train.step import batch_to_device, train_step, voxel_net_forward_loss
    from gennerf_tpu_torch.utils.config import load_experiment_config

    kernels.reset_launch_counts()
    with tempfile.TemporaryDirectory() as tmp:
        run_dir = os.path.join(tmp, "run")
        cfg = load_experiment_config(VOXELNET_EXPERIMENT, "train", [
            f"paths.data_dir={root}", f"paths.output_dir={run_dir}"])
        data_cfg, trainer_cfg = cfg["data"], cfg["trainer"]
        precision = str(trainer_cfg["precision"])
        datamodule = ScannetDataModule(data_cfg, seed=SEED)
        model = build_model(cfg["model"], dev, SEED, precision)
        mcfg = model.cfg
        if not (isinstance(model, VoxelNet) and model.dtype == torch.bfloat16
                and mcfg.voxel_sizes == (4, 8) and mcfg.backbone3d.channels == (32, 64, 128)):
            raise RuntimeError(f"not the VoxelNet drive config: {precision}, {mcfg}")
        opt = make_optimizer(model.parameters(), mcfg.optimizer,
                             trainer_cfg.get("gradient_clip_val"))
        ckpt_cfg = cfg["callbacks"]["model_checkpoint"]
        checkpoints = CheckpointManager(ckpt_cfg["dirpath"], ckpt_cfg["save_top_k"],
                                        monitor=ckpt_cfg["monitor"], mode=ckpt_cfg["mode"])
        trainer = Trainer(model, opt, torch.Generator(device=dev).manual_seed(SEED), run_dir,
                          max_epochs=VOXELNET_EPOCHS, check_val_every_n_epoch=1,
                          checkpoints=checkpoints, num_sanity_val_steps=0)

        # the main path: the fit over the loaders with its validation and
        # reconstruction tail, in bf16-mixed
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        trainer.fit(datamodule.train_dataloader(), datamodule.val_dataloader())
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        step_ms = [t["step_ms"] for t in trainer.timings]
        fit_rec = {"steps": trainer.global_step, "fit_s": fit_s,
                   "step_ms_median": statistics.median(step_ms), "step_ms_first": step_ms[0],
                   "data_wait_ms_median": statistics.median(
                       t["data_wait_ms"] for t in trainer.timings),
                   "loss_last": trainer.metrics["train_tsdf_loss"],
                   "val_tsdf_loss": trainer.metrics.get("val_tsdf_loss"),
                   "val_recon_tsdf_l1": trainer.metrics.get("val_recon_tsdf_l1"),
                   "best_epoch": checkpoints.best_epoch(),
                   "peak_memory_bytes": torch.cuda.max_memory_allocated()}
        if not (fit_rec["steps"] == 8 * VOXELNET_EPOCHS and fit_rec["best_epoch"] is not None
                and math.isfinite(fit_rec["val_tsdf_loss"] or math.nan)
                and math.isfinite(fit_rec["val_recon_tsdf_l1"] or math.nan)):
            raise RuntimeError(f"the VoxelNet fit or its validation failed: {fit_rec}")

        # one loader batch for the comparisons and the timed steps
        batch = batch_to_device(next(iter(ScannetDataModule(data_cfg, seed=SEED)
                                          .train_dataloader())), dev)
        B, T, H, W = batch["depth"].shape
        fitted = {k: v.clone() for k, v in model.state_dict().items()}

        def fresh(device, dtype, **changes):
            m = VoxelNet(dataclasses.replace(mcfg, **changes), dtype=dtype)
            m.load_state_dict(fitted)
            return m.to(device)

        # the float32 forward and loss on the card (TF32 off) against the CPU, eval mode
        set_reference_precision()
        outs = {}
        for device in (dev, torch.device("cpu")):
            m = fresh(device, torch.float32).eval()
            with torch.no_grad():
                out, losses = m(*(batch[k].to(device) for k in ("projection", "image")),
                                mcfg.voxel_dim_train, None,
                                {k: batch[k].to(device) for k in
                                 ("vol_%02d_tsdf" % vs for vs in mcfg.voxel_sizes)})
            outs[device.type] = ({k: v.cpu() for k, v in out.items()},
                                 {k: float(v) for k, v in losses.items()})
            del m
        device_rec = {}
        for k, ref in outs["cpu"][0].items():
            err = (outs[dev.type][0][k] - ref).abs()
            device_rec[k] = {"max_abs": float(err.max()), "out_abs_max": float(ref.abs().max()),
                             "share_within": float((err <= VOXELNET_DEVICE_TOL
                                                    * ref.abs().max()).float().mean())}
        loss_err = max(abs(outs[dev.type][1][k] - v) / abs(v) for k, v in outs["cpu"][1].items())
        device_rec["loss_rel_err"] = loss_err
        device_rec["tolerance"] = {"over_max_abs": VOXELNET_DEVICE_TOL,
                                   "share": VOXELNET_DEVICE_SHARE,
                                   "loss_rel": VOXELNET_DEVICE_LOSS_RTOL}
        if not (loss_err <= VOXELNET_DEVICE_LOSS_RTOL and all(
                r["share_within"] >= VOXELNET_DEVICE_SHARE for k, r in device_rec.items()
                if k.startswith("vol_"))):
            raise RuntimeError(f"the float32 VoxelNet on the card and on the CPU disagree: "
                               f"{device_rec}")
        del outs

        # precision discipline: dtypes at the boundaries of a bf16 forward,
        # the bf16 loss against the float32 loss, the state after a bf16 step
        seen = {}

        def record(name):
            def hook(module, args, out):
                tensors = out if isinstance(out, (list, tuple)) else [out]
                seen[name] = sorted({str(t.dtype) for x in tensors
                                     for t in (x.values() if isinstance(x, dict) else [x])})
            return hook

        hooks = [mod.register_forward_hook(record(name))
                 for name, mod in (("resnet", model.spatial.resnet), ("spatial", model.spatial),
                                   ("backbone3d", model.backbone3d), ("heads3d", model.heads3d))]
        model.load_state_dict(fitted)
        model.train()
        with torch.no_grad():
            repr_ = model.encode(batch["projection"], batch["image"], mcfg.voxel_dim_train)
            seen["volume"] = [str(repr_.volume.dtype)]
            del repr_
        for h in hooks[:2]:
            h.remove()
        model.load_state_dict(fitted)
        with torch.no_grad():
            loss16, _ = voxel_net_forward_loss(model, batch)
        for h in hooks[2:]:
            h.remove()
        m32 = fresh(dev, torch.float32).train()
        with torch.no_grad():
            loss32, _ = voxel_net_forward_loss(m32, batch)
        del m32
        model.load_state_dict(fitted)
        train_step(model, opt, batch)
        state_dtypes = sorted({str(v.dtype) for v in model.state_dict().values()}
                              | {str(p.grad.dtype) for p in model.parameters()})
        precision_rec = {"dtypes": seen, "state_dtypes_after_bf16_step": state_dtypes,
                         "loss_bf16": float(loss16), "loss_f32": float(loss32),
                         "loss_rel_diff": abs(float(loss16) - float(loss32)) / abs(float(loss32)),
                         "tolerance_rel": VOXELNET_BF16_LOSS_RTOL}
        expect = {"resnet": ["torch.bfloat16"], "spatial": ["torch.bfloat16"],
                  "volume": ["torch.float32"], "backbone3d": ["torch.float32"],
                  "heads3d": ["torch.float32"]}
        if not (seen == expect and state_dtypes == ["torch.float32"]
                and precision_rec["loss_rel_diff"] <= VOXELNET_BF16_LOSS_RTOL):
            raise RuntimeError(f"the bf16-mixed policy is broken: {precision_rec}")

        # remat against no remat: one bf16 forward and backward in training
        # mode, deterministic algorithms where torch has them (the gather's
        # backward adds with atomics; the trilinear upsample's backward has
        # no deterministic version, warn only)
        def forward_backward(m):
            m.train()
            m.zero_grad(set_to_none=True)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t = time.perf_counter()
            loss, _ = voxel_net_forward_loss(m, batch)
            loss.backward()
            torch.cuda.synchronize()
            return (float(loss.detach()), {n: p.grad.clone() for n, p in m.named_parameters()},
                    {k: v.clone() for k, v in m.state_dict().items() if "running_" in k},
                    torch.cuda.max_memory_allocated(), (time.perf_counter() - t) * 1e3)

        with deterministic_algorithms(torch):
            loss_r, grads_r, stats_r, peak_r, ms_r = forward_backward(
                fresh(dev, torch.bfloat16, remat=True))
            loss_p, grads_p, stats_p, peak_p, ms_p = forward_backward(fresh(dev, torch.bfloat16))
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
        del grads_r, grads_p
        if not (remat_rec["loss_rel_err"] <= REMAT_LOSS_RTOL and grad_err[worst] <= REMAT_GRAD_TOL
                and stats_err <= REMAT_STATS_TOL and moved == len(stats_r)):
            raise RuntimeError(f"the VoxelNet remat step disagrees with the step without remat: "
                               f"{remat_rec}")

        # timed bf16 train steps on the loader batch, and one profiled step
        model.load_state_dict(fitted)
        train_ms = []
        torch.cuda.reset_peak_memory_stats()
        for _ in range(VOXELNET_WARMUP + VOXELNET_TIMED_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            train_step(model, opt, batch)
            torch.cuda.synchronize()
            train_ms.append((time.perf_counter() - t0) * 1e3)
        step_peak = torch.cuda.max_memory_allocated()
        med_ms = statistics.median(train_ms[VOXELNET_WARMUP:])
        prof = profile_device(torch, lambda: train_step(model, opt, batch), med_ms, smi)

        # held-out predict from the run directory (its best epoch, the
        # training precision) and the evaluation of both scenes
        pred_dir = os.path.join(tmp, "pred")
        t0 = time.perf_counter()
        results = predict_cli.main(["--config", VOXELNET_EXPERIMENT, "--ckpt", run_dir,
                                    "--data-dir", root, "--split", "val.txt", "--out", pred_dir,
                                    "--device", dev.type])
        predict_s = time.perf_counter() - t0
        with open(os.path.join(pred_dir, "predict_meta.json")) as f:
            predict_meta = json.load(f)
        if (predict_meta["precision"], predict_meta["selected_by"], len(results)) != (
                precision, ckpt_cfg["monitor"], 2):
            raise RuntimeError(f"held-out predict: {predict_meta}, {len(results)} scenes")
        eval_rec = evaluate_held_out(dev, evaluation, parse_splits_list("val.txt", root),
                                     pred_dir, os.path.join(tmp, "oracle"), load_info_json)
        empty = [scene for scene, rec in eval_rec.items() if rec["pred_mesh_empty"]]
        if empty:
            raise RuntimeError(f"empty held-out meshes: {empty}")
        launches = {k.name: k.launches for k in kernels.KERNELS}
        if any(launches.values()):
            raise RuntimeError(f"the VoxelNet phase launched TPU-kernel ports: {launches}")
        emit({"phase": "voxelnet", "config": "configs/experiment/seqs_multigeo_voxelnet.yaml",
              "precision": precision,
              "batch": {"frames": [T, H, W], "resnet_input": [2 * H, 2 * W],
                        "voxel_dim_train": list(mcfg.voxel_dim_train)},
              "fit": fit_rec, "launches": launches, "card_vs_cpu_f32": device_rec,
              "precision_discipline": precision_rec, "remat_vs_plain": remat_rec,
              "train_step_ms": {"median": med_ms, "all": train_ms,
                                "peak_memory_bytes": step_peak},
              "predict": {"meta": predict_meta, "seconds": predict_s, "scenes": results},
              "eval": {scene: rec["pred"] for scene, rec in eval_rec.items()},
              "card": smi})
        emit({"phase": "voxelnet_profile", "what": "one loader-batch bf16-mixed VoxelNet train_step",
              **prof})
    return launches


def flagship_overrides(root: str) -> list:
    """The flagship's one cut as config overrides: its ScanNet scene is not
    in the repository, so the dataset keys (FLAGSHIP_DATA_KEYS) come from
    seqs_multigeo_4cm's data block, on the multigeo dataset at `root`."""
    data = experiment_config(EXPERIMENT, [f"paths.data_dir={root}"])["data"]
    return [f"data.{k}={json.dumps(data[k])}" for k in FLAGSHIP_DATA_KEYS]


def experiment_config(path: str, overrides: list) -> dict:
    """The composed train config of an experiment yaml with overrides."""
    from gennerf_tpu_torch.utils.config import load_experiment_config

    return load_experiment_config(path, "train", overrides)


def flagship_bf16_phase(torch, dev, smi: str, root: str) -> dict:
    """Phase 12 (see the module docstring); returns the launch counts of
    the main-path runs (the fits with their validations, the timed bf16
    steps, the frustum, gradient and spatial steps, the held-out predict,
    the reconstruct at the flagship's grid, the render) and each kernel's
    largest error against its plain version in the phase."""
    from unittest import mock

    import numpy as np

    from gennerf_tpu_torch import predict as predict_cli
    from gennerf_tpu_torch.data.datamodule import ScannetDataModule
    from gennerf_tpu_torch.data.datasets import load_info_json, parse_splits_list
    from gennerf_tpu_torch.data.synthetic import ring_frames
    from gennerf_tpu_torch.eval import evaluation
    from gennerf_tpu_torch.models.gen_nerf import GenNerf
    from gennerf_tpu_torch.ops import grid_decode as grid_decode_module
    from gennerf_tpu_torch.ops import kernels
    from gennerf_tpu_torch.ops.projection import get_3d_points
    from gennerf_tpu_torch.ops.sampling import (
        farthest_point_sample_plain, fps_cuda, uniform_presample,
    )
    from gennerf_tpu_torch.predict import build_model, reconstruct
    from gennerf_tpu_torch.render import render_encoded
    from gennerf_tpu_torch.tools.measure import FPS_INNER, cuda_ms
    from gennerf_tpu_torch.train import loop as loop_module
    from gennerf_tpu_torch.train.checkpoints import CheckpointManager
    from gennerf_tpu_torch.train.loop import Trainer
    from gennerf_tpu_torch.models.positional_encoding import positional_encoding
    from gennerf_tpu_torch.ops.grid_decode import extract_resnetfc_weights, grid_decode_flops
    from gennerf_tpu_torch.ops.point_decode import (
        fused_resnetfc_tsdf_cuda, fused_resnetfc_tsdf_plain, pack_point_weights,
    )
    from gennerf_tpu_torch.train.predict import (
        dense_grid_points, make_point_tsdf_fn, triplane_feat_fast, triplane_gather_setup,
        uses_grid_decode,
    )
    from gennerf_tpu_torch.train import step as step_module
    from gennerf_tpu_torch.train.state import make_optimizer
    from gennerf_tpu_torch.train.step import batch_to_device, gen_nerf_forward_loss, train_step

    totals = {k.name: 0 for k in kernels.KERNELS}

    def read_launches():
        counts = {k.name: k.launches for k in kernels.KERNELS}
        for name, n in counts.items():
            totals[name] += n
        return counts

    data_overrides = flagship_overrides(root)

    def config(path, run_dir=None, extra=()):
        over = [f"paths.data_dir={root}"] + data_overrides + list(extra)
        if run_dir:
            over.append(f"paths.output_dir={run_dir}")
        return experiment_config(path, over)

    def first_batch(data_cfg):
        return batch_to_device(next(iter(ScannetDataModule(data_cfg, seed=SEED)
                                         .train_dataloader())), dev)

    def fit(path, run_dir, extra=()):
        """Trainer.fit of the config in its precision over the loaders, one
        epoch validating at its end; counters reset just before and read
        just after. Returns (model, trainer, record)."""
        cfg = config(path, run_dir, extra)
        precision = str(cfg["trainer"]["precision"])
        model = build_model(cfg["model"], dev, SEED, precision)
        opt = make_optimizer(model.parameters(), model.cfg.optimizer,
                             cfg["trainer"].get("gradient_clip_val"))
        ckpt_cfg = cfg["callbacks"]["model_checkpoint"]
        checkpoints = CheckpointManager(ckpt_cfg["dirpath"], ckpt_cfg["save_top_k"],
                                        monitor=ckpt_cfg["monitor"],
                                        mode=ckpt_cfg.get("mode", "min"))
        trainer = Trainer(model, opt, torch.Generator(device=dev).manual_seed(SEED), run_dir,
                          max_epochs=FLAGSHIP_EPOCHS, check_val_every_n_epoch=1,
                          checkpoints=checkpoints, precision=precision,
                          num_sanity_val_steps=0)
        datamodule = ScannetDataModule(cfg["data"], seed=SEED)
        encodes = []

        def counted(fn):
            def wrapper(*a, **k):
                encodes.append(fn.__name__)
                return fn(*a, **k)
            return wrapper

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        with mock.patch.object(loop_module, "eval_step", counted(loop_module.eval_step)), \
                mock.patch.object(loop_module, "reconstruct", counted(loop_module.reconstruct)):
            t0 = time.perf_counter()
            trainer.fit(datamodule.train_dataloader(), datamodule.val_dataloader())
            torch.cuda.synchronize()
            fit_s = time.perf_counter() - t0
        launches = read_launches()
        steps = trainer.global_step  # fit raises on a non-finite loss
        n_eval, n_tail = encodes.count("eval_step"), encodes.count("reconstruct")
        step_ms = [t["step_ms"] for t in trainer.timings]
        rec = {"precision": precision, "steps": steps, "eval_batches": n_eval, "tails": n_tail,
               "launches": launches, "fit_s": fit_s,
               "step_ms_median": statistics.median(step_ms), "step_ms_first": step_ms[0],
               "data_wait_ms_median": statistics.median(
                   t["data_wait_ms"] for t in trainer.timings),
               "metrics": dict(trainer.metrics),
               "peak_memory_bytes": torch.cuda.max_memory_allocated()}
        if not (launches["fps"] == steps + n_eval + n_tail and launches["grid_decode"] == n_tail
                == FLAGSHIP_EPOCHS and math.isfinite(rec["metrics"].get("val_recon_tsdf_l1",
                                                                         math.nan))):
            raise RuntimeError(f"the {os.path.basename(path)} fit or its validation failed: {rec}")
        return model, trainer, cfg, rec

    def timed_steps(model, opt, batch, n, main_path=True):
        """`FLAGSHIP_WARMUP` + n synchronized train steps from one generator
        (counters reset just before, read just after, and counted on the
        main path), then a profiled step. Returns (step ms, launches,
        profile, peak bytes, losses)."""
        gen = torch.Generator(device=dev).manual_seed(SEED)
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        ms, losses = [], []
        for _ in range(FLAGSHIP_WARMUP + n):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            metrics = train_step(model, opt, batch, gen)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(float(metrics["combined"]))
        launches = (read_launches() if main_path
                    else {k.name: k.launches for k in kernels.KERNELS})
        peak = torch.cuda.max_memory_allocated()
        med = statistics.median(ms[FLAGSHIP_WARMUP:])
        prof = profile_device(torch, lambda: train_step(model, opt, batch, gen), med, smi)
        return ms, launches, prof, peak, losses

    def grads_finite(model):
        return all(p.grad is None or bool(torch.isfinite(p.grad).all())
                   for p in model.parameters())

    with tempfile.TemporaryDirectory() as tmp:
        # the main path: one epoch of the flagship over the loaders in bf16-mixed
        run_dir = os.path.join(tmp, "run")
        model, trainer, cfg, fit_rec = fit(FLAGSHIP_EXPERIMENT, run_dir)
        mcfg, data_cfg = model.cfg, cfg["data"]
        p = mcfg.encoder.pointnet
        shape = {"c_dim": p.c_dim, "hidden_dim": p.hidden_dim, "n_blocks": p.n_blocks,
                 "plane_resolution": p.plane_resolution, "unet_depth": p.unet_depth,
                 "num_sparse_points": p.num_sparse_points,
                 "normalize_coords": p.normalize_coords, "d_hidden": mcfg.mlp.d_hidden,
                 "mlp_blocks": mcfg.mlp.n_blocks, "num_rays": mcfg.ray.num_rays,
                 "voxel_dim_train": tuple(mcfg.voxel_dim_train)}
        if not (model.dtype == torch.bfloat16 and uses_grid_decode(model)
                and shape == FLAGSHIP_SHAPE):
            raise RuntimeError(f"not the flagship config in bf16: {model.dtype}, {shape}")
        opt = trainer.optimizer
        fitted = {k: v.clone() for k, v in model.state_dict().items()}
        batch = first_batch(data_cfg)
        B, T, H, W = batch["depth"].shape

        def fresh(device, dtype, cfg_=None, state=None):
            m = GenNerf(cfg_ or mcfg, dtype=dtype)
            m.load_state_dict(state or fitted)
            return m.to(device)

        # K1 against its plain version at (B*T, 16384), npoint 512, on the
        # batch's presampled clouds (a comparison, not the main path)
        gen = torch.Generator().manual_seed(SEED)
        cloud = get_3d_points(batch["depth"].reshape(B * T, H, W),
                              batch["projection"].reshape(B * T, 3, 4)).reshape(B * T, -1, 3)
        xyz = uniform_presample(cloud, p.fps_presample, gen).contiguous()
        start = torch.randint(0, xyz.shape[1], (B * T,), generator=gen).to(dev, torch.int32)
        npoint = p.num_sparse_points
        idx_k = fps_cuda(xyz, npoint, start)
        k1_plan = dict(kernels.FPS.last_launch)
        idx_p = farthest_point_sample_plain(xyz, npoint, start)
        k1_ms = cuda_ms(torch, lambda: fps_cuda(xyz, npoint, start), reps=20, inner=FPS_INNER)
        k1_rec = {"shape": list(xyz.shape), "npoint": npoint, "plan": k1_plan,
                  "index_mismatches": int((idx_k != idx_p).sum()), "ms": k1_ms,
                  "single_call_ms": cuda_ms(torch, lambda: fps_cuda(xyz, npoint, start), reps=20),
                  "plain_ms": cuda_ms(torch, lambda: farthest_point_sample_plain(
                      xyz, npoint, start), reps=3),
                  "bound_ms": max(10 * xyz.shape[0] * xyz.shape[1] * npoint / PEAK_F32,
                                  (xyz.numel() * 4 + xyz.shape[0] * 4 * (1 + npoint))
                                  / PEAK_BYTES) * 1e3,
                  "bound_by": "operations"}
        if k1_rec["index_mismatches"]:
            raise RuntimeError(f"K1 at npoint {npoint} disagrees with its plain version: {k1_rec}")

        # one bf16 loader-batch step with K1 against the same step with the plain FPS
        model.load_state_dict(fitted)
        vs_plain = k1_step_vs_plain(torch, dev, model, batch, SEED)

        # bf16 against float32: the same weights, batch and draws; the state
        # after a bf16 step
        draws = ray_draws(torch, dev, mcfg, batch, SEED + 1)
        m32 = fresh(dev, torch.float32).train()
        model.train()
        with torch.no_grad():
            loss16 = float(gen_nerf_forward_loss(model, batch, draws=draws)[0])
            loss32 = float(gen_nerf_forward_loss(m32, batch, draws=draws)[0])
        train_step(model, opt, batch, draws=draws)
        state_dtypes = sorted({str(v.dtype) for v in model.state_dict().values()}
                              | {str(q.grad.dtype) for q in model.parameters()}
                              | {str(t.dtype) for st in opt.state.values() for t in st.values()
                                 if isinstance(t, torch.Tensor) and t.is_floating_point()})
        with torch.no_grad():
            repr16 = model.encode(batch["projection"], batch["image"], batch["depth"],
                                  sel=draws.sel, start=draws.start)
            out16 = model.decode(repr16, batch["pose"][:, :, :3, 3].reshape(B, -1, 3) * 0.5)
        dtypes = {"planes": str(repr16.planes["xz"].dtype), "tsdf": str(out16["tsdf"].dtype),
                  "feat": str(out16["feat"].dtype), "feat_geo": str(out16["feat_geo"].dtype)}
        del repr16, out16
        precision_rec = {"loss_bf16": loss16, "loss_f32": loss32,
                         "loss_rel_diff": abs(loss16 - loss32) / abs(loss32),
                         "tolerance_rel": FLAGSHIP_BF16_LOSS_RTOL,
                         "state_dtypes_after_bf16_step": state_dtypes, "dtypes": dtypes}
        if not (precision_rec["loss_rel_diff"] <= FLAGSHIP_BF16_LOSS_RTOL
                and state_dtypes == ["torch.float32"]
                and dtypes == {"planes": "torch.bfloat16", "tsdf": "torch.bfloat16",
                               "feat": "torch.float32", "feat_geo": "torch.float32"}):
            raise RuntimeError(f"the bf16-mixed policy is broken: {precision_rec}")

        # the float32 forward on the card (TF32 off) against the CPU, train
        # mode, on the CPU's FPS picks
        same_inputs, fps_flips = cpu_inputs(torch, dev, mcfg, batch, draws)
        outs = {}
        for device in (dev, torch.device("cpu")):
            m = fresh(device, torch.float32).train()
            d = draws._replace(**{k: getattr(draws, k).to(device) for k in draws._fields
                                  if getattr(draws, k) is not None})
            b = {k: v.to(device) for k, v in batch.items()}
            with torch.no_grad(), same_inputs():
                repr_ = m.encode(b["projection"], b["image"], b["depth"], sel=d.sel, start=d.start)
                loss, _ = gen_nerf_forward_loss(m, b, draws=d)
            outs[device.type] = ({k: v.cpu() for k, v in repr_.planes.items()}, float(loss))
            del m, repr_
        device_rec = {k: float((outs[dev.type][0][k] - v).abs().max()) / float(v.abs().max())
                      for k, v in outs["cpu"][0].items()}
        device_rec["loss_rel_err"] = abs(outs[dev.type][1] - outs["cpu"][1]) / abs(outs["cpu"][1])
        device_rec_tol = max(device_rec.values())
        device_rec["k1_on_card_clouds_index_mismatches"] = fps_flips
        if not device_rec_tol <= FLAGSHIP_DEVICE_TOL:
            raise RuntimeError(f"the float32 flagship on the card and on the CPU disagree: "
                               f"{device_rec}")
        del outs

        # timed bf16 steps on the loader batch (the main path), then the same in float32
        model.load_state_dict(fitted)
        ms16, launches16, prof16, peak16, losses16 = timed_steps(
            model, opt, batch, FLAGSHIP_TIMED_STEPS)
        n16 = FLAGSHIP_WARMUP + FLAGSHIP_TIMED_STEPS
        if launches16["fps"] != n16 or not all(math.isfinite(x) for x in losses16):
            raise RuntimeError(f"the timed bf16 steps: K1 {launches16['fps']} in {n16} steps, "
                               f"losses {losses16}")
        m32 = fresh(dev, torch.float32)
        opt32 = make_optimizer(m32.parameters(), mcfg.optimizer)
        ms32, launches32, prof32, peak32, _ = timed_steps(m32, opt32, batch, FLAGSHIP_TIMED_STEPS,
                                                          main_path=False)
        del m32, opt32
        steps_rec = {
            "bf16": {"step_ms_median": statistics.median(ms16[FLAGSHIP_WARMUP:]),
                     "step_ms_all": ms16, "launches": launches16, "peak_memory_bytes": peak16,
                     "device_busy_ms": prof16["device_busy_ms"],
                     "device_idle_share": prof16["device_idle_share"]},
            "f32": {"step_ms_median": statistics.median(ms32[FLAGSHIP_WARMUP:]),
                    "step_ms_all": ms32, "launches": launches32, "peak_memory_bytes": peak32,
                    "device_busy_ms": prof32["device_busy_ms"],
                    "device_idle_share": prof32["device_idle_share"]}}

        # eikonal: one epoch and its validation in bf16, decode_with_grad on the card
        eik_dir = os.path.join(tmp, "eikonal")
        eik_model, eik_trainer, _, eik_rec = fit(EIKONAL_EXPERIMENT, eik_dir)
        eik_metrics = eik_rec["metrics"]
        if not (eik_model.cfg.loss.use_eikonal and all(
                math.isfinite(eik_metrics.get(k, math.nan)) and eik_metrics[k] > 0
                for k in ("train_eikonal", "val_eikonal"))):
            raise RuntimeError(f"the eikonal term is missing, not finite or 0: {eik_metrics}")
        eik_state = {k: v.clone() for k, v in eik_model.state_dict().items()}
        # its float32 step on the card and on the CPU against float64 on the
        # CPU, on the same inputs, and the card's bf16-mixed step as the
        # control, for EIKONAL_SEEDS draws (deterministic algorithms on the card)
        cpu = torch.device("cpu")
        f32, f64, bf16 = torch.float32, torch.float64, torch.bfloat16
        runs = (("card", dev, f32, f32), ("cpu", cpu, f32, f32), ("cpu_f64", cpu, f64, f32),
                ("card_bf16", dev, f32, bf16))
        eik_seeds = []
        with deterministic_algorithms(torch):
            for seed in range(SEED + 2, SEED + 2 + EIKONAL_SEEDS):
                eik_draws = ray_draws(torch, cpu, eik_model.cfg, batch, seed)
                same_inputs, eik_fps_flips = cpu_inputs(torch, dev, eik_model.cfg, batch,
                                                         eik_draws)
                steps_ = {}
                for name, device, dtype, compute in runs:
                    m = fresh(device, compute, eik_model.cfg, eik_state).to(dtype).train()

                    def to(v):
                        return v.to(device, dtype) if v.is_floating_point() else v.to(device)

                    d = eik_draws._replace(**{k: to(getattr(eik_draws, k))
                                              for k in eik_draws._fields
                                              if getattr(eik_draws, k) is not None})
                    with same_inputs():
                        loss, metrics = gen_nerf_forward_loss(
                            m, {k: to(v) for k, v in batch.items()}, draws=d)
                    loss.backward()
                    steps_[name] = (float(loss.detach()), float(metrics["eikonal"].detach()),
                                    {n: q.grad.cpu().double() for n, q in m.named_parameters()})
                    del m

                def to_f64(a):
                    errs = {n: float((steps_[a][2][n] - g).abs().max())
                            / max(float(g.abs().max()), 1e-30)
                            for n, g in steps_["cpu_f64"][2].items()}
                    worst = max(errs, key=errs.get)
                    return errs[worst], worst

                dist = {k: to_f64(k) for k in ("card", "cpu", "card_bf16")}
                eik_seeds.append({
                    "seed": seed, "loss_card": steps_["card"][0], "loss_cpu": steps_["cpu"][0],
                    "loss_cpu_f64": steps_["cpu_f64"][0], "eikonal_card": steps_["card"][1],
                    "eikonal_cpu": steps_["cpu"][1],
                    "loss_rel_err": abs(steps_["card"][0] - steps_["cpu"][0])
                    / abs(steps_["cpu"][0]),
                    "grad_vs_f64_over_max_abs": {k: v[0] for k, v in dist.items()},
                    "worst_grad": {k: v[1] for k, v in dist.items()},
                    "ratio_to_cpu_f32": {k: dist[k][0] / dist["cpu"][0]
                                         for k in ("card", "card_bf16")},
                    "k1_on_card_clouds_index_mismatches": eik_fps_flips})
                del steps_
        if not all(r["loss_rel_err"] <= TRAIN_LOSS_RTOL
                   and r["ratio_to_cpu_f32"]["card"] <= EIKONAL_NOISE_FACTOR
                   < r["ratio_to_cpu_f32"]["card_bf16"] for r in eik_seeds):
            raise RuntimeError(f"the float32 eikonal step on the card and on the CPU disagree, "
                               f"or the gate cannot tell a bf16 step from float32: {eik_seeds}")
        # the eikonal bf16 step against the flagship's bf16 step
        eik_opt = eik_trainer.optimizer
        eik_gen = torch.Generator(device=dev).manual_seed(SEED)
        kernels.reset_launch_counts()
        eik_ms = host_ms(torch, lambda: train_step(eik_model, eik_opt, batch, eik_gen), 5)
        read_launches()
        eik_rec.update(vs_f64=eik_seeds, step_ms=eik_ms,
                       plain_step_ms=steps_rec["bf16"]["step_ms_median"])
        del eik_model, eik_trainer, eik_opt

        # frustum supervision (the frustumN child) and the gradient loss, one bf16 step each
        side = {}
        for name, path, extra in (
                ("frustum", FRUSTUM_EXPERIMENT, ()),
                ("gradient", FLAGSHIP_EXPERIMENT, ("model.loss.use_gradient=true",))):
            cfg_ = config(path, extra=extra)
            m = build_model(cfg_["model"], dev, SEED, str(cfg_["trainer"]["precision"]))
            o = make_optimizer(m.parameters(), m.cfg.optimizer)
            b = first_batch(cfg_["data"])
            kernels.reset_launch_counts()
            metrics = train_step(m, o, b, torch.Generator(device=dev).manual_seed(SEED))
            torch.cuda.synchronize()
            launches = read_launches()
            side[name] = {"precision": str(cfg_["trainer"]["precision"]),
                          "sampling_mode": m.cfg.sampling_mode,
                          "frames": list(b["depth"].shape[1:]),
                          "frustum": dataclasses.asdict(m.cfg.frustum),
                          "metrics": {k: float(v) for k, v in metrics.items()},
                          "launches": launches, "grads_finite": grads_finite(m)}
            if not (m.dtype == torch.bfloat16 and side[name]["grads_finite"]
                    and all(math.isfinite(v) for v in side[name]["metrics"].values())
                    and launches["fps"] == 1 and (name != "gradient"
                                                  or "gradient" in side[name]["metrics"])):
                raise RuntimeError(f"the bf16 {name} step failed: {side[name]}")
            del m, o, b

        # held-out predict through the predict CLI from the run directory
        # (bf16, recorded), each K2 output against the plain bf16-feed decode
        model.load_state_dict(fitted)
        model.eval()
        decoded = []
        real_k2 = grid_decode_module.grid_decode_cuda

        def recording_k2(tables, weights):
            out = real_k2(tables, weights)
            decoded.append((tables, weights, out))
            return out

        bound = mcfg.mlp.head_smoothing

        def k2_vs_plain():
            """(max, mean abs error, least live share) over the recorded K2 calls."""
            errs = []
            for tables, weights, out in decoded:
                err = (out - grid_decode_module.separable_grid_decode_plain(
                    tables, weights, bf16_feeds=True)).abs()
                errs.append((float(err.max()), float(err.mean()),
                             float((out.abs() < FIELD_LIVE * bound).double().mean())))
            return tuple(f(e[i] for e in errs) for i, f in enumerate((max, max, min)))

        pred_dir = os.path.join(tmp, "pred")
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        with mock.patch.object(grid_decode_module, "grid_decode_cuda", recording_k2):
            results = predict_cli.main(["--config", FLAGSHIP_EXPERIMENT, "--ckpt", run_dir,
                                        "--data-dir", root, "--split", "val.txt",
                                        "--out", pred_dir, "--device", dev.type,
                                        *data_overrides])
        torch.cuda.synchronize()
        predict_s = time.perf_counter() - t0
        predict_launches = read_launches()
        with open(os.path.join(pred_dir, "predict_meta.json")) as f:
            predict_meta = json.load(f)
        if not (predict_meta["precision"] == "bf16-mixed"
                and predict_launches["grid_decode"] == len(decoded) == len(results) == 2):
            raise RuntimeError(f"held-out predict: {predict_meta}, K2 "
                               f"{predict_launches['grid_decode']} for {len(results)} scenes")
        pred_grid = k2_vs_plain()
        decoded.clear()
        eval_rec = evaluate_held_out(dev, evaluation, parse_splits_list("val.txt", root),
                                     pred_dir, os.path.join(tmp, "oracle"), load_info_json)

        # where the step's samples, the encoded clouds and the grids fall on
        # the planes: the raw world coordinates (normalize_coords false) of a
        # crop placed at origin 0 reach the planes' [0, 1] only within
        # (1 + padding) / 2 of the origin, and normalize_coordinate clamps
        # the rest onto the border; the flagship's own 190x180x50 grid at
        # origin 0 beside them
        sup = step_module.sample_supervision_points(mcfg, batch, draws=draws)
        coverage = {
            "step_samples": plane_coverage(torch, model, sup["xyz"]),
            "presampled_clouds": plane_coverage(torch, model, xyz),
            "held_out_grid": plane_coverage(torch, model, dense_grid_points(
                mcfg.voxel_dim_test, mcfg.voxel_size, (0, 0, 0), dev)),
            "flagship_grid": plane_coverage(torch, model, dense_grid_points(
                FLAGSHIP_GRID, mcfg.voxel_size, (0, 0, 0), dev))}
        del sup

        # one reconstruct at the flagship's own grid on the synthetic frames,
        # the field first centred on that grid
        frames = [torch.from_numpy(a).to(dev) for a in ring_frames(
            NUM_FRAMES, HEIGHT, WIDTH, SCENE_CENTER, PRIMITIVES, seed=SEED)]
        with torch.no_grad():
            repr_ = model.encode(*(f[None] for f in frames), torch.Generator().manual_seed(SEED))
        grid_pts = dense_grid_points(FLAGSHIP_GRID, mcfg.voxel_size, (0, 0, 0), dev)
        recon_shift = center_field(torch, model, repr_, grid_pts[::7])
        del repr_, grid_pts
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        with mock.patch.object(grid_decode_module, "grid_decode_cuda", recording_k2):
            vol = reconstruct(model, *frames, FLAGSHIP_GRID, torch.Generator().manual_seed(SEED))
        torch.cuda.synchronize()
        recon_ms = (time.perf_counter() - t0) * 1e3
        recon_launches = read_launches()
        tables, weights, _ = decoded[0]
        recon_grid = k2_vs_plain()
        decoded.clear()
        k2_ms = cuda_ms(torch, lambda: real_k2(tables, weights), reps=10)
        k2_plain_ms = cuda_ms(torch, lambda: grid_decode_module.separable_grid_decode_plain(
            tables, weights, bf16_feeds=True), reps=2)
        H_, nb = weights["w0"].shape[-1], weights["w0"].shape[0]
        k2_flops = grid_decode_flops(FLAGSHIP_GRID, H_, nb)
        k2_bytes = (sum(t.numel() for t in tables) * 4 + sum(
            weights[k].numel() * weights[k].element_size()
            for k in ("k_slabs", "k_b0", "k_b1", "k_w_last")) + math.prod(FLAGSHIP_GRID) * 4)
        k2_rec = {"voxel_dim": list(FLAGSHIP_GRID), "d_in": int(weights["w_in"].shape[0]),
                  "H": H_, "n_blocks": nb, "ms": k2_ms, "plain_ms": k2_plain_ms,
                  "flops": k2_flops, "bytes": k2_bytes,
                  "bound_ms": max(k2_flops / PEAK_BF16, k2_bytes / PEAK_BYTES) * 1e3,
                  "bound_by": "operations" if k2_flops / PEAK_BF16 >= k2_bytes / PEAK_BYTES
                  else "bytes", "tflops_per_s": k2_flops / k2_ms / 1e9,
                  "max_abs_err": recon_grid[0], "mean_abs_err": recon_grid[1],
                  "live_share": recon_grid[2], "field_shift": recon_shift,
                  "negative_share": float((vol < 0).double().mean()),
                  "reconstruct_ms": recon_ms, "launches": recon_launches}
        del tables, weights
        if not (recon_launches["grid_decode"] == 1 and recon_launches["fps"] == 1
                and tuple(vol.shape) == FLAGSHIP_GRID and bool(torch.isfinite(vol).all())
                and max(pred_grid[0], recon_grid[0]) <= GRID_MAX_ABS_TOL
                and max(pred_grid[1], recon_grid[1]) <= GRID_MEAN_ABS_TOL
                and recon_grid[2] >= FIELD_MIN_LIVE_SHARE):
            raise RuntimeError(f"K2 on the bf16 flagship: predict {pred_grid}, {k2_rec}")
        del vol

        # one held-out view from the bf16 model, the field centred on the
        # box the march clips to
        scene_batch = next(iter(ScannetDataModule(data_cfg, seed=SEED).predict_dataloader()))
        view = {k: torch.as_tensor(scene_batch[k][0]).to(dev)
                for k in ("projection", "image", "depth", "intrinsics", "pose")}
        with torch.no_grad():
            repr_ = model.encode(view["projection"][None], view["image"][None],
                                 view["depth"][None], torch.Generator().manual_seed(SEED))
        box = np.array(mcfg.voxel_dim_test, np.float32) * mcfg.voxel_size
        render_shift = center_field(torch, model, repr_, dense_grid_points(
            mcfg.voxel_dim_test, mcfg.voxel_size, (0, 0, 0), dev)[::7])

        # K3 against its plain bf16-feed version at d_in 64 on the view's bf16
        # planes: half the points over the planes' own domain (every texel),
        # half in the march's box (a comparison, not the main path)
        reach = 0.5 * (1.0 + p.padding)
        rng = np.random.default_rng(SEED)
        pts = torch.from_numpy(np.concatenate([
            rng.uniform(-reach, reach, (N_POINTS // 2, 3)),
            rng.uniform(0, box, (N_POINTS // 2, 3))]).astype(np.float32)).to(dev)
        feat = triplane_feat_fast(*triplane_gather_setup(model, repr_.planes), pts[None])[0]
        code = positional_encoding(pts, mcfg.code.num_freqs, mcfg.code.freq_factor,
                                   mcfg.code.include_input)
        pweights = pack_point_weights(extract_resnetfc_weights(
            model.mlp, model.head_geo, mcfg.mlp.d_out_geo, bound))
        pk = fused_resnetfc_tsdf_cuda(feat, code, pweights)
        pp = fused_resnetfc_tsdf_plain(feat, code, pweights, bf16_feeds=True)
        perr = (pk - pp).abs()
        k3_rec = {"points": N_POINTS, "d_in": int(feat.shape[1]), "d_code": int(code.shape[1]),
                  "max_abs_err": float(perr.max()),
                  "mean_abs_err": float(perr.mean()), "out_abs_max": float(pp.abs().max()),
                  "live_share": float((pp.abs() < FIELD_LIVE * bound).double().mean()),
                  "field_shift": render_shift}
        del pts, feat, code, pk, pp, perr
        if not (k3_rec["max_abs_err"] <= POINT_MAX_ABS_TOL
                and k3_rec["mean_abs_err"] <= POINT_MEAN_ABS_TOL
                and k3_rec["live_share"] >= FIELD_MIN_LIVE_SHARE):
            raise RuntimeError(f"K3 at d_in 64 on the bf16 flagship's planes: {k3_rec}")

        # the view through K3 (the main path), against the plain march
        render_args = (model, repr_, view["depth"], view["intrinsics"], view["pose"])
        kernels.reset_launch_counts()
        rk = render_encoded(*render_args, make_point_tsdf_fn(model, repr_), 1)
        torch.cuda.synchronize()
        render_launches = read_launches()
        rp = render_encoded(*render_args, make_point_tsdf_fn(model, repr_, plain=True), 1)
        hk, hp = rk["ray_depth"] > 0, rp["ray_depth"] > 0
        ddiff = np.abs(rk["ray_depth"] - rp["ray_depth"])[hk & hp]
        render_rec = {"scene": scene_batch["scene"][0], "launches": render_launches,
                      "field_shift": render_shift,
                      "hit_share": float(hk.mean()), "hit_share_plain": float(hp.mean()),
                      "vs_plain_mask_agree": float((hk == hp).mean()),
                      "vs_plain_depth_agree": float((ddiff <= RENDER_DEPTH_TOL).mean())
                      if ddiff.size else 0.0, "both_hit_rays": int(ddiff.size)}
        if not (render_launches["point_decode"] >= 1
                and render_rec["hit_share"] >= RENDER_MIN_HIT_SHARE
                and render_rec["vs_plain_mask_agree"] >= RENDER_MASK_AGREE
                and render_rec["vs_plain_depth_agree"] >= RENDER_DEPTH_AGREE):
            raise RuntimeError(f"the bf16 render through K3: {render_rec}")
        del repr_, rk, rp

        # the spatial path in bf16: one step of seqs_multigeo_spatial on its
        # loader batch, its loss against the float32 loss of the same weights
        scfg = experiment_config(SPATIAL_EXPERIMENT, [f"paths.data_dir={root}"])
        s16 = build_model(scfg["model"], dev, SEED, "bf16-mixed").train()
        s32 = GenNerf(s16.cfg).to(dev).train()
        s32.load_state_dict(s16.state_dict())
        sbatch = first_batch(scfg["data"])
        sdraws = ray_draws(torch, dev, s16.cfg, sbatch, SEED + 3)
        with torch.no_grad():
            sloss32 = float(gen_nerf_forward_loss(s32, sbatch, draws=sdraws)[0])
        del s32
        s_opt = make_optimizer(s16.parameters(), s16.cfg.optimizer)
        kernels.reset_launch_counts()
        smetrics = train_step(s16, s_opt, sbatch, draws=sdraws)
        torch.cuda.synchronize()
        spatial_launches = read_launches()
        spatial_rec = {"loss_bf16": float(smetrics["combined"]), "loss_f32": sloss32,
                       "loss_rel_diff": abs(float(smetrics["combined"]) - sloss32) / abs(sloss32),
                       "launches": spatial_launches, "grads_finite": grads_finite(s16)}
        if not (spatial_launches["fps"] == 1 and spatial_rec["grads_finite"]
                and spatial_rec["loss_rel_diff"] <= FLAGSHIP_BF16_LOSS_RTOL):
            raise RuntimeError(f"the bf16 spatial step: {spatial_rec}")
        del s16, s_opt, sbatch

        emit({"phase": "flagship_bf16",
              "config": "configs/experiment/seq1_frames8_evenspaced_pointnet.yaml",
              "data_cut": data_overrides, "precision": fit_rec["precision"],
              "batch": {"frames": [T, H, W], "voxel_dim_train": list(mcfg.voxel_dim_train),
                        "points_per_step": B * T * mcfg.ray.num_rays
                        * (1 + mcfg.ray.N + mcfg.ray.M)},
              "fit": fit_rec, "k1_npoint_512": k1_rec, "vs_plain_fps": vs_plain,
              "precision_discipline": precision_rec, "card_vs_cpu_f32": device_rec,
              "train_steps": steps_rec, "eikonal": eik_rec, **side,
              "predict": {"meta": predict_meta, "seconds": predict_s, "scenes": results,
                          "launches": predict_launches,
                          "grid_vs_plain": {"max_abs": pred_grid[0], "mean_abs": pred_grid[1],
                                            "live_share": pred_grid[2]},
                          "eval": {s_: rec["pred"] for s_, rec in eval_rec.items()}},
              "plane_coverage": coverage, "k2_flagship_grid": k2_rec, "k3_d_in_64": k3_rec,
              "render": render_rec, "spatial_bf16": spatial_rec,
              "tolerance": {"loss_rel": TRAIN_LOSS_RTOL, "grad_over_max_abs": TRAIN_GRAD_TOL,
                            "eikonal_grad_vs_f64_over_cpu_f32": EIKONAL_NOISE_FACTOR,
                            "bf16_loss_rel": FLAGSHIP_BF16_LOSS_RTOL,
                            "device_over_max_abs": FLAGSHIP_DEVICE_TOL,
                            "grid": {"max_abs": GRID_MAX_ABS_TOL, "mean_abs": GRID_MEAN_ABS_TOL},
                            "point": {"max_abs": POINT_MAX_ABS_TOL,
                                      "mean_abs": POINT_MEAN_ABS_TOL},
                            "live": FIELD_LIVE, "min_live_share": FIELD_MIN_LIVE_SHARE,
                            "render": {"mask_agree": RENDER_MASK_AGREE,
                                       "depth_m": RENDER_DEPTH_TOL,
                                       "depth_agree": RENDER_DEPTH_AGREE,
                                       "min_hit_share": RENDER_MIN_HIT_SHARE}},
              "card": smi})
        emit({"phase": "flagship_bf16_profile", "what": "one loader-batch bf16-mixed train_step",
              **prof16})
        emit({"phase": "flagship_f32_profile", "what": "the same train_step in float32",
              **prof32})
    # each kernel's largest error against its plain version at this path's shapes
    errors = {"fps": float((idx_k - idx_p).abs().max()),
              "grid_decode": max(pred_grid[0], recon_grid[0]),
              "point_decode": k3_rec["max_abs_err"]}
    return totals, errors


def distill_phase(torch, dev, smi: str, root: str) -> tuple:
    """Phase 13 (see the module docstring); returns the launch counts of
    the main-path runs (the two fits through the train CLI, the timed
    steps of each mode, the trained model's reconstruct and its held-out
    view through K3, the use_auxiliary step, reconstruct and render) and
    K2's and K3's largest errors against their plain versions in the
    phase."""
    from unittest import mock

    import numpy as np

    from gennerf_tpu_torch.data.datamodule import ScannetDataModule
    from gennerf_tpu_torch.data.synthetic import generate_scene
    from gennerf_tpu_torch.models.positional_encoding import positional_encoding
    from gennerf_tpu_torch.ops import grid_decode as grid_decode_module
    from gennerf_tpu_torch.ops import kernels
    from gennerf_tpu_torch.ops.grid_decode import extract_resnetfc_weights
    from gennerf_tpu_torch.ops.point_decode import (
        fused_resnetfc_tsdf_cuda, fused_resnetfc_tsdf_plain, pack_point_weights,
    )
    from gennerf_tpu_torch.predict import build_model, reconstruct
    from gennerf_tpu_torch.render import render_encoded, render_views
    from gennerf_tpu_torch.train import loop as loop_module
    from gennerf_tpu_torch.train import step as step_module
    from gennerf_tpu_torch.train.__main__ import main as train_main
    from gennerf_tpu_torch.train.predict import (
        dense_grid_points, make_point_tsdf_fn, triplane_feat_fast, triplane_gather_setup,
        uses_grid_decode,
    )
    from gennerf_tpu_torch.train.state import make_optimizer
    from gennerf_tpu_torch.train.step import batch_to_device, gen_nerf_forward_loss, train_step

    totals = {k.name: 0 for k in kernels.KERNELS}

    def read_launches():
        counts = {k.name: k.launches for k in kernels.KERNELS}
        for name, n in counts.items():
            totals[name] += n
        return counts

    t0 = time.perf_counter()
    info = generate_scene(root, num_frames=DISTILL_FRAMES)
    scene_s = time.perf_counter() - t0
    cpu = torch.device("cpu")

    def fit(path, run_dir):
        """The train CLI on the config (its 10 epochs, validation every 5),
        counters reset just before and read just after; each epoch's row
        of metrics.csv. Returns (trainer, record)."""
        evals = []

        def counted(fn):
            def wrapper(*a, **k):
                evals.append(fn.__name__)
                return fn(*a, **k)
            return wrapper

        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        with mock.patch.object(loop_module, "eval_step", counted(loop_module.eval_step)), \
                mock.patch.object(loop_module, "reconstruct", counted(loop_module.reconstruct)):
            t0 = time.perf_counter()
            trainer = train_main(["--config", path, "--data-dir", root, "--out", run_dir,
                                  "--device", dev.type])
            torch.cuda.synchronize()
            fit_s = time.perf_counter() - t0
        launches = read_launches()
        with open(os.path.join(run_dir, "metrics.csv")) as f:
            rows = list(csv.DictReader(f))
        keys = ("train_tsdf", "train_distill", "train_distill_coverage",
                "train_valid_coverage", "train_render_hit_rate", "train_combined")
        last = {int(float(r["epoch"])): r for r in rows if r.get("step_ms")}  # an epoch's last row
        epochs = [{k: float(last[e][k]) for k in keys if last[e].get(k)} for e in sorted(last)]
        val = [{k: float(v) for k, v in r.items() if v and k.startswith("val_")}
               for r in rows if r.get("val_distill")]
        n_eval, n_tail = evals.count("eval_step"), evals.count("reconstruct")
        steps = trainer.global_step
        rec = {"steps": steps, "eval_batches": n_eval, "tails": n_tail, "launches": launches,
               "fit_s": fit_s, "epochs": epochs, "validations": val,
               "step_ms_median": statistics.median(t["step_ms"] for t in trainer.timings),
               "data_wait_ms_median": statistics.median(
                   t["data_wait_ms"] for t in trainer.timings)}
        losses = [v for e in epochs + val for k, v in e.items() if not k.endswith("_rate")]
        if not (len(epochs) == trainer.max_epochs and val and all(map(math.isfinite, losses))
                and all(e["train_distill_coverage"] > 0 for e in epochs)
                and launches["fps"] == steps + n_eval + n_tail
                and launches["grid_decode"] == n_tail):
            raise RuntimeError(f"the {os.path.basename(path)} fit: {rec}")
        return trainer, rec

    def draws_for(model, batch, seed):
        """ray_draws plus distinct render-pixel scores."""
        B, T, H, W = batch["depth"].shape
        g = torch.Generator(device=dev).manual_seed(seed + 100)
        return ray_draws(torch, dev, model.cfg, batch, seed)._replace(
            render_scores=torch.argsort(torch.rand((B * T, H * W), generator=g, device=dev),
                                        dim=1).to(torch.float32) / (H * W))

    def card_vs_cpu(model, batch, seed):
        """The float32 forward loss of one train-mode step on the card and
        on the CPU, both on the CPU's sparse and supervision points and,
        in render mode, the CPU's march; the card's own march against the
        CPU's (hit masks, and depths where both hit)."""
        draws = draws_for(model, batch, seed)
        same_inputs, fps_flips = cpu_inputs(torch, dev, model.cfg, batch, draws)
        state = {k: v.detach().clone() for k, v in model.state_dict().items()}
        real_march = step_module.render_distill_points
        marches = {}
        losses = {}
        for device in (cpu, dev):
            m = build_model(model.cfg, device)
            m.load_state_dict(state)
            m.train()
            d = draws._replace(**{k: getattr(draws, k).to(device) for k in draws._fields
                                  if getattr(draws, k) is not None})

            def march(*a, _device=device, **k):
                own = real_march(*a, **k)
                marches[_device.type] = [t.cpu() for t in own]
                return tuple(t.to(_device) for t in marches["cpu"])

            with torch.no_grad(), same_inputs(), \
                    mock.patch.object(step_module, "render_distill_points", march):
                loss, metrics = gen_nerf_forward_loss(
                    m, {k: v.to(device) for k, v in batch.items()}, draws=d)
            losses[device.type] = (float(loss), {k: float(v) for k, v in metrics.items()})
            del m
        rec = {"loss_cpu": losses["cpu"][0], "loss_card": losses[dev.type][0],
               "loss_rel_err": abs(losses[dev.type][0] - losses["cpu"][0])
               / abs(losses["cpu"][0]),
               "metrics_card": losses[dev.type][1],
               "k1_on_card_clouds_index_mismatches": fps_flips}
        if marches:
            (p_c, _, _, _, hit_c), (p_d, _, _, _, hit_d) = marches["cpu"], marches[dev.type]
            both = (hit_c & hit_d).reshape(-1)
            dist = (p_c.reshape(-1, 3) - p_d.reshape(-1, 3)).norm(dim=-1)[both]
            rec.update(hit_agree=float((hit_c == hit_d).double().mean()),
                       hit_share_cpu=float(hit_c.double().mean()),
                       both_hit_rays=int(both.sum()),
                       point_dist_max_m=float(dist.max()) if dist.numel() else 0.0)
        if not (rec["loss_rel_err"] <= TRAIN_LOSS_RTOL
                and rec.get("hit_agree", 1.0) >= RENDER_MASK_AGREE
                and rec.get("point_dist_max_m", 0.0) <= RENDER_DEPTH_TOL):
            raise RuntimeError(f"a distillation step on the card and on the CPU disagree: {rec}")
        return rec

    def timed_steps(model, opt, batch):
        """DISTILL_WARMUP + DISTILL_TIMED_STEPS synchronized train steps
        (counters reset just before and read just after), then a profiled
        step."""
        gen = torch.Generator(device=dev).manual_seed(SEED)
        kernels.reset_launch_counts()
        ms = []
        for _ in range(DISTILL_WARMUP + DISTILL_TIMED_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            metrics = train_step(model, opt, batch, gen)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        launches = read_launches()
        med = statistics.median(ms[DISTILL_WARMUP:])
        prof = profile_device(torch, lambda: train_step(model, opt, batch, gen), med, smi)
        rec = {"step_ms_median": med, "step_ms_all": ms, "launches": launches,
               "metrics": {k: float(v) for k, v in metrics.items()},
               "device_busy_ms": prof["device_busy_ms"],
               "device_idle_share": prof["device_idle_share"], "top": prof["top"][:6]}
        if launches["fps"] != len(ms) or not all(map(math.isfinite, rec["metrics"].values())):
            raise RuntimeError(f"the timed distillation steps: {rec}")
        return rec

    with tempfile.TemporaryDirectory() as tmp:
        modes, steps_rec, device_rec = {}, {}, {}
        trained = data_cfg = None
        for name, path in (("surface", DISTILL_EXPERIMENT),
                           ("render", DISTILL_RENDER_EXPERIMENT)):
            trainer, modes[name] = fit(path, os.path.join(tmp, name))
            model = trainer.model
            if not (model.teacher is not None and model.cfg.loss.distill.mode == name
                    and model.cfg.mlp.d_out_geo == 64 and model.cfg.mlp.d_out_sem == 64
                    and uses_grid_decode(model)):
                raise RuntimeError(f"not the {name} distillation model: {model.cfg}")
            cfg = experiment_config(path, [f"paths.data_dir={root}"])
            batch = batch_to_device(next(iter(ScannetDataModule(cfg["data"], seed=SEED)
                                              .train_dataloader())), dev)
            device_rec[name] = card_vs_cpu(model, batch, SEED + 5)
            steps_rec[name] = timed_steps(model, trainer.optimizer, batch)
            if name == "surface":
                trained, data_cfg = model, cfg["data"]
            else:
                del model
            del trainer
        model = trained.eval()
        mcfg = model.cfg
        bound = mcfg.mlp.head_smoothing

        # K2 on the trained distillation head (d_geo 64, lin_out 128 wide):
        # the scene's test frames through reconstruct, the field centred
        # first if it is saturated there
        scene_batch = next(iter(ScannetDataModule(data_cfg, seed=SEED).predict_dataloader()))
        view = {k: torch.as_tensor(scene_batch[k][0]).to(dev)
                for k in ("projection", "image", "depth", "intrinsics", "pose")}
        frames = (view["projection"], view["image"], view["depth"])
        decoded = []
        real_k2 = grid_decode_module.grid_decode_cuda

        def recording_k2(tables, weights):
            out = real_k2(tables, weights)
            decoded.append((tables, weights, out))
            return out

        def k2_reconstruct():
            decoded.clear()
            kernels.reset_launch_counts()
            with mock.patch.object(grid_decode_module, "grid_decode_cuda", recording_k2):
                vol = reconstruct(model, *frames, mcfg.voxel_dim_test,
                                  torch.Generator().manual_seed(SEED))
            torch.cuda.synchronize()
            launches = read_launches()
            tables, weights, out = decoded[0]
            err = (out - grid_decode_module.separable_grid_decode_plain(
                tables, weights, bf16_feeds=True)).abs()
            return {"launches": launches, "max_abs_err": float(err.max()),
                    "mean_abs_err": float(err.mean()),
                    "live_share": float((out.abs() < FIELD_LIVE * bound).double().mean()),
                    "finite": bool(torch.isfinite(vol).all()),
                    "d_in": int(weights["w_in"].shape[0])}

        k2_rec = {"trained": k2_reconstruct(), "field_shift": 0.0}
        k2_final = k2_rec["trained"]
        grid_pts = dense_grid_points(mcfg.voxel_dim_test, mcfg.voxel_size, (0, 0, 0), dev)
        if k2_final["live_share"] < FIELD_MIN_LIVE_SHARE:
            with torch.no_grad():
                repr_ = model.encode(*(f[None] for f in frames),
                                     torch.Generator().manual_seed(SEED))
            k2_rec["field_shift"] = center_field(torch, model, repr_, grid_pts)
            k2_rec["centred"] = k2_final = k2_reconstruct()
        if not (k2_final["launches"]["grid_decode"] == 1 and k2_final["launches"]["fps"] == 1
                and k2_final["finite"] and k2_final["live_share"] >= FIELD_MIN_LIVE_SHARE
                and max(r["max_abs_err"] for r in k2_rec.values() if isinstance(r, dict))
                <= GRID_MAX_ABS_TOL
                and max(r["mean_abs_err"] for r in k2_rec.values() if isinstance(r, dict))
                <= GRID_MEAN_ABS_TOL):
            raise RuntimeError(f"K2 on the distillation head: {k2_rec}")

        # K3 on the same head: points in the test box on the view's planes
        # against its plain bf16-feed version (a comparison, not counted),
        # then the view through K3 (the main path, counted apart from the
        # encode's K1) against the plain march; the field
        # centred on the box first if a tenth of it is not live or a tenth
        # of the rays does not hit
        box = np.array(mcfg.voxel_dim_test, np.float32) * mcfg.voxel_size
        pts = torch.from_numpy(np.random.default_rng(SEED).uniform(0, box, (N_POINTS // 4, 3))
                               .astype(np.float32)).to(dev)
        code = positional_encoding(pts, mcfg.code.num_freqs, mcfg.code.freq_factor,
                                   mcfg.code.include_input)

        def k3_view():
            kernels.reset_launch_counts()
            with torch.no_grad():
                repr_ = model.encode(*(f[None] for f in frames),
                                     torch.Generator().manual_seed(SEED))
            torch.cuda.synchronize()
            encode_launches = read_launches()
            feat = triplane_feat_fast(*triplane_gather_setup(model, repr_.planes), pts[None])[0]
            pweights = pack_point_weights(extract_resnetfc_weights(
                model.mlp, model.head_geo, mcfg.mlp.d_out_geo, bound))
            pk = fused_resnetfc_tsdf_cuda(feat, code, pweights)
            pp = fused_resnetfc_tsdf_plain(feat, code, pweights, bf16_feeds=True)
            perr = (pk - pp).abs()
            rec = {"points": int(pts.shape[0]), "d_in": int(feat.shape[1]),
                   "max_abs_err": float(perr.max()), "mean_abs_err": float(perr.mean()),
                   "live_share": float((pp.abs() < FIELD_LIVE * bound).double().mean()),
                   "encode_launches": encode_launches}
            render_args = (model, repr_, view["depth"], view["intrinsics"], view["pose"])
            kernels.reset_launch_counts()
            rk = render_encoded(*render_args, make_point_tsdf_fn(model, repr_), 1)
            torch.cuda.synchronize()
            rec["launches"] = read_launches()
            rp = render_encoded(*render_args, make_point_tsdf_fn(model, repr_, plain=True), 1)
            hk, hp = rk["ray_depth"] > 0, rp["ray_depth"] > 0
            ddiff = np.abs(rk["ray_depth"] - rp["ray_depth"])[hk & hp]
            rec.update(hit_share=float(hk.mean()), vs_plain_mask_agree=float((hk == hp).mean()),
                       vs_plain_depth_agree=float((ddiff <= RENDER_DEPTH_TOL).mean())
                       if ddiff.size else 0.0)
            return rec, repr_

        k3_rec = {"field_shift": 0.0}
        k3_final, repr_ = k3_view()
        k3_rec["trained" if k2_rec["field_shift"] == 0.0 else "centred_for_k2"] = k3_final
        if (k3_final["live_share"] < FIELD_MIN_LIVE_SHARE
                or k3_final["hit_share"] < RENDER_MIN_HIT_SHARE):
            k3_rec["field_shift"] = center_field(torch, model, repr_, grid_pts)
            k3_rec["centred"] = k3_final = k3_view()[0]
        del repr_, pts, code
        k3_runs = [r for r in k3_rec.values() if isinstance(r, dict)]
        if not (k3_final["launches"]["point_decode"] >= 1 and k3_final["launches"]["fps"] == 0
                and k3_final["encode_launches"] == {"fps": 1, "grid_decode": 0, "point_decode": 0}
                and max(r["max_abs_err"] for r in k3_runs) <= POINT_MAX_ABS_TOL
                and max(r["mean_abs_err"] for r in k3_runs) <= POINT_MEAN_ABS_TOL
                and k3_final["live_share"] >= FIELD_MIN_LIVE_SHARE
                and k3_final["hit_share"] >= RENDER_MIN_HIT_SHARE
                and k3_final["vs_plain_mask_agree"] >= RENDER_MASK_AGREE
                and k3_final["vs_plain_depth_agree"] >= RENDER_DEPTH_AGREE):
            raise RuntimeError(f"K3 on the distillation head: {k3_rec}")
        del model, trained

        # use_auxiliary: the teacher's features backprojected into a volume
        # beside the planes; one train step, the card against the CPU, and a
        # reconstruct and a render that take neither K2 nor K3
        acfg = experiment_config(DISTILL_EXPERIMENT, [f"paths.data_dir={root}", *AUX_OVERRIDES])
        aux = build_model(acfg["model"], dev, SEED)
        abatch = batch_to_device(next(iter(ScannetDataModule(acfg["data"], seed=SEED)
                                           .train_dataloader())), dev)
        aux_rec = {"card_vs_cpu": card_vs_cpu(aux, abatch, SEED + 6)}
        aopt = make_optimizer(aux.parameters(), aux.cfg.optimizer)
        kernels.reset_launch_counts()
        metrics = train_step(aux, aopt, abatch, torch.Generator(device=dev).manual_seed(SEED))
        torch.cuda.synchronize()
        aux_rec["step"] = {"metrics": {k: float(v) for k, v in metrics.items()},
                           "launches": read_launches()}
        aux.eval()
        kernels.reset_launch_counts()
        vol = reconstruct(aux, *frames, mcfg.voxel_dim_test, torch.Generator().manual_seed(SEED))
        out = render_views(aux, *frames, view["intrinsics"], view["pose"], num_views=1,
                           generator=torch.Generator().manual_seed(SEED))
        torch.cuda.synchronize()
        aux_rec.update(launches=read_launches(), volume_finite=bool(torch.isfinite(vol).all()),
                       render_hit_share=float((out["ray_depth"] > 0).mean()),
                       d_in=aux.cfg.encoder_latent)
        del aux, aopt, abatch, vol, out
        if not (aux_rec["launches"] == {"fps": 2, "grid_decode": 0, "point_decode": 0}
                and aux_rec["step"]["launches"]["fps"] == 1 and aux_rec["volume_finite"]
                and all(map(math.isfinite, aux_rec["step"]["metrics"].values()))):
            raise RuntimeError(f"the use_auxiliary model: {aux_rec}")

        emit({"phase": "distill", "configs": ["configs/experiment/distill_synthetic.yaml",
                                              "configs/experiment/distill_render_synthetic.yaml"],
              "scene": {"info": os.path.relpath(info, root), "frames": DISTILL_FRAMES,
                        "seconds": scene_s},
              "batch": {"frames": list(batch["depth"].shape[1:])},
              "surface": {**modes["surface"], "steps": steps_rec["surface"],
                          "card_vs_cpu_f32": device_rec["surface"]},
              "render": {**modes["render"], "steps": steps_rec["render"],
                         "card_vs_cpu_f32": device_rec["render"]},
              "k2_distill_head": k2_rec, "k3_distill_head": k3_rec, "use_auxiliary": aux_rec,
              "tolerance": {"loss_rel": TRAIN_LOSS_RTOL, "hit_agree": RENDER_MASK_AGREE,
                            "march_point_m": RENDER_DEPTH_TOL,
                            "grid": {"max_abs": GRID_MAX_ABS_TOL, "mean_abs": GRID_MEAN_ABS_TOL},
                            "point": {"max_abs": POINT_MAX_ABS_TOL,
                                      "mean_abs": POINT_MEAN_ABS_TOL},
                            "min_live_share": FIELD_MIN_LIVE_SHARE},
              "card": smi})
    errors = {"grid_decode": max(r["max_abs_err"] for r in k2_rec.values() if isinstance(r, dict)),
              "point_decode": max(r["max_abs_err"] for r in k3_runs)}
    return totals, errors


def _crc32c(data: bytes) -> int:
    """CRC-32C (Castagnoli), bit by bit: the TFRecord checksum, apart from
    the writer's code (slow: the reader uses it on the short records)."""
    crc = 0xFFFFFFFF
    for b in data:
        crc ^= b
        for _ in range(8):
            crc = (crc >> 1) ^ 0x82F63B78 if crc & 1 else crc >> 1
    return crc ^ 0xFFFFFFFF


def _pb_fields(buf: bytes) -> list:
    """The (field, value) pairs of one protobuf message: varints as ints,
    fixed64 as doubles, fixed32 as floats, length-delimited as bytes."""
    import struct

    out, i = [], 0
    while i < len(buf):
        key, i = _varint_at(buf, i)
        field, wire = key >> 3, key & 7
        if wire == 0:
            value, i = _varint_at(buf, i)
        elif wire == 1:
            value, i = struct.unpack("<d", buf[i:i + 8])[0], i + 8
        elif wire == 5:
            value, i = struct.unpack("<f", buf[i:i + 4])[0], i + 4
        elif wire == 2:
            n, i = _varint_at(buf, i)
            value, i = buf[i:i + n], i + n
        else:
            raise RuntimeError(f"protobuf wire type {wire} in a tfevents record")
        out.append((field, value))
    return out


def _varint_at(buf: bytes, i: int):
    value = shift = 0
    while True:
        b = buf[i]
        i += 1
        value |= (b & 0x7F) << shift
        shift += 7
        if not b & 0x80:
            return value, i


def read_tfevents(path: str) -> list:
    """The summary values of a tfevents file: TFRecord framing (length,
    masked CRC32C of the length, the Event proto, its masked CRC32C; every
    CRC checked), each Event's step and each Summary.Value as a dict of
    tag, step and one of simple_value, image {height, width, png} or
    tensor, with its plugin's name. The CRCs are computed by the port's
    `_masked_crc` (held to the JAX writer's on the CPU) and, for records of
    at most 4 KiB (scalars, hparams, the file header), also by this
    script's own bitwise CRC."""
    import struct

    from gennerf_tpu_torch.train.loggers import _masked_crc

    def masked(data):
        crc = _masked_crc(data)
        if len(data) <= 4096:
            own = _crc32c(data)
            if crc != ((own >> 15 | own << 17) + 0xA282EAD8) & 0xFFFFFFFF:
                raise RuntimeError("the writer's CRC32C disagrees with the reader's")
        return crc

    with open(path, "rb") as f:
        raw = f.read()
    values, i, records = [], 0, 0
    while i < len(raw):
        header = raw[i:i + 8]
        (n,) = struct.unpack("<Q", header)
        (crc_header,) = struct.unpack("<I", raw[i + 8:i + 12])
        record = raw[i + 12:i + 12 + n]
        (crc_record,) = struct.unpack("<I", raw[i + 12 + n:i + 16 + n])
        if masked(header) != crc_header or masked(record) != crc_record or len(record) != n:
            raise RuntimeError(f"{path}: bad TFRecord framing at byte {i}")
        i += 16 + n
        records += 1
        event = dict(_pb_fields(record))
        step = event.get(2, 0)
        for field, summary in _pb_fields(record):
            if field != 5:
                continue
            for vfield, value in _pb_fields(summary):
                v = dict(_pb_fields(value))
                entry = {"tag": v[1].decode(), "step": step}
                if 2 in v:
                    entry["simple_value"] = v[2]
                if 4 in v:
                    img = dict(_pb_fields(v[4]))
                    entry["image"] = {"height": img[1], "width": img[2], "png": img[4]}
                if 8 in v:
                    entry["tensor"] = v[8]
                if 9 in v:
                    plugin = dict(_pb_fields(dict(_pb_fields(v[9]))[1]))
                    entry["plugin"] = plugin[1].decode()
                values.append(entry)
    if not records:
        raise RuntimeError(f"{path}: no records")
    return values


def harness_phase(torch, dev, smi: str, root: str) -> tuple:
    """Phase 14 (see the module docstring); returns the launch counts of
    the main-path runs (the fit with its test pass, the resume, the sweep,
    the overhead fits) and K2's largest error against its plain version
    over the fit's tails."""
    import io
    import signal
    from unittest import mock

    import numpy as np

    from gennerf_tpu_torch.data.datamodule import ScannetDataModule
    from gennerf_tpu_torch.ops import grid_decode as grid_decode_module
    from gennerf_tpu_torch.ops import kernels
    from gennerf_tpu_torch.ops import sampling as sampling_module
    from gennerf_tpu_torch.predict import build_model
    from gennerf_tpu_torch.train import loop as loop_module
    from gennerf_tpu_torch.train import sweep
    from gennerf_tpu_torch.train.__main__ import main as train_main
    from gennerf_tpu_torch.train.callbacks import ProgressBar, clear_device_caches
    from gennerf_tpu_torch.train.checkpoints import load_checkpoint
    from gennerf_tpu_torch.train.loggers import MetricsLogger
    from gennerf_tpu_torch.train.loop import Trainer, trainer_options
    from gennerf_tpu_torch.train.state import make_optimizer
    from gennerf_tpu_torch.utils.config import load_experiment_config
    from gennerf_tpu_torch.utils.image import decode_png

    t_phase = time.perf_counter()
    totals = {k.name: 0 for k in kernels.KERNELS}

    def read_launches():
        counts = {k.name: k.launches for k in kernels.KERNELS}
        for name, n in counts.items():
            totals[name] += n
        return counts

    def csv_rows(path):
        with open(path) as f:
            return list(csv.DictReader(f))

    with tempfile.TemporaryDirectory() as tmp:
        # (1) one fit through the train CLI with the harness options
        run = os.path.join(tmp, "fit")
        prof_dir = os.path.join(tmp, "prof")
        evals, decoded, sampled = [], [], []
        real_k1, real_k2 = sampling_module.fps_cuda, grid_decode_module.grid_decode_cuda

        def recording_k1(xyz, npoint, start, cluster=0):
            out = real_k1(xyz, npoint, start, cluster)
            sampled.append((xyz, npoint, start, out))
            return out

        def recording_k2(tables, weights):
            out = real_k2(tables, weights)
            decoded.append((tables, weights, out))
            return out

        def counted(fn):
            def wrapper(*a, **k):
                evals.append(fn.__name__)
                return fn(*a, **k)
            return wrapper

        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        with mock.patch.object(loop_module, "eval_step", counted(loop_module.eval_step)), \
                mock.patch.object(loop_module, "reconstruct", counted(loop_module.reconstruct)), \
                mock.patch.object(grid_decode_module, "grid_decode_cuda", recording_k2), \
                mock.patch.object(sampling_module, "fps_cuda", recording_k1):
            t0 = time.perf_counter()
            trainer = train_main(["--config", EXPERIMENT, "--data-dir", root, "--out", run,
                                  "--device", dev.type, *HARNESS_OVERRIDES,
                                  f"trainer.profile_dir={prof_dir}"])
            torch.cuda.synchronize()
            fit_s = time.perf_counter() - t0
        launches = read_launches()
        steps, n_eval, n_tail = trainer.global_step, evals.count("eval_step"), evals.count(
            "reconstruct")
        rows = csv_rows(os.path.join(run, "metrics.csv"))
        epoch_steps = {}
        for r in rows:
            if r.get("epoch"):
                epoch_steps[int(float(r["epoch"]))] = int(float(r["step"]))
        epochs_run = len(epoch_steps)
        val = [float(r["val_combined"]) for r in rows if r.get("val_combined")]
        # the stopping epoch the logged val_combined sequence dictates
        best, stale, expected_stop = None, 0, None
        for epoch, v in enumerate(val):
            if epoch + 1 < HARNESS_MIN_EPOCHS:
                continue
            if best is None or v < best:
                best, stale = v, 0
            else:
                stale += 1
                if stale >= HARNESS_PATIENCE:
                    expected_stop = epoch
                    break
        expected_epochs = 6 if expected_stop is None else expected_stop + 1
        grid_err = []
        for tables, weights, out in decoded:
            err = (out - grid_decode_module.separable_grid_decode_plain(
                tables, weights, bf16_feeds=True)).abs()
            grid_err.append((float(err.max()), float(err.mean())))
        del decoded
        # each K1 launch of the fit against the plain FPS on its inputs
        fps_diff = [(out - sampling_module.farthest_point_sample_plain(xyz, npoint, start)).abs()
                    for xyz, npoint, start, out in sampled]
        fps_mismatches = [int((d != 0).sum()) for d in fps_diff]
        fps_max = max(float(d.max()) for d in fps_diff)
        del fps_diff
        k1_shapes = sorted({(*xyz.shape[:2], npoint) for xyz, npoint, _, _ in sampled})
        del sampled
        grid_max = max(e[0] for e in grid_err)
        grid_mean = max(e[1] for e in grid_err)

        # the tfevents file against metrics.csv, the images against local/
        tb_dir = os.path.join(run, "tensorboard")
        (events_file,) = os.listdir(tb_dir)
        tb = read_tfevents(os.path.join(tb_dir, events_file))
        scalars = {(v["tag"], v["step"]): v["simple_value"] for v in tb if "simple_value" in v}
        missing = [(k, r["step"]) for r in rows for k, x in r.items() if k != "step" and x
                   and scalars.get((k, int(float(r["step"])))) != float(np.float32(float(x)))]
        images = {}
        for v in tb:
            if "image" in v:
                images[v["tag"]] = decode_png(v["image"]["png"])
        image_tags = [f"{m}_render/{n}" for m in ("val", "test")
                      for n in ("overview", "frame0", "frame1")]
        local_same = {tag: bool(np.array_equal(images[tag], decode_png(open(
            os.path.join(run, "local", tag + ".png"), "rb").read()))) for tag in image_tags
            if tag in images}
        not_white = {tag: float((images[tag] != 255).mean()) for tag in images}
        mesh_tags = sorted({v["tag"] for v in tb if v.get("plugin") == "mesh"})
        hparams = [v for v in tb if v.get("plugin") == "hparams"]
        with open(trainer.profile_trace) as f:
            trace = json.load(f)["traceEvents"]
        device_events = [e.get("name", "") for e in trace if e.get("cat") == "kernel"]
        fps_events = [n for n in device_events if "fps_" in n]
        fit_rec = {
            "config": "configs/experiment/seqs_multigeo_4cm.yaml",
            "overrides": list(HARNESS_OVERRIDES), "steps": steps, "epochs_run": epochs_run,
            "epoch_last_steps": epoch_steps, "val_combined": val,
            "expected_epochs": expected_epochs, "eval_batches": n_eval, "tails": n_tail,
            "launches": launches, "fit_s": fit_s, "epoch_s": trainer.epoch_seconds,
            "k1_vs_plain": {"launches": len(fps_mismatches), "shapes": k1_shapes,
                            "index_mismatches": sum(fps_mismatches)},
            "k2_vs_plain": {"max_abs": grid_max, "mean_abs": grid_mean, "tails": len(grid_err)},
            "tfevents": {"values": len(tb), "scalars": len(scalars),
                         "scalars_missing": missing[:5], "images": sorted(images),
                         "not_white": not_white, "mesh_tensors": mesh_tags,
                         "hparams": len(hparams)},
            "local_images_equal": local_same,
            "logs": sorted(f for f in os.listdir(run) if f.endswith(".log")),
            "profile": {"trace": os.path.basename(trainer.profile_trace),
                        "device_events": len(device_events), "fps_events": len(fps_events),
                        "fps_symbol": fps_events[0][:80] if fps_events else None},
            "test_combined": trainer.metrics.get("test_combined"), "card": smi}
        emit({"phase": "harness_fit", **fit_rec})
        if not (all(epoch_steps[e] == HARNESS_STEPS_PER_EPOCH * (e + 1) for e in epoch_steps)
                and steps == HARNESS_STEPS_PER_EPOCH * epochs_run):
            raise RuntimeError(f"an epoch did not run {HARNESS_STEPS_PER_EPOCH} steps: "
                               f"{epoch_steps}, {steps} steps")
        if epochs_run != expected_epochs or len(val) != epochs_run:
            raise RuntimeError(f"early stopping ran {epochs_run} epochs, val_combined {val} "
                               f"dictates {expected_epochs}")
        if launches["fps"] != steps + n_eval + n_tail or launches["grid_decode"] != n_tail:
            raise RuntimeError(f"K1 {launches['fps']} / K2 {launches['grid_decode']} launches "
                               f"for {steps} steps, {n_eval} eval batches, {n_tail} tails")
        if len(fps_mismatches) != launches["fps"] or any(fps_mismatches):
            raise RuntimeError(f"the fit's K1 launches against the plain FPS: {fps_mismatches}")
        if n_tail != epochs_run + 1 or len(grid_err) != n_tail or not (
                grid_max <= GRID_MAX_ABS_TOL and grid_mean <= GRID_MEAN_ABS_TOL):
            raise RuntimeError(f"the tails' K2 volumes against the plain decode: {grid_err}")
        if missing or len(hparams) != 1 or sorted(local_same) != sorted(image_tags) or not all(
                local_same.values()) or not all(not_white[t] > 0 for t in image_tags):
            raise RuntimeError(f"tfevents or local images incomplete: {fit_rec['tfevents']}, "
                               f"{local_same}")
        if not {f"{m}_mesh/{m}_{w}_mesh_{c}" for m in ("val", "test") for w in ("pred", "trgt")
                for c in ("VERTEX", "FACE")} <= set(mesh_tags):
            raise RuntimeError(f"mesh-plugin tensors missing: {mesh_tags}")
        if fit_rec["logs"] != ["config_tree.log", "tags.log"] or not fps_events:
            raise RuntimeError(f"config tree, tags or the FPS kernel in the trace missing: "
                               f"{fit_rec['logs']}, {fit_rec['profile']}")
        if not math.isfinite(fit_rec["test_combined"] or math.nan):
            raise RuntimeError(f"the test pass: {fit_rec['test_combined']}")

        # the overheads, on one loader batch of each split repeated (the
        # loaders' start and waits would drown them): clear_cache per epoch
        # (3 steps and a validation batch with its tail an epoch), the
        # progress line and the tfevents writer per step (a fit logging
        # every step, no validation); in turns off, on, on, off on one model
        cfg = load_experiment_config(EXPERIMENT, "train", [f"paths.data_dir={root}"])
        datamodule = ScannetDataModule(cfg["data"], seed=SEED)
        batch = next(iter(datamodule.train_dataloader()))
        val_batch = next(iter(datamodule.val_dataloader()))
        model = build_model(cfg["model"], dev, SEED)
        opt = make_optimizer(model.parameters(), model.cfg.optimizer, None)
        base = trainer_options(cfg["trainer"], {})
        base.pop("gradient_clip_val")
        base.update(num_sanity_val_steps=0, save_on_preempt=False)
        cache_epoch_s, step_host_ms = {False: [], True: []}, {False: [], True: []}
        kernels.reset_launch_counts()
        for on in (False, True, True, False):
            t = Trainer(model, opt, torch.Generator(device=dev).manual_seed(SEED), None,
                        **dict(base, max_epochs=OVERHEAD_EPOCHS, check_val_every_n_epoch=1,
                               clear_cache=on))
            t.fit([batch] * HARNESS_STEPS_PER_EPOCH, [val_batch])
            cache_epoch_s[on].append(statistics.median(t.epoch_seconds[1:]))
        for on in (False, True, True, False):
            out = os.path.join(tmp, f"overhead_{on}_{len(step_host_ms[on])}")
            logger = MetricsLogger(out, {"tensorboard": {}})
            if not on:  # the run's own metrics.csv only
                logger.scalar_loggers = []
            t = Trainer(model, opt, torch.Generator(device=dev).manual_seed(SEED), out,
                        logger=logger, **dict(base, max_epochs=1, log_every_n_steps=1))
            t.progress = ProgressBar(enabled=on, stream=io.StringIO())
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            t.fit([batch] * OVERHEAD_STEPS)
            torch.cuda.synchronize()
            step_host_ms[on].append((time.perf_counter() - t0) * 1e3 / OVERHEAD_STEPS)
        overhead_launches = read_launches()
        clear_ms = host_ms(torch, lambda: clear_device_caches(dev), 5)
        emit({"phase": "harness_overhead",
              "clear_cache_epoch_s": {"off": cache_epoch_s[False], "on": cache_epoch_s[True]},
              "clear_cache_cost_s_per_epoch": statistics.mean(cache_epoch_s[True])
              - statistics.mean(cache_epoch_s[False]),
              "clear_device_caches_call_ms": clear_ms,
              "epoch": {"train_steps": HARNESS_STEPS_PER_EPOCH, "val_batches": 1,
                        "epochs_timed": OVERHEAD_EPOCHS - 1, "batches": "one loader batch each"},
              "fit_host_ms_per_step": {"own_csv_only": step_host_ms[False],
                                       "tensorboard_and_bar": step_host_ms[True]},
              "writer_and_bar_ms_per_step": statistics.mean(step_host_ms[True])
              - statistics.mean(step_host_ms[False]),
              "steps_per_fit": OVERHEAD_STEPS, "log_every_n_steps": 1,
              "launches": overhead_launches, "card": smi})
        del model, opt

        # (2) the SIGTERM save in a subprocess, then its resume in process
        sig_dir = os.path.join(tmp, "sigterm")
        sig_args = ["--config", EXPERIMENT, "--data-dir", root, "--device", dev.type,
                    "trainer.max_epochs=50", "trainer.log_every_n_steps=1",
                    "trainer.limit_train_batches=3", "trainer.limit_val_batches=1",
                    "trainer.check_val_every_n_epoch=1", "test=true"]
        t0 = time.perf_counter()
        proc = subprocess.Popen([sys.executable, "-m", "gennerf_tpu_torch.train", "--out",
                                 sig_dir, *sig_args], cwd=os.path.dirname(os.path.abspath(
                                     __file__)), stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        try:
            metrics_csv = os.path.join(sig_dir, "metrics.csv")
            logged = 0
            while logged < SIGTERM_STEP:
                if proc.poll() is not None or time.perf_counter() - t0 > SIGTERM_TIMEOUT_S:
                    raise RuntimeError(f"the SIGTERM run ended or stalled before step "
                                       f"{SIGTERM_STEP}: rc {proc.poll()}")
                time.sleep(0.05)
                try:
                    logged = max((int(float(r["step"])) for r in csv_rows(metrics_csv)),
                                 default=0)
                except (OSError, TypeError, ValueError):  # not written yet, or mid-row
                    logged = 0
            t_signal = time.perf_counter()
            proc.send_signal(signal.SIGTERM)
            log, _ = proc.communicate(timeout=SIGTERM_TIMEOUT_S)
            exit_s = time.perf_counter() - t_signal
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
        rows = csv_rows(metrics_csv)
        last_step = max(int(float(r["step"])) for r in rows)
        last_epoch = max(int(float(r["epoch"])) for r in rows if r.get("epoch"))
        tested = [k for r in rows for k, v in r.items() if k.startswith("test_") and v]
        probe = build_model(cfg["model"], torch.device("cpu"), SEED)
        saved = load_checkpoint(os.path.join(sig_dir, "checkpoints", "last.pt"), probe)
        del probe
        kernels.reset_launch_counts()
        resumed = train_main(["--out", os.path.join(tmp, "resumed"), "--resume", sig_dir,
                              *sig_args[:-1], f"trainer.max_epochs={last_epoch + 2}"])
        torch.cuda.synchronize()
        resume_launches = read_launches()
        resumed_rows = csv_rows(os.path.join(tmp, "resumed", "metrics.csv"))
        resumed_epochs = sorted({int(float(r["epoch"])) for r in resumed_rows if r.get("epoch")})
        sig_rec = {"returncode": proc.returncode, "signal_at_step": logged,
                   "last_logged": {"step": last_step, "epoch": last_epoch}, "checkpoint": saved,
                   "test_keys_after": tested, "exit_s_after_signal": exit_s,
                   "preempt_logged": "preempted at step" in log,
                   "resumed_epochs": resumed_epochs, "resumed_steps": resumed.global_step,
                   "resumed_loss": resumed.metrics.get("train_combined"),
                   "resume_launches": resume_launches, "card": smi}
        emit({"phase": "harness_sigterm", **sig_rec})
        if proc.returncode != 0 or not sig_rec["preempt_logged"]:
            raise RuntimeError(f"the SIGTERM run exited {proc.returncode}:\n{log[-3000:]}")
        if saved != {"epoch": last_epoch, "step": last_step} or tested:
            raise RuntimeError(f"the SIGTERM save {saved} is not the last logged step "
                               f"{last_step} of epoch {last_epoch}, or a test pass ran: {tested}")
        if resumed_epochs != [last_epoch + 1] or not math.isfinite(
                sig_rec["resumed_loss"] or math.nan):
            raise RuntimeError(f"the resume ran epochs {resumed_epochs}: {sig_rec}")

        # (3) a 2-trial grid sweep over the learning rate
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        records = sweep.main(
            ["--output", os.path.join(tmp, "sweep"), "--", "--config", EXPERIMENT,
             "--data-dir", root, "--device", dev.type, "trainer.max_epochs=1",
             "trainer.limit_train_batches=1", "trainer.limit_val_batches=1",
             "trainer.check_val_every_n_epoch=1"],
            spec={"method": "grid", "metric": "val_combined",
                  "parameters": {"model.optimizer.lr": {"values": list(SWEEP_LRS)}}})
        torch.cuda.synchronize()
        sweep_s = time.perf_counter() - t0
        sweep_launches = read_launches()
        with open(os.path.join(tmp, "sweep", "sweep_results.jsonl")) as f:
            written = [json.loads(line) for line in f]
        emit({"phase": "harness_sweep", "records": records, "written": len(written),
              "seconds": sweep_s, "launches": sweep_launches, "card": smi})
        if written != records or len(records) != len(SWEEP_LRS) or not all(
                math.isfinite(r.get("metrics", {}).get("val_combined", math.nan))
                for r in records):
            raise RuntimeError(f"the sweep's records: {records}")
    phase_s = time.perf_counter() - t_phase
    emit({"phase": "harness", "seconds": phase_s, "launches": totals, "card": smi})
    return totals, {"fps": fps_max, "grid_decode": grid_max}


def to_device(draws, device):
    """StepDraws with every draw on `device`."""
    return draws._replace(**{k: getattr(draws, k).to(device) for k in draws._fields
                             if getattr(draws, k) is not None})


def same_sparse(torch, dev, cfg_, batch_, draws_):
    """`cpu_inputs`' context factory for either sparsifier: the encoder's
    sparse points (FPS picks, or voxel_hash's with the draws' scores) and
    the supervision points the CPU's, on either device."""
    from unittest import mock

    from gennerf_tpu_torch.models import gen_nerf as gen_nerf_module
    from gennerf_tpu_torch.ops.projection import get_3d_points
    from gennerf_tpu_torch.ops.sampling import uniform_presample, voxel_hash_downsample

    pn = cfg_.encoder.pointnet
    if pn.sparsifier != "voxel_hash":
        return cpu_inputs(torch, dev, cfg_, batch_, draws_)[0]
    B_, T_, H_, W_ = batch_["depth"].shape
    start = torch.zeros(B_ * T_, dtype=torch.int64, device=dev)  # cpu_inputs' FPS, unused
    fps_and_supervision = cpu_inputs(torch, dev, cfg_, batch_, draws_._replace(start=start))[0]
    cloud = get_3d_points(batch_["depth"].cpu().reshape(B_ * T_, H_, W_),
                          batch_["projection"].cpu().reshape(B_ * T_, 3, 4))
    cloud = uniform_presample(cloud.reshape(B_ * T_, -1, 3), pn.fps_presample,
                              sel=draws_.sel.cpu())
    sparse, idx = voxel_hash_downsample(cloud, pn.num_sparse_points, rnd=draws_.start.cpu())

    def voxel_hash(xyz, npoint, generator=None, rnd=None):
        return sparse.to(xyz.device, xyz.dtype), idx.to(xyz.device)

    def patched():
        stack = fps_and_supervision()
        stack.enter_context(mock.patch.object(gen_nerf_module, "voxel_hash_downsample",
                                              voxel_hash))
        return stack

    return patched


def fabricate_reference(torch, model, seed: int) -> dict:
    """A reference-named state dict for `model`'s architecture, drawn with
    numpy from `seed`: every name the reference's (the port's but for
    `spatial.resnet.` -> `encoder.model.`, no `mlp.alpha`, torchvision's
    `num_batches_tracked` counters beside the ResNet's BatchNorms); the
    kernels of the BatchNorm stacks (the ResNet, the 3D backbone) He-normal,
    std sqrt(2 / fan_in), so that their activations keep the scale that
    random running statistics assume; every other matrix and kernel normal
    with std 1/sqrt(fan_in) (the pointnet, its UNet and ResnetFC's residual
    stream stay of order one); vectors normal at 0.05; BatchNorm scales and
    variances uniform in [0.5, 1.5]."""
    import numpy as np

    rng = np.random.default_rng(seed)
    out = {}
    for key, value in model.state_dict().items():
        if key == "mlp.alpha":
            continue
        shape = tuple(value.shape)
        if key.endswith("running_var") or (value.dim() == 1 and (
                key.endswith("weight") and ("bn" in key or "norm" in key
                                            or "downsample.1" in key or ".ln." in key))):
            arr = rng.uniform(0.5, 1.5, shape)
        elif value.dim() > 1:
            gain = 2.0 if key.startswith(("spatial.resnet.", "backbone3d.")) else 1.0
            arr = rng.standard_normal(shape) * np.sqrt(gain / value[0].numel())
        else:
            arr = 0.05 * rng.standard_normal(shape)
        if key.startswith("spatial.resnet."):
            key = "encoder.model." + key[len("spatial.resnet."):]
            if key.endswith("running_var"):
                out[key[:-len("running_var")] + "num_batches_tracked"] = np.array(1000)
        out[key] = arr.astype(np.float32)
    return out


def save_reference_ckpt(torch, path: str, reference: dict) -> None:
    """`reference` as a Lightning-style .ckpt whose hyper_parameters pickle
    a class of a module that exists only while the file is written (as
    omegaconf's DictConfig in a real one, on a machine without omegaconf)."""
    import types

    name = "gennerf_reference_absent.dictconfig"
    mod = types.ModuleType(name)

    class DictConfig(dict):
        pass

    DictConfig.__module__, DictConfig.__qualname__ = name, "DictConfig"
    mod.DictConfig = DictConfig
    sys.modules["gennerf_reference_absent"] = types.ModuleType("gennerf_reference_absent")
    sys.modules[name] = mod
    try:
        torch.save({"state_dict": {k: torch.from_numpy(v) for k, v in reference.items()},
                    "hyper_parameters": DictConfig(model={"type": "GenNerf"}),
                    "epoch": 0, "global_step": 0, "pytorch-lightning_version": "2.1.0"}, path)
    finally:
        del sys.modules["gennerf_reference_absent"], sys.modules[name]


def weights_options_phase(torch, dev, smi: str, root: str) -> tuple:
    """Phase 15 (see the module docstring); returns the launch counts of
    the main-path runs (the CLIs on the reference checkpoint, the option
    groups' steps and reconstructs, PointNet++) and each kernel's largest
    error against its plain version there."""
    from unittest import mock

    import numpy as np

    from gennerf_tpu_torch import predict as predict_cli
    from gennerf_tpu_torch import render as render_cli
    from gennerf_tpu_torch.data.datamodule import ScannetDataModule
    from gennerf_tpu_torch.models.gen_nerf import GenNerf
    from gennerf_tpu_torch.models.pointnetpp import PointNetPlusPlus
    from gennerf_tpu_torch.models.voxel_net import VolumeRepr
    from gennerf_tpu_torch.ops import grid_decode as grid_decode_module
    from gennerf_tpu_torch.ops import kernels
    from gennerf_tpu_torch.ops import sampling as sampling_module
    from gennerf_tpu_torch.ops.projection import get_3d_points
    from gennerf_tpu_torch.predict import build_model, load_params, reconstruct
    from gennerf_tpu_torch.render import render_encoded
    from gennerf_tpu_torch.train.checkpoints import load_checkpoint, save_checkpoint
    from gennerf_tpu_torch.train.predict import make_point_tsdf_fn, uses_grid_decode
    from gennerf_tpu_torch.train.state import make_optimizer
    from gennerf_tpu_torch.train.step import batch_to_device, gen_nerf_forward_loss, train_step
    from gennerf_tpu_torch.utils.port_reference import (
        port_reference_state, read_reference_checkpoint, reference_state_dict,
    )

    t_phase = time.perf_counter()
    totals = {k.name: 0 for k in kernels.KERNELS}
    cpu = torch.device("cpu")

    def read_launches():
        counts = {k.name: k.launches for k in kernels.KERNELS}
        for name, n in counts.items():
            totals[name] += n
        return counts

    def config(path, extra=()):
        return experiment_config(path, [f"paths.data_dir={root}", *extra])

    def first_batch(data_cfg, frames=None):
        batch = next(iter(ScannetDataModule(data_cfg, seed=SEED).train_dataloader()))
        batch = batch_to_device(batch, dev)
        if frames:
            batch = {k: v[:, :frames] if v.dim() > 2 and k in FRAME_KEYS else v
                     for k, v in batch.items()}
        return batch

    def timed_read(model, path, partial=False):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loaded = load_params(model, path, partial)
        torch.cuda.synchronize()
        return loaded, (time.perf_counter() - t0) * 1e3

    sampled, decoded = [], []
    real_k1, real_k2 = sampling_module.fps_cuda, grid_decode_module.grid_decode_cuda

    def recording_k1(xyz, npoint, start, cluster=0):
        out = real_k1(xyz, npoint, start, cluster)
        sampled.append((xyz, npoint, start, out, dict(kernels.FPS.last_launch)))
        return out

    def recording_k2(tables, weights):
        out = real_k2(tables, weights)
        decoded.append((tables, weights, out))
        return out

    def k1_vs_plain():
        """Each recorded K1 launch against the plain FPS on its inputs."""
        recs = [{"shape": list(xyz.shape), "npoint": npoint, "plan": plan,
                 "index_mismatches": int((out != sampling_module.farthest_point_sample_plain(
                     xyz, npoint, start)).sum())} for xyz, npoint, start, out, plan in sampled]
        sampled.clear()
        return recs

    def k2_vs_plain():
        errs = []
        for tables, weights, out in decoded:
            err = (out - grid_decode_module.separable_grid_decode_plain(
                tables, weights, bf16_feeds=True)).abs()
            errs.append((float(err.max()), float(err.mean())))
        decoded.clear()
        return errs

    recording = (mock.patch.object(sampling_module, "fps_cuda", recording_k1),
                 mock.patch.object(grid_decode_module, "grid_decode_cuda", recording_k2))
    with open(os.path.join(root, "val.txt")) as f:
        first_scene = next(line for line in f if line.strip())
    with open(os.path.join(root, "val_one.txt"), "w") as f:
        f.write(first_scene)
    errors = {"fps": 0.0, "grid_decode": 0.0, "point_decode": 0.0}

    with tempfile.TemporaryDirectory() as tmp:
        # (1) a fabricated reference checkpoint of the full-width
        # seqs_multigeo_4cm through the predict and render CLIs' --params
        cfg = config(EXPERIMENT)
        data_cfg = dict(cfg["data"], datasets_test=["val_one.txt"])
        model = build_model(cfg["model"], dev, SEED)
        reference = fabricate_reference(torch, model, SEED + 13)
        port_state = port_reference_state(model, {k: torch.from_numpy(v)
                                                  for k, v in reference.items()}).state
        model.load_state_dict(port_state)
        # random weights need not cross zero: lin_out's geometry bias moves so
        # that the median pre-tanh head over the rendered view's measured
        # surface points is 0
        scene_batch = next(iter(ScannetDataModule(data_cfg, seed=SEED).test_dataloader()))
        view = {k: torch.as_tensor(np.asarray(scene_batch[k][0])).to(dev)
                for k in ("projection", "image", "depth", "intrinsics", "pose")}
        mcfg = model.cfg
        with torch.no_grad():
            repr_ = model.encode(view["projection"][None], view["image"][None],
                                 view["depth"][None], torch.Generator().manual_seed(SEED))
        surface = get_3d_points(view["depth"][:1], view["projection"][:1]).reshape(-1, 3)
        shift = center_field(torch, model, repr_, surface[view["depth"][0].reshape(-1) > 0])
        reference["mlp.lin_out.bias"] = model.mlp.lin_out.bias.detach().cpu().numpy()
        ckpt = os.path.join(tmp, "last.ckpt")
        save_reference_ckpt(torch, ckpt, reference)

        pred_dir, render_dir = os.path.join(tmp, "pred"), os.path.join(tmp, "render")
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        with recording[0], recording[1]:
            results = predict_cli.main(["--config", EXPERIMENT, "--params", ckpt, "--data-dir",
                                        root, "--split", "val_one.txt", "--out", pred_dir,
                                        "--device", dev.type])
            torch.cuda.synchronize()
            predict_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            rendered = render_cli.main(["--config", EXPERIMENT, "--params", ckpt, "--data-dir",
                                        root, "--split", "val_one.txt", "--out", render_dir,
                                        "--num-views", "1", "--device", dev.type])
            torch.cuda.synchronize()
            render_s = time.perf_counter() - t0
        cli_launches = read_launches()
        cli_k1 = k1_vs_plain()
        cli_k2 = k2_vs_plain()
        with open(os.path.join(pred_dir, "predict_meta.json")) as f:
            predict_meta = json.load(f)
        if not (cli_launches["fps"] == 2 and cli_launches["grid_decode"] == 1
                and cli_launches["point_decode"] >= 1 and len(cli_k1) == 2 and len(cli_k2) == 1
                and all(r["index_mismatches"] == 0 for r in cli_k1)
                and cli_k2[0][0] <= GRID_MAX_ABS_TOL and cli_k2[0][1] <= GRID_MEAN_ABS_TOL
                and predict_meta["params_format"] == "reference"
                and not predict_meta["left_at_init"]):
            raise RuntimeError(f"the reference checkpoint's predict and render: launches "
                               f"{cli_launches}, K1 {cli_k1}, K2 {cli_k2}, meta {predict_meta}")
        errors["grid_decode"] = cli_k2[0][0]

        # the view through K3 against the plain march, on the reader's weights
        reader_model = build_model(cfg["model"], dev, SEED + 1)
        _, read_ms = timed_read(reader_model, ckpt)
        with torch.no_grad():
            repr_ = reader_model.encode(view["projection"][None], view["image"][None],
                                        view["depth"][None], torch.Generator().manual_seed(SEED),
                                        voxel_dim=mcfg.voxel_dim_test)
        render_args = (reader_model, repr_, view["depth"], view["intrinsics"], view["pose"])
        rk = render_encoded(*render_args, make_point_tsdf_fn(reader_model, repr_), 1)
        rp = render_encoded(*render_args, make_point_tsdf_fn(reader_model, repr_, plain=True), 1)
        hk, hp = rk["ray_depth"] > 0, rp["ray_depth"] > 0
        ddiff = np.abs(rk["ray_depth"] - rp["ray_depth"])[hk & hp]
        k3_rec = {"image": list(view["depth"].shape[-2:]), "hit_share": float(hk.mean()),
                  "vs_plain_mask_agree": float((hk == hp).mean()),
                  "vs_plain_depth_agree": float((ddiff <= RENDER_DEPTH_TOL).mean())
                  if ddiff.size else 0.0, "field_shift": shift}
        if not (k3_rec["hit_share"] >= RENDER_MIN_HIT_SHARE
                and k3_rec["vs_plain_mask_agree"] >= RENDER_MASK_AGREE
                and k3_rec["vs_plain_depth_agree"] >= RENDER_DEPTH_AGREE):
            raise RuntimeError(f"the reference checkpoint's view through K3: {k3_rec}")
        del repr_, rk, rp

        # writer -> reader bit for bit; the same weights loaded natively (a
        # port checkpoint through --ckpt's loader) and through the reader give
        # the same volume, bit for bit (deterministic scatters)
        written = os.path.join(tmp, "written.ckpt")
        torch.save({"state_dict": reference_state_dict(reader_model)}, written)
        back = port_reference_state(reader_model, read_reference_checkpoint(written).state_dict)
        roundtrip_equal = all(torch.equal(back.state[k].to(dev), v)
                              for k, v in reader_model.state_dict().items())
        native = build_model(cfg["model"], dev, SEED + 2)
        native_pt = os.path.join(tmp, "native.pt")
        save_checkpoint(native_pt, reader_model, make_optimizer(reader_model.parameters(),
                                                                mcfg.optimizer), 0, 0)
        load_checkpoint(native_pt, native)
        scene = tuple(view[k] for k in ("projection", "image", "depth"))
        with deterministic_algorithms(torch):
            vol_reader = reconstruct(reader_model, *scene, None,
                                     torch.Generator().manual_seed(SEED))
            vol_native = reconstruct(native, *scene, None, torch.Generator().manual_seed(SEED))
        roundtrip = {"writer_reader_bit_equal": roundtrip_equal,
                     "native_vs_reader_volume_bit_equal": bool(torch.equal(vol_reader,
                                                                           vol_native)),
                     "native_vs_reader_max_abs": float((vol_reader - vol_native).abs().max())}
        del native, vol_reader, vol_native
        if not (roundtrip["writer_reader_bit_equal"]
                and roundtrip["native_vs_reader_volume_bit_equal"]):
            raise RuntimeError(f"the writer and reader round trip: {roundtrip}")
        main_rec = {"config": "configs/experiment/seqs_multigeo_4cm.yaml",
                    "tensors": len(reference), "read_ms": read_ms,
                    "predict": {"seconds": predict_s, "scenes": results, "meta": predict_meta},
                    "render": {"seconds": render_s, "mean_random_weights_not_quality": rendered},
                    "launches": cli_launches, "k1_vs_plain": cli_k1,
                    "k2_vs_plain": {"max_abs": cli_k2[0][0], "mean_abs": cli_k2[0][1]},
                    "k3_view_vs_plain": k3_rec, "roundtrip": roundtrip}
        del model, reader_model

        # (2) the spatial model and VoxelNet from fabricated reference
        # checkpoints: one float32 forward on the card against the CPU
        others = {}
        for name, path in (("spatial", SPATIAL_EXPERIMENT), ("voxelnet", VOXELNET_EXPERIMENT)):
            ocfg = config(path, ["trainer.precision=32-true"])
            omodel = build_model(ocfg["model"], dev, SEED)
            ref_o = fabricate_reference(torch, omodel, SEED + 14)
            if name == "voxelnet":  # its 2D projection's reference name is not documented
                ref_o = {k: v for k, v in ref_o.items() if not k.startswith("spatial.proj.")}
            opath = os.path.join(tmp, f"{name}.pth")
            torch.save({k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in ref_o.items()},
                       opath)
            loaded, o_read_ms = timed_read(omodel, opath, partial=name == "voxelnet")
            ocpu = build_model(ocfg["model"], cpu, SEED)
            ocpu.load_state_dict({k: v.cpu() for k, v in omodel.state_dict().items()})
            batch = first_batch(ocfg["data"], frames=OTHER_FRAMES)
            outs = {}
            if name == "spatial":
                draws = ray_draws(torch, dev, omodel.cfg, batch, SEED + 4)
                same = same_sparse(torch, dev, omodel.cfg, batch, draws)
            # VoxelNet in training mode: its norms then normalize by the
            # batch's statistics, so that the fabricated weights' activations
            # keep the scale of a trained model's rather than growing
            # through the 3D stack (running statistics drawn at random do
            # not normalize)
            for device, m in ((cpu, ocpu.train(name == "voxelnet")),
                              (dev, omodel.train(name == "voxelnet"))):
                b = {k: v.to(device) for k, v in batch.items()}
                with torch.no_grad():
                    if name == "voxelnet":
                        # the encode on this device, then the refine of the
                        # CPU's volume (a projection flip at a pixel edge
                        # spreads through every 3D convolution after it)
                        own = m.encode(b["projection"], b["image"], m.cfg.voxel_dim_train)
                        if device.type == "cpu":
                            cpu_volume = own
                        out, losses = m.refine(
                            VolumeRepr(*(t.to(device) for t in cpu_volume)),
                            {k: b[k] for k in ("vol_%02d_tsdf" % vs for vs in m.cfg.voxel_sizes)})
                        outs[device.type] = ({"volume": own.volume.cpu(),
                                              **{k: v.cpu() for k, v in out.items()}},
                                             float(sum(losses.values())))
                    else:
                        d = to_device(draws, device)
                        with same():
                            r = m.encode(b["projection"], b["image"], b["depth"], sel=d.sel,
                                         start=d.start, voxel_dim=m.cfg.voxel_dim_train)
                            loss, _ = gen_nerf_forward_loss(m, b, draws=d)
                        outs[device.type] = ({"volume": r.volume.cpu(),
                                              **{k: v.cpu() for k, v in r.planes.items()}},
                                             float(loss))
            # a voxel whose projection lies within an ulp of a pixel edge
            # takes the other pixel on the other device (each projects
            # itself), so volumes are held by the share of voxels within
            # the tolerance, as the voxelnet phase holds them; planes (on
            # the CPU's points) and the loss by their largest difference
            rec = {}
            for k, v in outs["cpu"][0].items():
                err = (outs[dev.type][0][k] - v).abs()
                rec[k] = {"max_rel": float(err.max()) / float(v.abs().max()),
                          "share_within": float((err <= OPTIONS_DEVICE_RTOL * v.abs().max())
                                                .double().mean())}
            loss_err = abs(outs[dev.type][1] - outs["cpu"][1]) / abs(outs["cpu"][1])
            others[name] = {"tensors": len(ref_o), "read_ms": o_read_ms,
                            "left_at_init": loaded["unfilled"], "card_vs_cpu": rec,
                            "loss_rel_err": loss_err, "frames": OTHER_FRAMES}
            volumes_ok = all(r["share_within"] >= VOXELNET_DEVICE_SHARE if k.startswith("vol")
                             else r["max_rel"] <= OPTIONS_DEVICE_RTOL for k, r in rec.items())
            if not volumes_ok or loss_err > OPTIONS_DEVICE_RTOL or (
                    loaded["unfilled"] != (["spatial.proj.weight", "spatial.proj.bias"]
                                           if name == "voxelnet" else [])):
                raise RuntimeError(f"the {name} reference checkpoint on the card: "
                                   f"{others[name]}")
            del omodel, ocpu, outs, batch

        # (3) the option groups: 3 float32 steps with injected draws on the
        # card (the main path, counted) and a reconstruct; the same steps
        # on the card and on the CPU on the CPU's sparse and supervision
        # points, held together
        groups = {}
        for group, overrides in OPTION_GROUPS.items():
            gcfg = config(EXPERIMENT, ["trainer.precision=32-true",
                                       *(f"model.{o}" for o in overrides)])
            gmodel = build_model(gcfg["model"], dev, SEED).train()
            init = {k: v.clone() for k, v in gmodel.state_dict().items()}
            gc = gmodel.cfg
            voxel_hash = gc.encoder.pointnet.sparsifier == "voxel_hash"
            batch = first_batch(gcfg["data"])
            B, T, H, W = batch["depth"].shape
            step_draws = []
            for i in range(OPTIONS_STEPS):
                d = ray_draws(torch, dev, gc, batch, SEED + 20 + i)
                if voxel_hash:  # the sparsifier's draw: (B*T, presample) uniform scores
                    g = torch.Generator(device=dev).manual_seed(SEED + 30 + i)
                    d = d._replace(start=torch.rand((B * T, gc.encoder.pointnet.fps_presample),
                                                    generator=g, device=dev))
                step_draws.append(d)
            opt = make_optimizer(gmodel.parameters(), gc.optimizer)
            torch.cuda.synchronize()
            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            for d in step_draws:
                train_step(gmodel, opt, batch, draws=d)
            torch.cuda.synchronize()
            step_ms = (time.perf_counter() - t0) * 1e3 / OPTIONS_STEPS
            gmodel.eval()
            t0 = time.perf_counter()
            with recording[1]:
                vol = reconstruct(gmodel, *scene, None, torch.Generator().manual_seed(SEED))
            torch.cuda.synchronize()
            recon_ms = (time.perf_counter() - t0) * 1e3
            launches = read_launches()
            k2_errs = k2_vs_plain()
            expect_k2 = int(uses_grid_decode(gmodel))
            expect = {"fps": 0 if voxel_hash else OPTIONS_STEPS + 1,
                      "grid_decode": expect_k2, "point_decode": 0}
            # card and CPU, the same steps on the CPU's points
            sames = [same_sparse(torch, dev, gc, batch, d) for d in step_draws]
            finals = {}
            for device in (dev, cpu):
                m = GenNerf(gc).to(device)
                m.load_state_dict({k: v.to(device) for k, v in init.items()})
                mopt = make_optimizer(m.parameters(), gc.optimizer)
                b = {k: v.to(device) for k, v in batch.items()}
                planes = {}
                for when in ("initial", "after_steps"):
                    if when == "after_steps":
                        m.train()
                        losses = []
                        for d, same in zip(step_draws, sames):
                            with same(), deterministic_algorithms(torch):
                                losses.append(float(train_step(
                                    m, mopt, b, draws=to_device(d, device))["combined"]))
                            if len(losses) == 1:
                                grads = {k: p.grad.detach().cpu().clone()  # the merger has none
                                         for k, p in m.named_parameters() if p.grad is not None}
                    m.eval()
                    d0 = to_device(step_draws[0], device)
                    with torch.no_grad(), sames[0]():
                        r = m.encode(b["projection"], b["image"], b["depth"], sel=d0.sel,
                                     start=d0.start)
                    planes[when] = {k: v.cpu() for k, v in r.planes.items()}
                finals[device.type] = (losses, planes, {k: v.detach().cpu() for k, v in
                                                        m.named_parameters()}, grads)
                del m, mopt
            loss_err = max(abs(a - b) / abs(b) for a, b in zip(finals[dev.type][0],
                                                                finals["cpu"][0]))
            plane_err = {when: {k: float((finals[dev.type][1][when][k] - v).abs().max())
                                / float(v.abs().max()) for k, v in ref.items()}
                         for when, ref in finals["cpu"][1].items()}
            # the first step's gradients of both against a float64 step on the
            # CPU: sums that cancel (a norm's bias over a mostly empty grid)
            # are float32 noise in either summation order, so the card may be
            # as far from float64 as TRAIN_GRAD_TOL of a tensor's largest
            # magnitude, or EIKONAL_NOISE_FACTOR times the CPU's own distance
            m64 = GenNerf(gc).to(torch.float64).train()
            m64.load_state_dict({k: v.cpu().double() for k, v in init.items()})

            def f64(v):
                return v.cpu().double() if v.is_floating_point() else v.cpu()

            d64 = step_draws[0]._replace(**{k: f64(getattr(step_draws[0], k))
                                            for k in step_draws[0]._fields
                                            if getattr(step_draws[0], k) is not None})
            with sames[0]():
                loss64, _ = gen_nerf_forward_loss(m64, {k: f64(v) for k, v in batch.items()},
                                                  draws=d64)
            loss64.backward()
            g64 = {k: q.grad for k, q in m64.named_parameters() if q.grad is not None}
            del m64

            def to_f64(grads):
                errs = {k: float((grads[k].double() - g).abs().max())
                        / max(float(g.abs().max()), 1e-30) for k, g in g64.items()}
                worst = max(errs, key=errs.get)
                return errs[worst], worst

            grad_dist = {"card": to_f64(finals[dev.type][3]), "cpu": to_f64(finals["cpu"][3])}
            # Adam's first updates are lr * g / (|g| + eps): a gradient near 0
            # whose float32 value differs between the devices moves its
            # parameter by up to lr either way, and the planes after the
            # steps with it; both are printed
            lr = gc.optimizer.lr
            diff = torch.cat([(finals[dev.type][2][k] - v).abs().reshape(-1)
                              for k, v in finals["cpu"][2].items()])
            param_rec = {"max_over_lr": float(diff.max()) / lr,
                         "share_within_1e-2_lr": float((diff <= 1e-2 * lr).double().mean())}
            rec = {"overrides": list(overrides), "launches": launches, "expected": expect,
                   "step_ms": step_ms, "reconstruct_ms": recon_ms,
                   "route": "grid_decode" if expect_k2 else "decode_dense",
                   "volume_finite": bool(torch.isfinite(vol).all()),
                   "losses_card": finals[dev.type][0], "losses_cpu": finals["cpu"][0],
                   "loss_rel_err": loss_err, "plane_rel_err": plane_err,
                   "first_step_grad_vs_f64_over_max_abs": {k: v[0] for k, v in
                                                           grad_dist.items()},
                   "first_step_worst_grad": {k: v[1] for k, v in grad_dist.items()},
                   "params_after_steps": param_rec, "k2_vs_plain": k2_errs}
            groups[group] = rec
            if not (launches == expect and rec["volume_finite"]
                    and loss_err <= OPTIONS_DEVICE_RTOL
                    and max(plane_err["initial"].values()) <= OPTIONS_DEVICE_RTOL
                    and grad_dist["card"][0] <= max(TRAIN_GRAD_TOL,
                                                    EIKONAL_NOISE_FACTOR * grad_dist["cpu"][0])
                    and all(e[0] <= GRID_MAX_ABS_TOL and e[1] <= GRID_MEAN_ABS_TOL
                            for e in k2_errs)):
                raise RuntimeError(f"option group {group}: {rec}")
            if k2_errs:
                errors["grid_decode"] = max(errors["grid_decode"], k2_errs[0][0])
            del gmodel, opt, batch, vol, init

        # (4) PointNet++ on one (8, 16384) presampled cloud: K1 at npoint 128,
        # then 32 on the 128 centroids, each launch index-exact
        batch = first_batch(cfg["data"])
        B, T, H, W = batch["depth"].shape
        cloud = get_3d_points(batch["depth"].reshape(B * T, H, W),
                              batch["projection"].reshape(B * T, 3, 4)).reshape(B * T, -1, 3)
        cloud = sampling_module.uniform_presample(
            cloud, PRESAMPLE, torch.Generator().manual_seed(SEED)).contiguous()
        pnpp = PointNetPlusPlus().to(dev).eval()
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        with recording[0], torch.no_grad():
            feature = pnpp(cloud, torch.Generator().manual_seed(SEED))
        torch.cuda.synchronize()
        pnpp_ms = (time.perf_counter() - t0) * 1e3
        pnpp_launches = read_launches()
        pnpp_k1 = k1_vs_plain()
        pnpp_rec = {"cloud": list(cloud.shape), "launches": pnpp_launches, "ms": pnpp_ms,
                    "feature": list(feature.shape), "finite": bool(torch.isfinite(feature).all()),
                    "k1": pnpp_k1}
        if not (pnpp_launches["fps"] == 2 and [r["npoint"] for r in pnpp_k1] == [128, 32]
                and [r["shape"][1] for r in pnpp_k1] == [PRESAMPLE, 128]
                and all(r["index_mismatches"] == 0 for r in pnpp_k1) and pnpp_rec["finite"]):
            raise RuntimeError(f"PointNet++ on the card: {pnpp_rec}")
        del batch, cloud, pnpp

    emit({"phase": "weights_options", "reference_ckpt": main_rec, "reference_others": others,
          "option_groups": groups, "pointnetpp": pnpp_rec,
          "tolerance": {"grid": {"max_abs": GRID_MAX_ABS_TOL, "mean_abs": GRID_MEAN_ABS_TOL},
                        "render": {"mask_agree": RENDER_MASK_AGREE, "depth_m": RENDER_DEPTH_TOL,
                                   "depth_agree": RENDER_DEPTH_AGREE,
                                   "min_hit_share": RENDER_MIN_HIT_SHARE},
                        "card_vs_cpu_rel": OPTIONS_DEVICE_RTOL},
          "phase_s": time.perf_counter() - t_phase, "card": smi})
    return totals, errors


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
        # 11. voxelnet: the second model family in bf16-mixed on the same
        # dataset, then a held-out predict and evaluation
        voxelnet_launches = voxelnet_phase(torch, dev, smi, root)
        # 12. flagship_bf16: the flagship GenNerf in bf16-mixed, its eikonal
        # and frustum children and the gradient loss on the same dataset,
        # then a held-out predict, the flagship's grid, a render
        flagship_launches, flagship_errors = flagship_bf16_phase(torch, dev, smi, root)
        # 13. distill: both distillation experiments through the train CLI on
        # their synthetic scene, K2 and K3 on the trained head, use_auxiliary
        distill_launches, distill_errors = distill_phase(
            torch, dev, smi, os.path.join(data_tmp, "synth0"))
        # 14. harness: the train CLI's harness (early stopping, batch limits,
        # the profiler window, the loggers, the SIGTERM save, the sweep) on
        # the data phase's dataset
        harness_launches, harness_errors = harness_phase(torch, dev, smi, root)
        # 15. weights_options: a reference checkpoint through the CLIs'
        # --params (K1, K2, K3), the writer and reader round trip, the spatial
        # and VoxelNet readers, the GenNerf options on the card against the
        # CPU, PointNet++'s K1
        weights_launches, weights_errors = weights_options_phase(torch, dev, smi, root)

    kernel_line = {"kernels": [
        {"name": "fps", "route": "cuda", "source": "gennerf_tpu_torch/csrc/fps.cu",
         "replaces": "gennerf_tpu/ops/pallas/fps.py:33",
         "launches": (launches["fps"] + render_launches["fps"] + mesh_launches["fps"]
                      + sparse_launches["fps"] + train_launches["fps"] + data_launches["fps"]
                      + spatial_launches["fps"] + voxelnet_launches["fps"]
                      + flagship_launches["fps"] + distill_launches["fps"]
                      + harness_launches["fps"] + weights_launches["fps"]),
         "max_abs_err": max(float((idx_k - idx_p).abs().max()), flagship_errors["fps"],
                            harness_errors["fps"], weights_errors["fps"]),
         "ms": fps_ms,
         "plain_ms": fps_plain_ms, "bound_ms": fps_bound, "bound_by": "operations",
         "library_ms": None},
        {"name": "grid_decode", "route": "cuda", "source": "gennerf_tpu_torch/csrc/grid_decode.cu",
         "replaces": "gennerf_tpu/ops/pallas/fused_decoder.py:353",
         "launches": (launches["grid_decode"] + mesh_launches["grid_decode"]
                      + data_launches["grid_decode"] + voxelnet_launches["grid_decode"]
                      + flagship_launches["grid_decode"] + distill_launches["grid_decode"]
                      + harness_launches["grid_decode"] + weights_launches["grid_decode"]),
         "max_abs_err": max(grid_max, flagship_errors["grid_decode"],
                            distill_errors["grid_decode"], harness_errors["grid_decode"],
                            weights_errors["grid_decode"]),
         "ms": grid_ms,
         "plain_ms": grid_plain_ms, "bound_ms": grid_bound,
         "bound_by": "operations" if grid_flops / PEAK_BF16 >= grid_bytes / PEAK_BYTES else "bytes",
         "library_ms": None},
        {"name": "point_decode", "route": "cuda", "source": "gennerf_tpu_torch/csrc/point_decode.cu",
         "replaces": "gennerf_tpu/ops/pallas/fused_decoder.py:53",
         "launches": (render_launches["point_decode"] + data_launches["point_decode"]
                      + voxelnet_launches["point_decode"] + flagship_launches["point_decode"]
                      + distill_launches["point_decode"] + harness_launches["point_decode"]
                      + weights_launches["point_decode"]),
         "max_abs_err": max(point_max, flagship_errors["point_decode"],
                            distill_errors["point_decode"]), "ms": point_ms,
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
