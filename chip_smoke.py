#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (gennerf_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py [--phases weights_options,parallel]

Builds the port's CUDA kernels from csrc/ with nvcc and its host library
from csrc/host/ with the host C++ compiler, then:
  1. device and build: the card's name and power limit (nvidia-smi), the
     build time, each kernel's registers and spill bytes (ptxas) and its
     HGMMA/HMMA counts (cuobjdump, where the toolkit has it); fails if a
     decode kernel spills at H=256 or is not on wgmma, or an FPS kernel
     instance spills; the host library's build seconds and whether it was
     cached;
  2. predict: `reconstruct` of the full-width seqs_multigeo_4cm GenNerf
     (seeded random weights, every ResnetFC matrix non-zero) on 8 rendered
     120x160 frames, with the launch counters reset just before and read
     just after (and the FPS plan that run launched); the volume is checked
     against the same stages run through the plain versions;
  3. render: `render_views` of 4 of the frames (the K3-backed march) with
     the counters reset just before and read just after, held against the
     same march on the plain bf16-feed decode (k3_march);
  4. mesh: on the render phase's weights, the 96x96x56 volume of
     `reconstruct` (K2, counters reset just before and read just after) and
     of the same stages through the plain versions, each meshed by
     `TSDF.get_mesh`: both non-empty, `eval_mesh(K2 mesh, plain mesh)` at
     F@5cm >= 0.99; the host ms of marching cubes, eval_mesh and the PLY
     write and load;
  5. predict_sparse: `reconstruct` with sparse_band_decode, and the band
     decode against the dense gather decode clamped by the prior;
  6. kernels: each kernel of KERNEL_ROWS (K1-K3, the fused lift and its
     backward gather, the volume sample, the backprojection) alone at the
     shape PERF.md's kernel table reports, on inputs its row makes: its ms
     (tools/measure.cuda_ms), its plain version's and its bound's (bytes
     at the HBM peak, or operations at the f32 or bf16 tensor peak), one
     line a row; K1's launched plan, the clusters the card runs at once
     for each size and one call's ms; both lift paths' forward + backward
     ms and peak memory; the volume sample's ms on a bf16 volume, the
     library's sampler's (F.grid_sample with the transpose to rows) and
     the channels-last copy's, and its ms gated at VS_MAX_MS; the
     backprojection's whole no_grad fold, its pixel choice and torch's
     channels_last copy of its features. Each row's kernel is first held
     against its plain version on the same inputs
     (the row's `check`: K1's indices equal, K2 and K3 within the grid and
     point tolerances, the lift within one bf16 step a rounding and two
     runs bit-equal, the gather within float32 sums of the float64
     transpose, the volume sample bit-equal in f32 and bf16, the
     backprojection's sum and count bit-equal); the card tests
     (tests/test_torch_kernels.py, test_torch_spatial_lift.py,
     test_torch_volume_sample_card.py, test_torch_backproject_card.py)
     hold the other shapes and cases;
  7. train: the training path of the same config (ray supervision, smooth_log
     TSDF loss, autograd, Adam with coupled L2) on `training_batch`'s scene
     of 8 frames, K1 in every step's encode: one step with K1 against the
     same step with the plain FPS on the card (same weights and draws,
     deterministic algorithms),
     then 3 warm-up and 20 timed chained `train_step`s with the counters
     reset just before and read just after (K1 launches must equal the
     steps; the loss must fall), the peak memory, and a
     save / reload into a fresh model and optimizer / step against the
     uninterrupted step;
  8. data: the multigeo dataset written by the port's writer (8 training
     and 2 held-out scenes of 10 frames of 120x160, ground truth at 4 and
     8 cm) into a temporary directory; ScannetDataModule of the same config
     with its 3D augmentation; 2 epochs (16 steps) of `Trainer.fit` over
     the loaders, validating every epoch with the config's monitored
     checkpoints (callbacks.model_checkpoint), with the counters reset just
     before and read just after (K1 launches must equal the steps plus
     the validation encodes, the losses and val_recon_tsdf_l1 finite,
     best_epoch() the epoch of the lowest val_combined), the loader wait
     and step times, TSDF.transform's time per item and the peak memory;
     then
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
  9. spatial: configs/experiment/seqs_multigeo_spatial.yaml at full width
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
     encode against the one-pass encode in eval mode; timed train steps;
     a held-out `reconstruct` at 96x96x56 (K1 once, K2 0, finite, inside
     the head's range), counters reset just before and read just after:
     csrc/volume_sample.cu launched exactly once a dense decode chunk (the
     2 chunks `predict_tsdf_volume`'s chunk size cuts the grid into) and
     csrc/backproject.cu once a frame chunk of the encode, its total and
     decode ms; then a dense decode of the spatial benchmark
     cell's grid (SPATIAL_CELL_GRID, 256x256x96) on a random scene of this
     config's widths (512 volume channels), counters reset just before and
     read just after: the kernel launched exactly once a chunk (24), every
     point through it (`trilinear.kernel_points` = `trilinear.points` = the
     grid's voxels);
 10. voxelnet: configs/experiment/seqs_multigeo_voxelnet.yaml at full width
     in the precision it asks for, bf16-mixed (ResNet-18 stem and 2 stages
     at feature_scale 2.0 on the loaders' 480x640 frames, 32 channels
     backprojected into an 80x80x40 volume, the 3D encoder-decoder with
     channels [32, 64, 128], the 8 and 4 cm heads), on the data phase's
     dataset: one epoch of `Trainer.fit` (8 steps) with its validation
     (val_tsdf_loss-monitored top-3, the tail's val_recon_tsdf_l1 finite),
     the kernel counters reset before the phase, the TPU-kernel ports' all 0
     after it (the JAX VoxelNet runs no Pallas kernel); the fused lift's
     (csrc/spatial_lift.cu, the bf16 spatial encoder's) launches exactly
     those its steps imply (one lift a frame chunk, again in a remat's
     recompute, one backward gather a resized map a chunk) in the remat and
     no-remat steps and the timed steps below; on one loader batch the float32
     model's forward and loss on the card (TF32 off) against the CPU, the
     precision discipline (parameters and running statistics float32
     after a bf16 step; the ResNet's output bf16, the volume, the 3D
     backbone's and the heads' outputs float32; the bf16 loss near the
     float32 loss), a remat step against the step without remat; timed
     bf16 steps; the held-out scenes through the predict CLI from the run
     directory and `evaluation.process` (metrics finite, meshes
     non-empty);
 11. flagship_bf16: configs/experiment/seq1_frames8_evenspaced_pointnet.yaml
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
     planes and loss on the card against the CPU (1e-4); timed
     bf16 steps (K1 once a step) and the same in float32; an epoch and a
     validation of the eikonal child in bf16 (the eikonal term finite and
     above 0), for 4 draws its float32 step on the card and on the CPU and
     its bf16 step on the card against the CPU's float64 step, each on the
     float64 step's ReLU and max-pool picks (the loss within 1e-5 of the
     CPU's float32 loss; the card's float32 gradients at most
     EIKONAL_NOISE_FACTOR times as far from float64 as the CPU's, the bf16
     step's beyond that; the card's float32 step on its own picks read
     beside them), its step ms against the flagship's; one
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
 12. distill: scans/scene_synth0 (24 frames) written by the port's
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
     1e-3 m); timed steps of each mode; on the trained
     surface model's head (d_geo 64, lin_out 128 wide) K2 through
     `reconstruct` of the scene's test frames against the plain bf16-feed
     decode (the field centred first if a tenth of it is not live), K3 at
     2^18 points against its plain version and a test view through K3
     against the plain march; the surface experiment with use_auxiliary
     (the teacher's 64 channels backprojected beside the planes, d_in 96):
     one step, the card against the CPU, and a `reconstruct` and a
     `render_views` launching K1 twice and K2 and K3 0 times;
 13. harness: configs/experiment/seqs_multigeo_4cm.yaml at full width on
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
 14. weights_options: weights in and out and the GenNerf options a
     reference checkpoint can name. A reference-named Lightning .ckpt of the
     full-width seqs_multigeo_4cm (c_dim 32, 64x64 planes, UNet depth 3, 256
     sparse points, ResnetFC H 256 x 5), fabricated with numpy, its
     hyper_parameters pickling a class of a module that does not exist (the
     field centred on the scene's test grid first), through the predict
     and render CLIs' --params on one held-out scene under deterministic
     algorithms, counters reset just before and read just after (K1 twice,
     each index-exact against the plain FPS; K2 once, within the grid
     tolerances of the plain bf16-feed decode, a voxel's error taken
     against that decode with one ambiguous bf16 rounding pinned to the
     kernel's pick, k2_pinned_error, that pinned error also within
     REFERENCE_K2_PINNED_TOL and the voxels it does not explain within
     the grid tolerance on their raw error, reference_k2_gates; K3 in the
     render), the 480x640 view through K3 against the plain march, the writer -> reader round trip bit for bit and the same
     weights loaded natively and through the reader giving the same
     volume bit for bit (deterministic algorithms); fabricated reference
     checkpoints of seqs_multigeo_spatial (ResNet under encoder.model.) and
     seqs_multigeo_voxelnet (backbone3d, heads3d; partial: spatial.proj),
     one float32 forward each on the card against the CPU (the feature
     volumes backprojected through the CPU's pixel picks, by the share of
     voxels within the tolerance, the card's own picks read beside;
     VoxelNet in training mode, its refine from the CPU's volume); the option
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
 15. model_options: the remaining model options, on the data phase's
     dataset (and the distill phase's scene). (a) seqs_multigeo_voxelnet
     at full width in its bf16-mixed with backbone3d.norm GN and drop 0.1
     (VOXELNET_OPTIONS): 3 loader-batch train steps (the masks drawn from
     the step's generator) and a held-out `reconstruct`, counted (K1-K3
     all 0), then the same with heads.tsdf.loss_split none; the bf16
     forward loss against the float32 one of the same weights, batch and
     masks (OPTIONS_BF16_LOSS_RTOL); on OTHER_FRAMES frames the CPU's
     volume refined in float32 on the card and on the CPU with the card's
     masks injected (the loss within OPTIONS_DEVICE_RTOL; the first step's
     3D backbone and head gradients against a float64 refine on the CPU,
     as the option groups'); (b) seqs_multigeo_spatial: one encode each
     with spatial.norm_type batch, sync_batch and instance on the same
     weights and draws (counted, K1 once each), sync_batch and instance
     bit for bit the batch volume and planes, only instance warning; one
     encode at num_layers 1 with upsample_interp nearest on the card
     against the CPU on the CPU's sparse points; (c) the flagship
     seq1_frames8_evenspaced_pointnet at full width in its bf16-mixed on
     FLAGSHIP_DATA_KEYS, with each group of BF16_OPTION_GROUPS ((i) SPADE +
     LayerNorm, (ii) the grid plane + UNet3D, (iii) voxel_hash + the UNet's
     'add' + the learned merger): 3 steps with injected draws (counted: K1
     once a step in (i) and (ii), each launch index-exact against the
     plain FPS; 0 under voxel_hash), their losses within
     OPTIONS_BF16_LOSS_RTOL of the same steps in float32, a `reconstruct`
     at FLAGSHIP_GRID (counted: decode_dense in (i) and (ii); K2 in (iii)
     on bf16 planes, on the field centred there, within the grid
     tolerances of the plain decode with a tenth of it live), in (iii)
     the learned merger's merge of two bf16 encodes, and a held-out 480x640
     view through K3 (counted) against the plain march, K3 against its
     plain version on 2^18 points in the box; (d) distill_synthetic and
     distill_render_synthetic in bf16-mixed: 3 steps each (counted, K1
     once a step), train_distill within OPTIONS_BF16_LOSS_RTOL of the same
     float32 steps, K2 through `reconstruct` and K3 through a test view on
     the bf16 surface model's d_geo-64 head against their plain versions,
     and one use_auxiliary step (K1 once, decode_dense route) within
     OPTIONS_BF16_LOSS_RTOL of its float32 loss;
 16. prepare: data preparation from raw ScanNet, then the flagship on it. A
     'rooms' scene (data/prepare/synthetic_scannet.py) of PREPARE_FRAMES
     frames rendered at ScanNet's sizes (colour 1296x968, depth 640x480 in
     mm, ScanNet-like intrinsics) written as scans/scene0244_01/
     scene0244_01.sens by the port's writer (its own JPEG encoder, quality
     95); tools.read_scannet --tar, tools.build_scannet, then
     prepare_scannet (info.json, the split files, colour fusion at 4, 8 and
     16 cm on the card, clean_info); gates: every exported depth PNG equal
     to the written array, every exported JPEG (the second generation)
     within PREPARE_PSNR_MIN of the render and PREPARE_GENERATION_DB of the
     first generation, each voxel size fused again on the card from the
     prepared frames equal to the volume prepare wrote (and timed), the 16
     cm fusion on the card equal to the CPU's bit for bit (weights, TSDF and
     colour sums), mesh_04.ply non-empty,
     coloured and read back, a labelled 16 cm fusion's semseg mesh in the
     NYU40 palette; then seq1_frames8_evenspaced_pointnet at full width in
     bf16-mixed through its own data keys on the prepared JPEG frames
     (sequence_length cut to the scene): PREPARE_EPOCHS steps of
     `Trainer.fit` and one validation, counters reset just before and read
     just after (K1 = steps + eval batches + tails, K2 = tails = 1, the
     tail's K2 within the grid tolerance of the plain decode); K1 on a
     loader batch's clouds index-exact against its plain version; on the
     scene's validation item a reconstruct at FLAGSHIP_GRID, the field centred
     there (K2 against the plain decode, a tenth of it live), K3 at 2^20
     points in the box against its plain version and a 480x640 view through
     K3 against the plain march; the .sens write, export per frame, JPEG
     decode, fusion per voxel size, loader wait and step times, and the
     phase's seconds on a line of their own;
 17. parallel: more than one GPU, on PARALLEL_BATCH loader items of the
     data phase's dataset at full width (seqs_multigeo_4cm, f32;
     seqs_multigeo_voxelnet, bf16-mixed, its BatchNorm global): (a) NCCL at
     world size 1 in this process, every collective run: 10 steps of
     `Trainer.fit` (prefetch 2) against the same steps through the plain
     path (losses and parameters within PARALLEL_WORLD1_RTOL), K1 launched
     once a step, K1 index-exact against the plain FPS on the rank's rows;
     the coalesced gradient all-reduce's ms and the sharded step's ms
     against the plain step's, for GenNerf and for VoxelNet; the sharded
     grid decode (K2 once) equal to the whole grid; (b) 2 ranks spawned on
     the one card over gloo (CUDA tensors): PARALLEL_STEPS steps of each
     config on its rows against world size 1 (losses within the CPU tests'
     bounds, PARALLEL_TOL / PARALLEL_BF16_TOL, the ranks' states
     bit-equal, K1 once a GenNerf step; GenNerf's gradients and statistics
     within those bounds; VoxelNet's refereed by the next wider step, no
     farther from it than the world-size-1 evaluations: the whole batch,
     each convolution one rank's rows at a time, the sharded step at world
     size 1; in float32 every such step on the float64 step's ReLU and
     max-pool picks, the picks its own sums make otherwise counted), two
     planted faults (gradients averaged, BatchNorm's backward not
     all-reduced) reading beyond that bound, and the sharded decode (K2
     once a rank, gathered equal to the whole grid);
     (c) the same over NCCL, one card a rank, where the machine has two
     (else printed as not run); (d) K2 on each x-slab of 96x96x56 and of
     190x180x50 at d_in 64 (SLAB_COUNTS), concatenated: equal to K2 on the
     whole grid and within K2's tolerances of the plain decode; (e) the
     data phase's loader-fed fit at prefetch_batches 0 and 2 in turns:
     median loader wait and step ms; the phase's seconds;
then a `gates` JSON line, a `kernels` JSON line, the nvidia-smi line and
the final result line. Every phase raises on failure. Needs one CUDA card;
exits non-zero without. `--phases` names which of phases 6-17 run (PHASES;
phases 1-5 always run, and the data phase's dataset is written for a
phase that reads it): a gate's margin measured on its phase alone.

The `gates` line lists every numeric gate the run evaluated, in order:
"phase.gate" name, value, limit, kind and margin (gate_margin: value /
limit for an upper bound, (1 - value) / (1 - limit) for an agreement
share, limit / value for a lower bound or a control that must read beyond
it; 1.0 is the edge), the ten nearest their limits and those at EDGE
(0.8) or beyond; a failed run prints it before its traceback. A gate that
reads EDGE or more carries its breakdown on its phase's line, and one
further from its edge is not broken down: `vs_plain_analysis` beside a K2
or K3 march comparison (k2_analysis, march_analysis; on the reference
checkpoint's K2 under `pinned`), `by_parameter` in the parallel phase's
`vs_wider`, `oracle_depth_breakdown` beside an oracle evaluation.
"""
import contextlib
import csv
import dataclasses
import gc
import io
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time
from collections.abc import Callable

SEED = 0
NUM_FRAMES, HEIGHT, WIDTH = 8, 120, 160
NPOINT, PRESAMPLE = 256, 16384
VOXEL_DIM = (96, 96, 56)
# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, dense bf16 tensor FLOP/s, f32 FLOP/s
PEAK_BYTES, PEAK_BF16, PEAK_F32 = 3.35e12, 989e12, 67e12
# kernel vs plain bf16-feed decode: both round the same values to bf16 but
# accumulate in another order, so a few activations round the other way
# (one bf16 step, 2^-8 of the value) and carry that through later blocks
# (on the fabricated reference weights one such rounding moves a voxel by up
# to 0.05: there k2_pinned_error holds each voxel to the plain decode with
# one ambiguous rounding taken the kernel's way)
GRID_MAX_ABS_TOL, GRID_MEAN_ABS_TOL = 5e-2, 1e-3
# K2 on the fabricated reference weights with that rounding pinned: 6.9e-3
# in every run on an H100 80GB HBM3 (700 W); a fault that a rounding can
# hide moves it beyond this, and the voxels no rounding explains keep
# GRID_MAX_ABS_TOL on their raw error (reference_k2_gates)
REFERENCE_K2_PINNED_TOL = 2e-2
# the point decode rounds the same values to bf16 as its plain version and
# sums in another order: the grid decode's tolerance, for the same reason
POINT_MAX_ABS_TOL, POINT_MEAN_ABS_TOL = 5e-2, 1e-3
N_POINTS = 1 << 20
NUM_VIEWS = 4
# kernel march vs plain-decode march: both round the field's activations to
# bf16 in other orders, so a sample's value differs by a bf16 step or a few
# (more on the fabricated reference weights); a sample within that of zero
# can move a bracket, and near the crossing the secant steps' values (which
# converge on zero) pick and interpolate otherwise: where the field meets
# the ray at a grazing angle or a silhouette that moves the crossing by more
# than a millimetre (march_analysis; a control march through the plain
# decode summed in float64, no kernel in it, parts from it on ~0.5% of the
# rays); 99% of the rays must agree on the hit, and 99% of the rays both hit
# within 1e-3 m
RENDER_MASK_AGREE, RENDER_DEPTH_TOL, RENDER_DEPTH_AGREE = 0.99, 1e-3, 0.99
# one bf16 step of a field value, relative to the field's bound (the
# head's tanh times head_smoothing): bf16 keeps 8 significant bits
BF16_REL_STEP = 2.0 ** -8
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
# the decode grid of the spatial benchmark cell (gennerf_living_spatial.recon)
SPATIAL_CELL_GRID, SPATIAL_CELL_VOXEL = (256, 256, 96), 0.04
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
# as well as the card's; each step takes the float64 step's ReLU and
# max-pool picks (ReluPicks: one pick made the other way moves a gradient
# by up to 1e-2 of max-abs, on either device), and the card's distance may
# be at most EIKONAL_NOISE_FACTOR times the CPU's float32 distance of the
# same draws,
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
# the model_options phase: VoxelNet with GroupNorm and dropout (its masks
# injected where the card is held against the CPU), and the GenNerf options
# at the flagship's widths in bf16-mixed, in three groups; a bf16-mixed
# loss against the float32 loss of the same weights, batch and draws
# within OPTIONS_BF16_LOSS_RTOL (several bf16 steps, as VoxelNet's)
VOXELNET_DROP = 0.1
VOXELNET_OPTIONS = ("model.backbone3d.norm=GN", f"model.backbone3d.drop={VOXELNET_DROP}")
BF16_OPTION_GROUPS = {
    "i": ("mlp.use_spade=true", "mlp.use_layer_norm=true"),
    "ii": ("encoder.pointnet.plane_type=[xz,xy,yz,grid]", "encoder.pointnet.unet3d=true"),
    "iii": ("encoder.pointnet.sparsifier=voxel_hash",
            "encoder.pointnet.unet_kwargs.merge_mode=add", "encoder.plane_merger.strategy=learn"),
}
OPTIONS_BF16_LOSS_RTOL = 2e-2
# the prepare phase: a 'rooms' scene (room shell, box, cylinder and sphere
# furniture, cameras inside) at ScanNet's sizes written as a raw .sens by the
# port, exported (read_scannet --tar, build_scannet) and prepared on the card
# (prepare_scannet: info.json, splits, colour fusion at PREPARE_VOXEL_SIZES),
# then the flagship trained from the prepared JPEG frames through its own data
# keys. Cut: PREPARE_FRAMES frames where ScanNet's scenes hold ~1,500, and the
# flagship's sequence_length (710) cut to match, so the scene is one window of
# one item: an epoch is one step
PREPARE_SCENE, PREPARE_FRAMES, PREPARE_EPOCHS = "scene0244_01", 48, 3
PREPARE_VOXEL_SIZES, PREPARE_MAX_DEPTH = (4, 8, 16), 3.0
# the exported colour against the rendered frame: two JPEG generations at
# quality 95 in 4:2:0 (the .sens, then the export), whose chroma halves blur
# the render's hard-edged, fully saturated primitives: each frame's PSNR at
# least PREPARE_PSNR_MIN dB, the second generation costing at most
# PREPARE_GENERATION_DB
PREPARE_PSNR_MIN, PREPARE_GENERATION_DB = 22.0, 1.5
# the 16 cm fusion on the card against the CPU's on the same frames must
# agree bit for bit (weights, TSDF and colour sums): the projection is
# device-independent (tsdf/fusion._frame_pixels), the division a true
# one on both, and every other step elementwise in the same order
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


def gate_margin(value: float, limit: float, kind: str = "max") -> float:
    """A gate's reading against its limit, 1.0 at the edge and above it
    when the gate fails: value / limit for an upper bound ("max"),
    (1 - value) / (1 - limit) for a share that must reach limit ("agree"),
    limit / value for any other lower bound ("min", or "beyond" where the
    value must exceed it: a control or a planted fault), and for a lower
    bound in decibels ("min_db", a PSNR) the ratio of the noise powers,
    10^((limit - value) / 10). A limit of 0 (or 1 for a share) is an exact
    gate: 0 when it holds, inf when not; NaN reads inf."""
    value, limit = float(value), float(limit)
    if math.isnan(value):
        return math.inf
    if kind == "min_db":
        return 10.0 ** ((limit - value) / 10.0)
    if kind == "max":
        num, den = value, limit
    elif kind == "agree":
        num, den = 1.0 - value, 1.0 - limit
    elif kind in ("min", "beyond"):
        num, den = limit, value
    else:
        raise ValueError(f"unknown gate kind {kind!r}")
    if den <= 0:
        return 0.0 if num <= 0 else math.inf
    return max(num, 0.0) / den


# a gate that reads EDGE of its limit or more carries its breakdown on its
# phase's line; one further from its edge is not broken down
EDGE = 0.8


def at_edge(*margins) -> bool:
    """Whether any of these gate margins (gate_margin) reads EDGE or more."""
    return max(margins, default=0.0) >= EDGE


class Gates:
    """The numeric gates a run evaluated, in order: `check` records one
    (the phase's name and the gate's, value, limit, kind and margin,
    `gate_margin`) and says whether it holds; `line` is the `gates` JSON
    line, printed before the kernels line (and when a phase fails). Each
    phase sets `phase` when it starts."""

    def __init__(self):
        self.records = []
        self.phase = "main"

    def check(self, name: str, value, limit, kind: str = "max") -> bool:
        value, limit = float(value), float(limit)
        margin = gate_margin(value, limit, kind)
        self.records.append({"name": f"{self.phase}.{name}", "value": value, "limit": limit,
                             "kind": kind, "margin": margin if math.isfinite(margin) else "inf"})
        return {"max": value <= limit, "beyond": value > limit}.get(kind, value >= limit)

    def line(self, watch: float = EDGE) -> dict:
        """Every gate, the ten nearest their limits and those at `watch`
        of their limit or beyond."""
        def m(r):
            return math.inf if r["margin"] == "inf" else r["margin"]

        worst = sorted(self.records, key=lambda r: -m(r))
        return {"phase": "gates", "count": len(self.records),
                "worst": [[r["name"], r["margin"]] for r in worst[:10]],
                f"at_least_{watch}": [r["name"] for r in worst if m(r) >= watch],
                "gates": self.records}


GATES = Gates()


def gate(name: str, value, limit, kind: str = "max") -> bool:
    """GATES.check: whether `value` keeps its limit (see gate_margin)."""
    return GATES.check(name, value, limit, kind)


def grid_gates(name: str, max_abs: float, mean_abs: float) -> bool:
    """K2 against its plain bf16-feed decode: both gates recorded."""
    return (gate(f"{name}.max_abs", max_abs, GRID_MAX_ABS_TOL)
            & gate(f"{name}.mean_abs", mean_abs, GRID_MEAN_ABS_TOL))


def reference_k2_gates(name: str, max_abs: float, mean_abs: float, pinned: dict) -> bool:
    """K2 on the fabricated reference weights against its plain decode
    (`max_abs` the raw error, `pinned` k2_pinned_error's record): the grid
    gates on the pinned max error and the mean error, the pinned max error
    within REFERENCE_K2_PINNED_TOL, and the raw error of the voxels no
    single rounding explains within GRID_MAX_ABS_TOL."""
    return (grid_gates(name, pinned["max_abs"], mean_abs)
            & gate(f"{name}.max_abs_pinned", pinned["max_abs"], REFERENCE_K2_PINNED_TOL)
            & gate(f"{name}.unexplained_max_abs", pinned["unexplained_max_abs"],
                   GRID_MAX_ABS_TOL))


def point_gates(name: str, rec: dict) -> bool:
    """K3 against its plain bf16-feed decode (rec's max_abs_err and
    mean_abs_err), and the field's live share where rec has one."""
    ok = (gate(f"{name}.max_abs", rec["max_abs_err"], POINT_MAX_ABS_TOL)
          & gate(f"{name}.mean_abs", rec["mean_abs_err"], POINT_MEAN_ABS_TOL))
    if "live_share" in rec:
        ok &= gate(f"{name}.live_share", rec["live_share"], FIELD_MIN_LIVE_SHARE, "min")
    return ok


def march_gates(name: str, rec: dict, min_hits: bool = True) -> bool:
    """The K3 march against the plain march (rec's vs_plain_mask_agree and
    vs_plain_depth_agree), and its hit share where `min_hits`."""
    ok = (gate(f"{name}.mask_agree", rec["vs_plain_mask_agree"], RENDER_MASK_AGREE, "agree")
          & gate(f"{name}.depth_agree", rec["vs_plain_depth_agree"], RENDER_DEPTH_AGREE,
                 "agree"))
    if min_hits:
        ok &= gate(f"{name}.hit_share", rec["hit_share"], RENDER_MIN_HIT_SHARE, "min")
    return ok


def _first_crossing_index(g):
    """Each row's first i with g[i] > 0 >= g[i + 1] (the march's pick on
    its field g = -tsdf), -1 where there is none."""
    import numpy as np

    sc = (g[:, :-1] > 0) & ~(g[:, 1:] > 0)
    return np.where(sc.any(1), sc.argmax(1), -1)


def _quantiles(x) -> dict:
    import numpy as np

    x = np.asarray(x, np.float64)
    if not x.size:
        return {}
    return {q: float(np.quantile(x, float(q))) for q in ("0.5", "0.9", "1.0")}


def march_breakdown(k: dict, p: dict, step: float) -> dict:
    """Why the K3 march (`k`) and the plain march (`p`) part on the same
    rays: march_trace outputs (tsdf values: coarse (n, S), fine (n, S_f),
    secant (n, n_secant)). A ray's first pick that differs decides its
    cause: a coarse sample's sign (the bracket or the hit), else a fine
    sample's (the coarse bracket equal, so the same points), else a
    secant step's, else none ("interpolation": the same picks, the
    crossing interpolated from other values). For the rays with a pick
    flipped: the plain value's distance from zero at the flipped samples
    (the nearest, in `step`s) and the kernel's error there."""
    import numpy as np

    causes = np.full(len(k["coarse"]), "interpolation", dtype=object)
    near = np.full(len(causes), np.nan)
    err = np.full(len(causes), np.nan)
    undecided = np.ones(len(causes), bool)
    for stage in ("coarse", "fine", "secant"):
        tk, tp = k[stage], p[stage]
        pick_k, pick_p = tk < 0, tp < 0  # the march's pick: field -tsdf > 0
        if stage == "secant":
            flipped = pick_k != pick_p
            # a secant step's values follow the previous step's pick:
            # only the first flip is the same point on both sides
            first = np.where(flipped.any(1), flipped.argmax(1), -1)
            flipped = np.zeros_like(flipped)
            rows = np.nonzero(first >= 0)[0]
            flipped[rows, first[rows]] = True
        else:
            fk, fp = _first_crossing_index(-tk), _first_crossing_index(-tp)
            last = np.where((fk >= 0) & (fp >= 0), np.maximum(fk, fp) + 1, tk.shape[1] - 1)
            upto = np.arange(tk.shape[1])[None, :] <= last[:, None]
            flipped = (pick_k != pick_p) & upto & (fk != fp)[:, None]
        hit = undecided & flipped.any(1)
        for i in np.nonzero(hit)[0]:
            j = np.nonzero(flipped[i])[0]
            a = np.abs(tp[i, j])
            near[i] = float(a.min()) / step
            err[i] = float(np.abs(tk[i, j] - tp[i, j])[a.argmin()]) / step
        causes[hit] = f"{stage}_pick"
        undecided &= ~hit
    flipped_rows = ~np.isnan(near)
    return {"rays": int(len(causes)),
            "by_cause": {c: int((causes == c).sum()) for c in
                         ("coarse_pick", "fine_pick", "secant_pick", "interpolation")},
            "flipped_abs_tsdf_steps": _quantiles(near[flipped_rows]),
            "flipped_within_one_step": float((near[flipped_rows] <= 1.0).mean())
            if flipped_rows.any() else None,
            "kernel_err_steps_at_flip": _quantiles(err[flipped_rows])}, causes


def location_shares(silhouette, crossing_index, samples: int, cosine, grazing: float = 0.25
                    ) -> dict:
    """Where rays lie: the share at a silhouette (their 3x3 neighbourhood
    of the plain march's hit mask not uniform), near the box clip (the
    crossing in the march's first or last coarse interval) and at a
    grazing angle (|cos| between the ray and the field's gradient at the
    crossing below `grazing`; NaN where the ray has no crossing)."""
    import numpy as np

    ci = np.asarray(crossing_index)
    cos = np.asarray(cosine, np.float64)
    crossing = ci >= 0
    return {"rays": int(len(ci)), "silhouette": float(np.mean(silhouette)),
            "box_clip": float(np.mean(crossing & ((ci == 0) | (ci == samples - 2)))),
            "grazing": float(np.mean(np.abs(cos[~np.isnan(cos)]) < grazing))
            if (~np.isnan(cos)).any() else None}


def pinned_tsdf(torch, tsdf_k, tsdf_p, step: float):
    """tsdf_k's field taking tsdf_p's pick (the march's: tsdf < 0) at each
    sample where the two pick otherwise and the plain value lies within
    `step` of zero, the kernel's magnitude kept: the K3 march on the plain
    march's discrete choices where a rounding can make them."""
    def fn(pts):
        k, p = tsdf_k(pts), tsdf_p(pts)
        flip = (p.abs() <= step) & ((k < 0) != (p < 0))
        mag = torch.where(k != 0, k.abs(), p.abs())
        return torch.where(flip, torch.where(p < 0, -mag, mag), k)
    return fn


def depth_error_breakdown(depth_pred, depth_trgt, far: float = 0.05) -> dict:
    """eval_depth's AbsRel (pixels with a depth in both maps) split by where
    the rendered surface lies against the measured one: more than `far`
    metres behind it (a surface behind, seen through a hole of the mesh),
    more than `far` in front, or within; each class's share of the pixels
    and of the AbsRel sum. The maps may be lists of frames."""
    import numpy as np

    def flat(maps):
        return np.concatenate([np.asarray(a, np.float64).reshape(-1)
                               for a in (maps if isinstance(maps, list) else [maps])])

    p, t = flat(depth_pred), flat(depth_trgt)
    both = (p > 0) & (t > 0)
    d = p[both] - t[both]
    rel = np.abs(d) / t[both]
    total = max(float(rel.sum()), 1e-300)
    return {"pixels": int(both.sum()), "abs_rel": float(rel.mean()) if rel.size else 0.0,
            **{k: {"share": float(m.mean()) if m.size else 0.0,
                   "abs_rel_share": float(rel[m].sum()) / total}
               for k, m in (("behind", d > far), ("in_front", d < -far),
                            ("within", np.abs(d) <= far))}}


def bf16_tie_ulps(torch, a):
    """Each value's distance from the nearest bf16 rounding tie, in float32
    ulps (0 on a tie, at most 2^15): where the two bf16 neighbours of its
    float32 value are equally near, a change of one float32 ulp in the sum
    that made it rounds it the other way. Zeros (a ReLU's) read 2^15."""
    low = (a.to(torch.float32).contiguous().view(torch.int32) & 0xFFFF).to(torch.int32)
    return torch.where(a == 0, torch.full_like(low, 1 << 15), (low - 0x8000).abs())


def error_breakdown(err, out, tile: int = 128, top: int = 64) -> dict:
    """Where a decoded grid's errors against its plain decode lie: their
    distribution over the voxels (and against the output's magnitude),
    and the `top` largest by x-slab, by the kernel's tile of `tile`
    consecutive flat points (its row in the tile: 0 and tile - 1 are the
    tile's edges, tile / 2 - 1 and tile / 2 its two consumer warpgroups'
    split) and by tile."""
    import numpy as np

    e = np.asarray(err, np.float64).reshape(-1)
    o = np.abs(np.asarray(out, np.float64).reshape(-1))
    worst = np.argsort(e)[::-1][:top]
    per_x = e.size // np.asarray(err).shape[0]
    xs, rows, tiles = worst // per_x, worst % tile, worst // tile

    def spread(ids):
        counts = np.unique(ids, return_counts=True)[1]
        return {"distinct": int(len(counts)), "most_in_one": int(counts.max())}

    return {"voxels": int(e.size), "mean": float(e.mean()),
            "quantiles": {q: float(np.quantile(e, float(q)))
                          for q in ("0.5", "0.9", "0.99", "0.999", "1.0")},
            "share_over_1e-2": float((e > 1e-2).mean()),
            "max_over_out_abs_max": float(e.max() / max(o.max(), 1e-30)),
            "top": top, "top_over_own_abs": _quantiles(e[worst] / np.maximum(o[worst], 1e-6)),
            "top_x_slabs": spread(xs), "top_tiles": spread(tiles),
            "top_tile_rows": {"at_tile_edge": int(np.isin(rows, (0, tile - 1)).sum()),
                              "at_consumer_split": int(np.isin(rows, (tile // 2 - 1,
                                                                      tile // 2)).sum())}}


def dense_chunks(voxel_dim) -> int:
    """The chunks `predict_tsdf_volume` cuts a dense decode of this grid
    into (its default chunk size)."""
    import inspect

    from gennerf_tpu_torch.train.predict import predict_tsdf_volume

    chunk = inspect.signature(predict_tsdf_volume).parameters["chunk_size"].default
    return -(-math.prod(int(d) for d in voxel_dim) // chunk)


def synced_calls(torch, fn, n: int) -> tuple:
    """n calls of fn(), the card synchronized before and after each: each
    call's wall ms and what each returned."""
    ms, outs = [], []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs.append(fn())
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    return ms, outs


def host_ms(torch, fn, reps: int, warmup: int = 1) -> float:
    """Median wall time of fn() ending in a device synchronize, in ms."""
    for _ in range(warmup):
        fn()
    return statistics.median(synced_calls(torch, fn, reps)[0])


def forward_backward(torch, m, loss_fn) -> tuple:
    """One training-mode forward and backward of m (loss_fn(m): the loss):
    the loss, the gradients, the running statistics, peak bytes and ms."""
    m.train()
    m.zero_grad(set_to_none=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    loss = loss_fn(m)
    loss.backward()
    torch.cuda.synchronize()
    return (float(loss.detach()), {n: p.grad.clone() for n, p in m.named_parameters()},
            {k: v.clone() for k, v in m.state_dict().items() if "running_" in k},
            torch.cuda.max_memory_allocated(), (time.perf_counter() - t) * 1e3)


def remat_record(torch, remat: tuple, no_remat: tuple, fitted: dict) -> dict:
    """forward_backward of a model with remat against one without, both
    from the weights `fitted`: the record, gated (the loss, the worst
    gradient and the running statistics within the REMAT tolerances, every
    statistic moved); raises where they disagree."""
    loss_r, grads_r, stats_r, peak_r, ms_r = remat
    loss_p, grads_p, stats_p, peak_p, ms_p = no_remat
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
    if not (gate("remat.loss_rel", remat_rec["loss_rel_err"], REMAT_LOSS_RTOL)
            and gate("remat.grad_over_max_abs", grad_err[worst], REMAT_GRAD_TOL)
            and gate("remat.stats_rel", stats_err, REMAT_STATS_TOL)
            and moved == len(stats_r)):
        raise RuntimeError(f"the remat step disagrees with the step without remat: {remat_rec}")
    return remat_rec


def make_trainer(torch, dev, model, cfg: dict, run_dir: str, epochs: int, val_every: int = 1,
                 precision=None):
    """The Trainer of the train config `cfg` for `model`: its optimizer
    (with the config's gradient clip) and checkpoint callback, `epochs`
    epochs validating every `val_every`, no sanity validation."""
    from gennerf_tpu_torch.train.checkpoints import CheckpointManager
    from gennerf_tpu_torch.train.loop import Trainer
    from gennerf_tpu_torch.train.state import make_optimizer

    opt = make_optimizer(model.parameters(), model.cfg.optimizer,
                         cfg["trainer"].get("gradient_clip_val"))
    ckpt = cfg["callbacks"]["model_checkpoint"]
    checkpoints = CheckpointManager(ckpt["dirpath"], ckpt["save_top_k"], monitor=ckpt["monitor"],
                                    mode=ckpt.get("mode", "min"))
    return Trainer(model, opt, torch.Generator(device=dev).manual_seed(SEED), run_dir,
                   max_epochs=epochs, check_val_every_n_epoch=val_every, checkpoints=checkpoints,
                   precision=precision, num_sanity_val_steps=0)


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


@contextlib.contextmanager
def cpu_projections(torch, flips: list):
    """Within: `ops.projection.project_voxels` on any device returns the
    pixels the CPU picks for each voxel (its rounding of the voxel's
    projection, the backprojection's discrete choice), so that a
    card-against-CPU encode compares arithmetic, not a voxel within an ulp
    of a pixel edge rounded the other way; `flips` gets each card call's
    count of voxels whose own pixel differs."""
    from unittest import mock

    from gennerf_tpu_torch.ops import projection as projection_module

    real = projection_module.project_voxels

    def project(voxel_dim, voxel_size, origin, projection, height, width):
        own = real(voxel_dim, voxel_size, origin, projection, height, width)
        if projection.device.type == "cpu":
            return own
        picks = real(voxel_dim, voxel_size, torch.as_tensor(origin).cpu(), projection.cpu(),
                     height, width)
        flips.append(int(((own[0].cpu() != picks[0]) | (own[1].cpu() != picks[1])).sum()))
        return tuple(t.to(projection.device) for t in picks)

    with mock.patch.object(projection_module, "project_voxels", project):
        yield


def march_trace(torch, model, tsdf_fn, K, pose, H: int, W: int, rays) -> dict:
    """The field values one view's march reads on the ascending flat ray
    indices `rays` (h * W + w): render_encoded's renderer (its box, near and far,
    chunks) marched again with `tsdf_fn` recorded, as numpy coarse (n, S),
    fine (n, S_f) and secant (n, n_secant); and the (n,) crossing depth."""
    import numpy as np

    from gennerf_tpu_torch.models.renderer import SurfaceRenderer

    cfg = model.cfg
    box = np.array(cfg.voxel_dim_test, np.float32) * cfg.voxel_size
    calls = []

    def traced(pts):
        out = tsdf_fn(pts)
        calls.append(out.detach().reshape(-1))
        return out

    r = SurfaceRenderer(None, near=0.05, far=5.0, tsdf_fn=traced,
                        aabb=(np.zeros(3, np.float32), box))
    depth = r.render_depth_image(K, pose, H, W).reshape(-1)
    rays = torch.as_tensor(np.asarray(rays), dtype=torch.long, device=depth.device)
    per_chunk = 1 + (r.n_fine_steps > 0) + r.n_secant_steps
    chunk = max(1, min(r.n_max_network_queries // r.n_steps, H * W))
    widths = [r.n_steps] + [r.n_fine_steps] * (r.n_fine_steps > 0) + [1] * r.n_secant_steps
    parts = [[] for _ in widths]
    for c in range(len(calls) // per_chunk):
        lo, hi = c * chunk, min((c + 1) * chunk, H * W)
        mine = rays[(rays >= lo) & (rays < hi)] - lo
        for j, w in enumerate(widths):
            parts[j].append(calls[c * per_chunk + j].reshape(hi - lo, w)[mine])
    cols = [torch.cat(p).cpu().numpy() for p in parts]
    fine = (cols[1] if r.n_fine_steps > 0 else np.zeros((len(rays), 0), np.float32))
    return {"coarse": cols[0], "fine": fine,
            "secant": np.concatenate(cols[1 + (r.n_fine_steps > 0):], axis=1),
            "depth": depth[rays].cpu().numpy()}


def march_analysis(torch, model, repr_, depth, intrinsics, poses, rk: dict, rp: dict,
                   max_rays: int = 4096):
    """The K3 march `rk` against the plain march `rp` (render_encoded's
    outputs on the frames `depth`, `intrinsics`, `poses`), explained, where
    their mask or depth agreement reads EDGE of its limit or more (else
    None, with no work): the
    rays that differ (the hit, or both hitting more than RENDER_DEPTH_TOL
    apart), traced through both
    marches (march_trace; at most `max_rays`, rays in view order) and
    classified by march_breakdown, with one bf16 step at the field's bound
    as the unit; where they lie (location_shares) against as many rays
    the marches agree on; the agreement of the K3 march pinned to the
    plain march's picks within a step (pinned_tsdf), and of a control march
    through the plain decode summed in float64 (point_decode_reordered).
    The launches it makes are a comparison: the kernel counters are left
    as they were."""
    from unittest import mock

    import numpy as np

    from gennerf_tpu_torch.models.renderer import pixels_to_rays
    from gennerf_tpu_torch.ops import kernels
    from gennerf_tpu_torch.render import render_encoded
    from gennerf_tpu_torch.train import predict as predict_module
    from gennerf_tpu_torch.train.predict import make_point_tsdf_fn

    dk, dp = rk["ray_depth"], rp["ray_depth"]
    hk, hp = dk > 0, dp > 0
    both = hk & hp
    differ = (hk != hp) | (both & (np.abs(dk - dp) > RENDER_DEPTH_TOL))
    if not at_edge(gate_margin((hk == hp).mean(), RENDER_MASK_AGREE, "agree"),
                   gate_margin(1.0 - (differ & both).sum() / max(both.sum(), 1),
                               RENDER_DEPTH_AGREE, "agree")):
        return None
    saved = {k: k.launches for k in kernels.KERNELS}
    step = model.cfg.mlp.head_smoothing * BF16_REL_STEP
    tsdf_k, tsdf_p = make_point_tsdf_fn(model, repr_), make_point_tsdf_fn(model, repr_, plain=True)
    V, H, W = dk.shape
    views = rk["views"]
    rng = np.random.default_rng(SEED)
    traces = {"differ": ([], [], []), "agree": ([], [], [])}
    budget = {"differ": max_rays, "agree": max_rays}
    for v, vi in enumerate(views):
        K, pose = intrinsics[vi][None], poses[vi][None]
        pad = np.pad(hp[v], 1, mode="edge")
        window = np.stack([pad[i:i + H, j:j + W] for i in range(3) for j in range(3)])
        silhouette = (window != window[:1]).any(0).reshape(-1)
        for label, mask in (("differ", differ[v]), ("agree", hk[v] & hp[v] & ~differ[v])):
            rays = np.flatnonzero(mask)
            if label == "agree":
                rays = np.sort(rng.choice(rays, min(len(rays), budget["agree"]), replace=False))
            rays = rays[:budget[label]]
            budget[label] -= len(rays)
            if not len(rays):
                continue
            tk = march_trace(torch, model, tsdf_k, K, pose, H, W, rays)
            tp = march_trace(torch, model, tsdf_p, K, pose, H, W, rays)
            # the plain field's gradient at the crossing (the plain march's,
            # else the kernel's), by central differences of half a voxel
            hw = torch.as_tensor(np.stack([rays // W, rays % W]), dtype=torch.float32,
                                 device=K.device)
            o, d = pixels_to_rays(hw[0][None], hw[1][None], K, pose)
            t = torch.as_tensor(np.where(tp["depth"] > 0, tp["depth"], tk["depth"]),
                                device=K.device)
            x = o[0] + d[0] * t[:, None]
            h = 0.5 * model.cfg.voxel_size
            e = torch.eye(3, device=K.device) * h
            f = tsdf_p(torch.cat([x[:, None] + e[None], x[:, None] - e[None]], 1)
                       .reshape(1, -1, 3)).reshape(-1, 2, 3)
            grad = (f[:, 0] - f[:, 1]) / (2 * h)
            cos = ((grad * d[0]).sum(1) / grad.norm(dim=1).clamp_min(1e-12)).cpu().numpy()
            cos[t.cpu().numpy() <= 0] = np.nan
            crossing = np.where(tp["depth"] > 0, _first_crossing_index(-tp["coarse"]),
                                _first_crossing_index(-tk["coarse"]))
            traces[label][0].append((tk, tp))
            traces[label][1].append(silhouette[rays])
            traces[label][2].append((crossing, cos))
    rec = {"differing_rays": int(differ.sum()), "rays": int(differ.size),
           "step": step, "step_rule": "head_smoothing * 2^-8"}
    for label, (pairs, sil, where) in traces.items():
        if not pairs:
            continue
        cat = {side: {key: np.concatenate([pr[side][key] for pr in pairs])
                      for key in ("coarse", "fine", "secant")} for side in (0, 1)}
        crossing = np.concatenate([w[0] for w in where])
        cos = np.concatenate([w[1] for w in where])
        sil = np.concatenate(sil)
        S = cat[0]["coarse"].shape[1]
        if label == "differ":
            summary, causes = march_breakdown(cat[0], cat[1], step)
            summary["where"] = location_shares(sil, crossing, S, cos)
            summary["where_by_cause"] = {c: location_shares(sil[causes == c],
                                                            crossing[causes == c], S,
                                                            cos[causes == c])
                                         for c in set(causes)}
            rec["differing"] = summary
        else:
            rec["agreeing_sample"] = location_shares(sil, crossing, S, cos)
    # the K3 march pinned to the plain picks within a step, and a control
    # march through the plain decode summed in float64 (no kernel in it)
    with mock.patch.object(predict_module, "fused_resnetfc_tsdf_plain",
                           lambda f, c, w: point_decode_reordered(torch, f, c, w)):
        tsdf_c = predict_module.make_point_tsdf_fn(model, repr_, plain=True)
    for label, fn in (("pinned", pinned_tsdf(torch, tsdf_k, tsdf_p, step)),
                      ("control_float64_sums", tsdf_c)):
        r = render_encoded(model, repr_, depth, intrinsics, poses, fn, len(views))["ray_depth"]
        hq = r > 0
        dd = np.abs(r - dp)[hq & hp]
        rec[label] = {"hit_share": float(hq.mean()),
                      "vs_plain_mask_agree": float((hq == hp).mean()),
                      "vs_plain_depth_agree": float((dd <= RENDER_DEPTH_TOL).mean())
                      if dd.size else 1.0}
    for k, n in saved.items():
        k.launches = n
    return rec


def counting(owner, attr: str, names: list):
    """mock.patch.object of owner.attr by a wrapper appending the wrapped
    function's name to `names` at each call."""
    from unittest import mock

    fn = getattr(owner, attr)

    def wrapper(*a, **k):
        names.append(fn.__name__)
        return fn(*a, **k)
    return mock.patch.object(owner, attr, wrapper)


def recorded(fn, calls: list):
    """fn, with each call's arguments and output appended to `calls`."""
    def wrapper(*args):
        out = fn(*args)
        calls.append((*args, out))
        return out
    return wrapper


def recorded_k2_errors(decoded: list) -> tuple:
    """(the largest max and mean abs error, the least live share) of the K2
    calls recorded in `decoded` (recorded(grid_decode_cuda, decoded))
    against the plain bf16-feed decode of their tables; empties `decoded`."""
    from gennerf_tpu_torch.ops import grid_decode as grid_decode_module

    errs = []
    for tables, weights, out in decoded:
        err = (out - grid_decode_module.separable_grid_decode_plain(
            tables, weights, bf16_feeds=True)).abs()
        errs.append((float(err.max()), float(err.mean()),
                     float((out.abs() < FIELD_LIVE * weights["smoothing"]).double().mean())))
    decoded.clear()
    return tuple(f(e[i] for e in errs) for i, f in enumerate((max, max, min)))


def read_launches(totals: dict) -> dict:
    """The TPU-kernel ports' launch counters, added into a phase's `totals`."""
    from gennerf_tpu_torch.ops import kernels

    counts = {k.name: k.launches for k in kernels.KERNELS}
    for name, n in counts.items():
        totals[name] += n
    return counts


def counted_run(torch, totals: dict, run, *patches) -> tuple:
    """run() (a fit) under `patches`, the launch counters reset just before
    and read into `totals` just after, the validation's encodes counted:
    its seconds, the launches, the encodes' names (eval_step,
    reconstruct) and what run returned."""
    from gennerf_tpu_torch.ops import kernels
    from gennerf_tpu_torch.train import loop as loop_module

    encodes = []
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    with contextlib.ExitStack() as stack:
        for patch in (counting(loop_module, "eval_step", encodes),
                      counting(loop_module, "reconstruct", encodes), *patches):
            stack.enter_context(patch)
        t0 = time.perf_counter()
        out = run()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    return seconds, read_launches(totals), encodes, out


def k3_march(torch, model, repr_, depth, intrinsics, poses, views: int = 1) -> dict:
    """`views` views of the frames marched through K3 (make_point_tsdf_fn,
    the main path) against the same march through the plain bf16-feed
    decode, on one encode `repr_`: the views and image, each march's hit
    share, the share of rays agreeing on the hit and of those both hit
    within RENDER_DEPTH_TOL (1.0 where none; march_gates reads both), the
    depth differences' quantiles, the K3 march's ms and march_analysis. The
    plain march launches no kernel, so counters read after this call count
    the K3 march's launches."""
    import numpy as np

    from gennerf_tpu_torch.render import render_encoded
    from gennerf_tpu_torch.train.predict import make_point_tsdf_fn

    args = (model, repr_, depth, intrinsics, poses)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rk = render_encoded(*args, make_point_tsdf_fn(model, repr_), views)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    rp = render_encoded(*args, make_point_tsdf_fn(model, repr_, plain=True), views)
    hk, hp = rk["ray_depth"] > 0, rp["ray_depth"] > 0
    ddiff = np.abs(rk["ray_depth"] - rp["ray_depth"])[hk & hp]
    return {"views": [int(v) for v in rk["views"]], "image": list(rk["ray_depth"].shape[-2:]),
            "hit_share": float(hk.mean()), "hit_share_plain": float(hp.mean()),
            "vs_plain_mask_agree": float((hk == hp).mean()),
            "vs_plain_depth_agree": float((ddiff <= RENDER_DEPTH_TOL).mean()) if ddiff.size
            else 1.0, "both_hit_rays": int(ddiff.size),
            "vs_plain_depth_diff_m": _quantiles(ddiff), "ms": ms,
            "vs_plain_analysis": march_analysis(torch, *args, rk, rp)}


def k3_points(torch, model, repr_, pts) -> dict:
    """K3 against its plain bf16-feed version on the triplane features and
    codes of the points `pts` (N, 3) of the scene `repr_`: the errors
    point_gates reads and the share of the field live there."""
    from gennerf_tpu_torch.models.positional_encoding import positional_encoding
    from gennerf_tpu_torch.ops.point_decode import (
        fused_resnetfc_tsdf_cuda, fused_resnetfc_tsdf_plain,
    )
    from gennerf_tpu_torch.train.predict import triplane_feat_fast, triplane_gather_setup

    cfg = model.cfg
    feat = triplane_feat_fast(*triplane_gather_setup(model, repr_.planes), pts[None])[0]
    code = positional_encoding(pts, cfg.code.num_freqs, cfg.code.freq_factor,
                               cfg.code.include_input)
    weights = decoder_weights(model, point=True)
    plain = fused_resnetfc_tsdf_plain(feat, code, weights, bf16_feeds=True)
    err = (fused_resnetfc_tsdf_cuda(feat, code, weights) - plain).abs()
    return {"points": int(pts.shape[0]), "d_in": int(feat.shape[1]),
            "d_code": int(code.shape[1]), "max_abs_err": float(err.max()),
            "mean_abs_err": float(err.mean()), "out_abs_max": float(plain.abs().max()),
            "live_share": float((plain.abs() < FIELD_LIVE * cfg.mlp.head_smoothing)
                                .double().mean())}


def decoder_weights(model, point: bool) -> dict:
    """The model's ResnetFC and geometry head packed for K3 (`point`) or K2,
    as train/predict packs them."""
    from gennerf_tpu_torch.ops.grid_decode import extract_resnetfc_weights
    from gennerf_tpu_torch.ops.weight_slabs import pack_decode_weights

    mlp = model.cfg.mlp
    return pack_decode_weights(extract_resnetfc_weights(
        model.mlp, model.head_geo, mlp.d_out_geo, mlp.head_smoothing), point=point)


def _grid_tail(torch, weights, x, zx, sites=None, flips=None):
    """The residual blocks and head of the grid decode from the stream `x`
    (n, H) float32 and each block's injection zx[b], every product's bf16
    inputs summed in float64 and rounded to float32. `sites` (a list) gets
    each rounding site's activations (block b's first and second product,
    then the head's: site 2b, 2b + 1, 2 nb); `flips` = (site, channel) per
    row (site -1: none) rounds that one activation to its other bf16
    neighbour instead of the nearest."""
    f64 = torch.float64
    nb = weights["w0"].shape[0]

    def bf(t):
        return t.to(torch.bfloat16).to(f64)

    def rounded(a, site):
        if sites is not None:
            sites.append(a)
        q = a.to(torch.bfloat16)
        if flips is not None:
            rows = torch.nonzero(flips[0] == site).reshape(-1)
            if len(rows):
                ch = flips[1][rows]
                bits = q[rows, ch].view(torch.int16)
                up = q[rows, ch].to(torch.float32) < a[rows, ch]
                q[rows, ch] = torch.where(up, bits + 1, bits - 1).view(torch.bfloat16)
        return q.to(f64)

    w0, w1, w_last = bf(weights["w0"]), bf(weights["w1"]), bf(weights["w_last"])[:, None]
    for b in range(nb):
        x = x + zx[b]
        net = (rounded(torch.relu(x), 2 * b) @ w0[b]).to(torch.float32) + weights["b0"][b]
        x = x + ((rounded(torch.relu(net), 2 * b + 1) @ w1[b]).to(torch.float32)
                 + weights["b1"][b])
    head = (rounded(torch.relu(x), 2 * nb) @ w_last).to(torch.float32)[:, 0]
    return torch.tanh(head + weights["b_last"]) * weights["smoothing"]


def _grid_inputs(torch, tables, points):
    """The stream and the blocks' injections of flat voxel indices `points`."""
    q_yz, q_xz, q_xy, z_x, z_y, z_z = tables
    nz, ny, nb = q_xz.shape[1], q_xy.shape[1], z_y.shape[0]
    p = torch.as_tensor(points, device=q_yz.device).long()
    i, jk = p // (ny * nz), p % (ny * nz)
    j, k = jk // nz, jk % nz
    return ((q_yz[jk] + q_xz[i, k]) + q_xy[i, j],
            [(z_y[b, j] + z_z[b, k]) + z_x[i, b] for b in range(nb)])


def grid_decode_reordered(torch, tables, weights, points=None):
    """The plain bf16-feed grid decode with every product summed in
    float64 (and rounded to float32): the same roundings to bf16 as the
    kernel and the plain decode, in a third summation order. With `points`
    (flat voxel indices) also, for each, its rounding sites' nearest tie
    (bf16_tie_ulps): the fewest float32 ulps, and where (block b's first
    or second product, or the head). Returns (nx, ny, nz) float32 and
    that list."""
    q_yz, q_xz, q_xy, z_x, z_y, z_z = tables
    nx, nz, H = q_xz.shape
    ny, nb = q_xy.shape[1], z_y.shape[0]
    tz = (z_y[:, :, None, :] + z_z[:, None, :, :]).reshape(nb, ny * nz, H)
    q3 = q_yz.reshape(ny, nz, H)
    out = torch.empty(nx, ny * nz, dtype=torch.float32, device=q_yz.device)
    for i in range(nx):
        x = ((q3 + q_xz[i][None, :, :]) + q_xy[i][:, None, :]).reshape(ny * nz, H)
        out[i] = _grid_tail(torch, weights, x, [tz[b] + z_x[i, b][None, :] for b in range(nb)])
    ties = []
    if points is not None:
        sites = []
        _grid_tail(torch, weights, *_grid_inputs(torch, tables, points), sites=sites)
        names = [f"block{b}.{w}" for b in range(nb) for w in ("first", "second")] + ["head"]
        best = torch.stack([bf16_tie_ulps(torch, a).min(1).values for a in sites], 1).min(1)
        ties = [[int(u), names[int(w)]] for u, w in zip(best.values.tolist(),
                                                        best.indices.tolist())]
    return out.reshape(nx, ny, nz), ties


def k2_pinned_error(torch, tables, weights, out, plain, tol: float = GRID_MEAN_ABS_TOL,
                    candidates: int = 8, most: int = 4096) -> dict:
    """K2's largest error against its plain decode with one ambiguous
    rounding pinned to the kernel's pick: each voxel whose error exceeds
    `tol` (the `most` largest) is held instead to the nearest of the plain
    decode, the float64-sum decode (_grid_tail) and that decode with any one
    of the voxel's `candidates` activations nearest a bf16 rounding tie
    rounded the other way, since both sides' roundings of an activation
    within a few float32 ulps of a tie are a summation order's pick. A
    kernel fault moves voxels no single rounding explains: `unexplained_max_abs`
    is the largest raw error of the voxels not explained (their pinned
    error not under a tenth of the raw one, or not examined)."""
    err = (out - plain).abs().reshape(-1)
    worst = torch.argsort(err, descending=True)
    over = worst[:int(min((err > tol).sum(), most))]
    rec = {"max_abs_plain": float(err.max()), "examined": int(len(over))}
    if not len(over):
        return dict(rec, max_abs=rec["max_abs_plain"], explained=0,
                    unexplained_max_abs=rec["max_abs_plain"])
    n = len(over)
    x, zx = _grid_inputs(torch, tables, over)
    sites = []
    base = _grid_tail(torch, weights, x, zx, sites=sites)
    ties = torch.stack([bf16_tie_ulps(torch, a) for a in sites], 1)  # (n, S, H)
    H = ties.shape[-1]
    cand = torch.topk(ties.reshape(n, -1), candidates, largest=False).indices
    flips = ((cand // H).reshape(-1), (cand % H).reshape(-1))
    rows = torch.arange(n, device=x.device).repeat_interleave(candidates)
    flipped = _grid_tail(torch, weights, x[rows], [z[rows] for z in zx],
                         flips=flips).reshape(n, candidates)
    o = out.reshape(-1)[over]
    options = torch.cat([plain.reshape(-1)[over][:, None], base[:, None], flipped], 1)
    pinned = (options - o[:, None]).abs().min(1).values
    rest = err[worst[len(over):]]
    explained = pinned < 0.1 * err[over]
    return dict(rec, max_abs=float(torch.cat([pinned, rest[:1]]).max()),
                explained=int(explained.sum()),
                unexplained_max_abs=float(torch.cat([err[over][~explained], rest[:1],
                                                      err.new_zeros(1)]).max()),
                pinned_quantiles=_quantiles(pinned.cpu().numpy()))


def point_decode_reordered(torch, feat, code, weights, chunk: int = 1 << 18):
    """fused_resnetfc_tsdf_plain (bf16 feeds) with every product summed in
    float64 and rounded to float32: K3's roundings to bf16 in a third
    summation order, a control with no kernel in it. -> (N,) float32."""
    f64 = torch.float64

    def bf(t):
        return t.to(torch.bfloat16).to(f64)

    def product(a, w):
        return (bf(a) @ w).to(torch.float32)

    w_in, wz, w0, w1 = (bf(weights[k]) for k in ("w_in", "wz", "w0", "w1"))
    w_last = bf(weights["w_last"])[:, None]
    out = torch.empty(feat.shape[0], dtype=torch.float32, device=feat.device)
    for s in range(0, feat.shape[0], chunk):
        c = code[s:s + chunk]
        x = product(feat[s:s + chunk], w_in) + weights["b_in"]
        for b in range(w0.shape[0]):
            x = x + weights["alpha"] * (product(c, wz[b]) + weights["bz"][b])
            net = product(torch.relu(x), w0[b]) + weights["b0"][b]
            x = x + (product(torch.relu(net), w1[b]) + weights["b1"][b])
        head = product(torch.relu(x), w_last)[:, 0]
        out[s:s + chunk] = torch.tanh(head + weights["b_last"]) * weights["smoothing"]
    return out


def k2_analysis(torch, tables, weights, out, plain, top: int = 64) -> dict:
    """K2's output `out` against its plain bf16-feed decode `plain`,
    explained: error_breakdown of |out - plain|; the same for a third
    decode that rounds the same values to bf16 and sums in float64
    (grid_decode_reordered) against the plain decode, a control with no
    kernel in it; the bf16 feeds' own size (the plain decode with and
    without them); and the nearest bf16 rounding tie of the `top` worst
    voxels' activations beside `top` voxels drawn at random."""
    import numpy as np

    from gennerf_tpu_torch.ops.grid_decode import separable_grid_decode_plain

    err = (out - plain).abs()
    worst = torch.argsort(err.reshape(-1), descending=True)[:top].cpu().numpy()
    rand = np.random.default_rng(SEED).choice(err.numel(), top, replace=False)
    control, ties = grid_decode_reordered(torch, tables, weights,
                                          np.concatenate([worst, rand]))
    f32 = separable_grid_decode_plain(tables, weights, bf16_feeds=False)

    def ulps(ts):
        return _quantiles([u for u, _ in ts])

    def sites(ts):
        names, counts = np.unique([w for _, w in ts], return_counts=True)
        return dict(zip(names.tolist(), counts.tolist()))

    rec = {"kernel": error_breakdown(err.cpu().numpy(), plain.cpu().numpy()),
           "control_float64_sums": error_breakdown((control - plain).abs().cpu().numpy(),
                                                   plain.cpu().numpy()),
           "bf16_feeds_vs_f32": {"max_abs": float((plain - f32).abs().max()),
                                 "mean_abs": float((plain - f32).abs().mean())},
           "nearest_tie_ulps": {"worst": ulps(ties[:top]), "random": ulps(ties[top:]),
                                "worst_sites": sites(ties[:top])}}
    return rec


class ReluPicks:
    """A step's discrete picks (the mask of each ReLU's positive inputs, in
    the pointnet's and the decoder's ResnetFC blocks and in the UNet, and
    each UNet 2x2 max-pool's argmax), recorded in one reference step and
    then replayed in other steps of the same weights and inputs, for the
    float32-against-float64 comparisons. Summed in another order, an input
    within an ulp of 0 or of its window's maximum can pick the other way:
    the planes take gradient at few cells, so one such pick in the UNet can
    move a convolution's weight gradient by 1e-2 of its max-abs, and one in
    the decoder moves its weights' gradients, beyond every summation
    order's continuous error. `replaying` counts, per kind, the picks
    that a step's own inputs make otherwise (with `pin=False` it only
    counts, and the step keeps its own picks). `modules` name the model
    modules whose `F.relu` and `F.max_pool2d` are the picks' (default the
    UNet's; VoxelNet's: models.resnet and models.backbone3d); `rows`
    takes one rank's rows of every recorded pick."""

    def __init__(self, torch, modules=None):
        self.torch = torch
        self.modules = modules
        self.picks = []

    def rows(self, rank: int, world: int) -> "ReluPicks":
        """The picks of rank `rank`'s rows of the global batch: the same
        share of axis 0 of each (frames or scenes, each rank's contiguous)."""
        out = ReluPicks(self.torch, self.modules)
        out.picks = [p[rank * p.shape[0] // world:(rank + 1) * p.shape[0] // world]
                     for p in self.picks]
        return out

    @contextlib.contextmanager
    def _patched(self, model, relu, max_pool2d):
        import types
        from unittest import mock

        import torch.nn.functional as F

        from gennerf_tpu_torch.models import unet as unet_module

        blocks = [m for m in model.modules() if getattr(m, "actvn", None) is self.torch.relu]
        functional = types.SimpleNamespace(**{k: getattr(F, k) for k in dir(F)
                                              if not k.startswith("__")})
        functional.relu, functional.max_pool2d = relu, max_pool2d
        for m in blocks:
            m.actvn = relu
        try:
            with contextlib.ExitStack() as stack:
                for module in self.modules or (unet_module,):
                    stack.enter_context(mock.patch.object(module, "F", functional))
                yield
        finally:
            for m in blocks:
                m.actvn = self.torch.relu

    @contextlib.contextmanager
    def recording(self, model):
        import torch.nn.functional as F

        self.picks = []

        def relu(x):
            self.picks.append(x.detach() > 0)
            return F.relu(x)

        def max_pool2d(x, kernel, stride, padding=0):
            y, idx = F.max_pool2d(x, kernel, stride, padding, return_indices=True)
            self.picks.append(idx)
            return y

        with self._patched(model, relu, max_pool2d):
            yield

    @contextlib.contextmanager
    def replaying(self, model, pin: bool = True):
        import torch.nn.functional as F

        torch = self.torch
        turns = iter(self.picks)
        counts = {"relu": 0, "max_pool": 0, "calls": 0}

        def take(kind, own):
            pick = next(turns, None)
            counts["calls"] += 1
            if pick is None or pick.shape != own.shape or pick.dtype != own.dtype:
                raise RuntimeError(f"pick {counts['calls']} ({kind}) does not match the "
                                   f"recorded step")
            pick = pick.to(own.device)
            counts[kind] += int((own != pick).sum())
            return pick

        def relu(x):
            mask = take("relu", x.detach() > 0)
            return torch.where(mask, x, torch.zeros_like(x)) if pin else torch.relu(x)

        def max_pool2d(x, kernel, stride, padding=0):
            y, own = F.max_pool2d(x.detach() if pin else x, kernel, stride, padding,
                                  return_indices=True)
            idx = take("max_pool", own)
            return x.flatten(2).gather(2, idx.flatten(2)).view(idx.shape) if pin else y

        with self._patched(model, relu, max_pool2d):
            yield counts
        if counts["calls"] != len(self.picks):
            raise RuntimeError(f"the step made {counts['calls']} picks, the recorded step "
                               f"{len(self.picks)}")


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
    if not (gate("k1_step.loss_rel", vs_plain["loss_rel_err"], TRAIN_LOSS_RTOL)
            and gate("k1_step.grad_over_max_abs", err[worst], TRAIN_GRAD_TOL)):
        raise RuntimeError(f"train step with K1 disagrees with the plain-FPS step: {vs_plain}")
    return vs_plain


def train_phase(torch, dev, cfg_dict: dict, smi: str) -> dict:
    """Phase 7 (see the module docstring); returns the launch counts of
    the main-path steps."""
    GATES.phase = "train"
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
    step_ms, steps = synced_calls(torch, lambda: train_step(model, opt, batch, gen),
                                  TRAIN_WARMUP + TRAIN_STEPS)
    losses = [float(m["combined"]) for m in steps]
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
    if not all(math.isfinite(x) for x in losses) or losses[-1] >= losses[0]:
        raise RuntimeError(f"training did not lower the loss on its fixed batch: {losses}")
    if launches["fps"] != n_steps:
        raise RuntimeError(f"K1 launched {launches['fps']} times in {n_steps} train steps")
    if not gate("resume_loss_rel", resume_rel, RESUME_RTOL):
        raise RuntimeError(f"the resumed step disagrees: {loss_b} against {loss_a}")
    return launches


def data_phase(torch, dev, smi: str, root: str) -> dict:
    """Phase 8 (see the module docstring): writes the multigeo dataset to
    `root`; returns the launch counts of the main-path runs (the fit, the
    held-out predict, the render)."""
    GATES.phase = "data"
    import tempfile
    from unittest import mock

    from gennerf_tpu_torch.data.datamodule import ScannetDataModule
    from gennerf_tpu_torch.ops import grid_decode as grid_decode_module
    from gennerf_tpu_torch.ops import kernels
    from gennerf_tpu_torch import predict as predict_cli
    from gennerf_tpu_torch.data.datasets import load_info_json, parse_splits_list
    from gennerf_tpu_torch.eval import evaluation
    from gennerf_tpu_torch.predict import build_model
    from gennerf_tpu_torch.train import loop as loop_module
    from gennerf_tpu_torch.train.predict import uses_grid_decode
    from gennerf_tpu_torch.train.step import batch_to_device
    from gennerf_tpu_torch.tsdf import tsdf as tsdf_module
    from gennerf_tpu_torch.utils.config import load_experiment_config

    totals = {k.name: 0 for k in kernels.KERNELS}

    with tempfile.TemporaryDirectory() as tmp:
        write_s = write_dataset(root)
        cfg = load_experiment_config(EXPERIMENT, "train", [f"paths.data_dir={root}"])
        data_cfg, trainer_cfg = cfg["data"], cfg["trainer"]
        if not (data_cfg["random_rotation_3d"] and data_cfg["random_translation_3d"]):
            raise RuntimeError("the data phase needs the config's augmentation on")
        datamodule = ScannetDataModule(data_cfg, seed=SEED)
        train_loader = datamodule.train_dataloader()
        model = build_model(cfg["model"], dev, SEED)

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

        val_records = []

        real_validate = loop_module.Trainer.validate

        def recorded_validate(self, *a, **k):
            out = real_validate(self, *a, **k)
            val_records.append(out)
            return out

        run_dir = os.path.join(tmp, "run")
        run_cfg = load_experiment_config(EXPERIMENT, "train", [f"paths.data_dir={root}",
                                                               f"paths.output_dir={run_dir}"])
        ckpt_cfg = run_cfg["callbacks"]["model_checkpoint"]
        trainer = make_trainer(torch, dev, model, run_cfg, run_dir, DATA_EPOCHS)
        checkpoints = trainer.ckpt
        torch.cuda.reset_peak_memory_stats()
        fit_s, fit_launches, val_encodes, _ = counted_run(
            torch, totals, lambda: trainer.fit(train_loader, datamodule.val_dataloader()),
            mock.patch.object(tsdf_module.TSDF, "transform", timed_transform),
            mock.patch.object(loop_module.Trainer, "validate", recorded_validate))
        peak_bytes = torch.cuda.max_memory_allocated()
        steps = trainer.global_step  # fit raises on a non-finite loss
        waits = [t["data_wait_ms"] for t in trainer.timings]
        step_ms = [t["step_ms"] for t in trainer.timings]
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
        recording_k2 = recorded(grid_decode_module.grid_decode_cuda, decoded)
        pred_dir = os.path.join(tmp, "pred")
        kernels.reset_launch_counts()
        with mock.patch.object(grid_decode_module, "grid_decode_cuda", recording_k2):
            results = predict_cli.main(["--config", EXPERIMENT, "--ckpt", run_dir, "--data-dir", root,
                                        "--split", "val.txt", "--out", pred_dir,
                                        "--device", dev.type])
        torch.cuda.synchronize()
        predict_launches = read_launches(totals)
        with open(os.path.join(pred_dir, "predict_meta.json")) as f:
            predict_meta = json.load(f)
        if (predict_meta["selected_by"], predict_meta["epoch"]) != (ckpt_cfg["monitor"], best_epoch):
            raise RuntimeError(f"predict restored {predict_meta}, not the best epoch {best_epoch}")
        if not predict_launches["grid_decode"] == len(decoded) == len(results) == 2:
            raise RuntimeError(f"held-out predict launched K2 {predict_launches['grid_decode']} "
                               f"times for {len(results)} scenes")
        # those K2 outputs against the plain bf16-feed decode of the same tables
        voxel_dim = tuple(decoded[0][2].shape)
        grid_max, grid_mean, _ = recorded_k2_errors(decoded)
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
        kernels.reset_launch_counts()
        render_rec = k3_march(torch, model, repr_, frames["depth"], frames["intrinsics"],
                              frames["pose"])
        render_launches = read_launches(totals)
        emit({"phase": "data_predict", "scenes": results, "head_bias": head_bias,
              "launches": predict_launches, "voxel_dim": list(voxel_dim),
              "grid_vs_plain": {"max_abs": grid_max, "mean_abs": grid_mean},
              "grid_tolerance": {"max_abs": GRID_MAX_ABS_TOL, "mean_abs": GRID_MEAN_ABS_TOL},
              "render": {"scene": scene, "launches": render_launches, **render_rec},
              "render_tolerance": {"mask_agree": RENDER_MASK_AGREE, "depth_m": RENDER_DEPTH_TOL,
                                   "depth_agree": RENDER_DEPTH_AGREE},
              "eval_tsdf_l1_16_steps_not_quality": {k: v.get("l1") for k, v in results.items()},
              "card": smi})
        if not (gate("k2.max_abs", grid_max, GRID_MAX_ABS_TOL)
                and gate("k2.mean_abs", grid_mean, GRID_MEAN_ABS_TOL)):
            raise RuntimeError(f"K2 on trained weights disagrees: max {grid_max}, mean {grid_mean}")
        if render_launches["point_decode"] < 1:
            raise RuntimeError("the held-out render launched no point_decode kernel")
        if not march_gates("k3_march", render_rec, min_hits=False):
            raise RuntimeError(f"K3 march on trained weights disagrees with the plain march: "
                               f"{render_rec}")

        # K1 against the plain FPS on the first augmented 480x640 loader batch
        vs_plain = k1_step_vs_plain(torch, dev, model, batch_to_device(first, dev), SEED)
        emit({"phase": "data_vs_plain_fps", "vs_plain_fps": vs_plain,
              "tolerance": {"loss_rel": TRAIN_LOSS_RTOL, "grad_over_max_abs": TRAIN_GRAD_TOL},
              "card": smi})
    return totals


def spatial_phase(torch, dev, smi: str, root: str) -> tuple:
    """Phase 9 (see the module docstring); returns the launch counts of
    the main-path runs (the fit with its validation, the reconstruct) and
    {"volume_sample_launches": the volume sample's launches in the
    reconstruct and the cell grid's decode, "backproject_launches": the
    backprojection's in the reconstruct}."""
    GATES.phase = "spatial"
    from gennerf_tpu_torch.data.datamodule import ScannetDataModule
    from gennerf_tpu_torch.models.gen_nerf import GenNerf, SceneRepr
    from gennerf_tpu_torch.ops import kernels
    from gennerf_tpu_torch.predict import build_model, reconstruct
    from gennerf_tpu_torch.tools.port_backbone import main as port_backbone
    from gennerf_tpu_torch.train.predict import predict_tsdf_volume, uses_grid_decode
    from gennerf_tpu_torch.train.step import StepDraws, batch_to_device, gen_nerf_forward_loss
    from gennerf_tpu_torch.train.step import train_step
    from gennerf_tpu_torch.utils import spans
    from gennerf_tpu_torch.utils.config import load_experiment_config

    totals = {k.name: 0 for k in kernels.KERNELS}

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
                and mcfg.encoder.spatial.frame_chunk == 1) or uses_grid_decode(model) \
                or mcfg.sparse_band_decode:
            raise RuntimeError(f"not the spatial drive config: {mcfg.encoder}")
        trainer = make_trainer(torch, dev, model, cfg, run_dir, SPATIAL_EPOCHS)
        opt = trainer.optimizer

        # the main path: the fit over the loaders with its validation and
        # reconstruction tail, counters reset just before and read just after
        torch.cuda.reset_peak_memory_stats()
        fit_s, fit_launches, encodes, _ = counted_run(torch, totals, lambda: trainer.fit(
            datamodule.train_dataloader(), datamodule.val_dataloader()))
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

        model.load_state_dict(fitted)
        plain.load_state_dict(fitted)
        with deterministic_algorithms(torch):
            remat_rec = remat_record(torch, *(forward_backward(
                torch, m, lambda m_: gen_nerf_forward_loss(m_, batch, draws=draws)[0])
                for m in (model, plain)), fitted)
        del plain

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
        if not (gate("chunk.volume_rel", chunk_rec["volume_rel_err"], CHUNK_REL_TOL)
                and chunk_rec["valid_equal"]
                and gate("chunk.planes_rel", chunk_rec["planes_rel_err"], CHUNK_REL_TOL)):
            raise RuntimeError(f"chunked and one-pass encodes disagree: {chunk_rec}")

        # timed train steps on the loader batch
        model.load_state_dict(fitted)
        gen = torch.Generator(device=dev).manual_seed(SEED)
        train_ms = synced_calls(torch, lambda: train_step(model, opt, batch, gen),
                                2 + SPATIAL_TIMED_STEPS)[0]
        med_ms = statistics.median(train_ms[2:])

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
        predict_launches = read_launches(totals)
        # the dense decode samples the feature volume (and a 'grid' plane)
        # once a chunk, each on the kernel
        samples = int(mcfg.has_feature_volume) + int("grid" in mcfg.encoder.pointnet.plane_type)
        volume_samples = {"launches": kernels.VOLUME_SAMPLE.launches,
                          "implied": dense_chunks(voxel_dim) * samples}
        # no graph under reconstruct: the backprojection kernel once a frame chunk
        chunk, frames = mcfg.encoder.spatial.frame_chunk, P.shape[0]
        backprojections = {"launches": kernels.BACKPROJECT.launches,
                           "implied": -(-frames // chunk) if 0 < chunk < frames else 1}
        smoothing = mcfg.mlp.head_smoothing
        if tuple(vol.shape) != voxel_dim or not torch.isfinite(vol).all() \
                or float(vol.abs().max()) > max(smoothing, 1.0):
            raise RuntimeError(f"spatial volume {tuple(vol.shape)} not finite or out of range")
        if (predict_launches["fps"], predict_launches["grid_decode"]) != (1, 0):
            raise RuntimeError(f"the spatial reconstruct launched {predict_launches}")
        if not gate("reconstruct.volume_sample_launches",
                    abs(volume_samples["launches"] - volume_samples["implied"]), 0):
            raise RuntimeError(f"the spatial reconstruct's volume samples: {volume_samples}")
        if not gate("reconstruct.backproject_launches",
                    abs(backprojections["launches"] - backprojections["implied"]), 0):
            raise RuntimeError(f"the spatial reconstruct's backprojections: {backprojections}")
        total_ms = host_ms(torch, lambda: reconstruct(model, P, image, depth, voxel_dim,
                                                      torch.Generator().manual_seed(SEED)), 3)
        origin = torch.zeros(3, device=dev)
        with torch.no_grad():
            repr_ = model.encode(P[None], image[None], depth[None],
                                 torch.Generator().manual_seed(SEED), voxel_dim=voxel_dim)
        decode_ms = host_ms(torch, lambda: predict_tsdf_volume(model, repr_, voxel_dim,
                                                               mcfg.voxel_size, origin), 3)
        del repr_

        # a dense decode of the spatial benchmark cell's grid on a random
        # scene of this config's widths, counters reset just before and read
        # just after: the volume sample once a chunk, every point through it
        p = mcfg.encoder.pointnet
        gen = torch.Generator(device=dev).manual_seed(SEED)
        cell = SceneRepr({k: torch.randn((1, p.c_dim, p.plane_resolution, p.plane_resolution),
                                         generator=gen, device=dev) for k in p.plane_type},
                         torch.randn((1, mcfg.encoder_latent - p.c_dim, *SPATIAL_CELL_GRID),
                                     generator=gen, device=dev),
                         torch.randint(0, 4, (1, 1, *SPATIAL_CELL_GRID), generator=gen,
                                       device=dev).float())
        kernels.reset_launch_counts()
        spans.reset()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
            tsdf = predict_tsdf_volume(model, cell, SPATIAL_CELL_GRID, SPATIAL_CELL_VOXEL, origin)
        torch.cuda.synchronize()
        voxels = math.prod(SPATIAL_CELL_GRID)
        cell_decode = {"grid": list(SPATIAL_CELL_GRID), "launches": kernels.VOLUME_SAMPLE.launches,
                       "implied": dense_chunks(SPATIAL_CELL_GRID) * samples,
                       "finite": bool(torch.isfinite(tsdf).all()), **spans.counters()}
        spans.reset()
        del cell, tsdf
        if not (gate("cell_decode.launches", abs(cell_decode["launches"] - cell_decode["implied"]),
                     0)
                & gate("cell_decode.kernel_points",
                       abs(cell_decode.get("trilinear.kernel_points", 0) - voxels * samples), 0)
                & gate("cell_decode.points",
                       abs(cell_decode.get("trilinear.points", 0) - voxels * samples), 0)
                and cell_decode["finite"]):
            raise RuntimeError(f"the dense decode of the spatial cell's grid: {cell_decode}")

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
                          "launches": predict_launches, "volume_sample": volume_samples,
                          "backproject": backprojections,
                          "total_ms": total_ms,
                          "decode_ms": decode_ms, "out_abs_max": float(vol.abs().max())},
              "cell_decode": cell_decode, "card": smi})
    return totals, {"volume_sample_launches": volume_samples["launches"] + cell_decode["launches"],
                    "backproject_launches": backprojections["launches"]}


def voxelnet_phase(torch, dev, smi: str, root: str) -> tuple:
    """Phase 10 (see the module docstring); returns the TPU-kernel ports'
    launch counts of the whole phase (all 0: VoxelNet's path has no TPU
    kernel) and {"lift_launches": the lift kernels' counts of the whole
    phase} (its bf16 spatial encoder runs the fused lift)."""
    GATES.phase = "voxelnet"
    from gennerf_tpu_torch import predict as predict_cli
    from gennerf_tpu_torch import set_reference_precision
    from gennerf_tpu_torch.data.datamodule import ScannetDataModule
    from gennerf_tpu_torch.data.datasets import load_info_json, parse_splits_list
    from gennerf_tpu_torch.eval import evaluation
    from gennerf_tpu_torch.models.voxel_net import VoxelNet
    from gennerf_tpu_torch.ops import kernels
    from gennerf_tpu_torch.predict import build_model
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
        ckpt_cfg = cfg["callbacks"]["model_checkpoint"]
        trainer = make_trainer(torch, dev, model, cfg, run_dir, VOXELNET_EPOCHS)
        opt = trainer.optimizer

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
                   "best_epoch": trainer.ckpt.best_epoch(),
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
        if not (gate("device.loss_rel", loss_err, VOXELNET_DEVICE_LOSS_RTOL) and all(
                [gate(f"device.{k}_share_within", r["share_within"], VOXELNET_DEVICE_SHARE,
                      "agree") for k, r in device_rec.items() if k.startswith("vol_")])):
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
                and gate("bf16_loss_rel", precision_rec["loss_rel_diff"],
                         VOXELNET_BF16_LOSS_RTOL)):
            raise RuntimeError(f"the bf16-mixed policy is broken: {precision_rec}")

        # the lift kernels' launches over `steps` forwards and backwards
        # against what the steps imply: one lift a frame chunk, again in a
        # remat's recompute, and in the backward one gather a resized map a
        # chunk (the resized maps: those of the ResNet not at the stem's size)
        resnet_sizes = []
        size_hook = model.spatial.resnet.register_forward_hook(
            lambda module, args, out: resnet_sizes.append([tuple(f.shape[-2:]) for f in out]))
        with torch.no_grad():
            model.spatial(torch.zeros(1, 3, *batch["image"].shape[-2:], device=dev), False)
        size_hook.remove()
        resized = sum(hw != resnet_sizes[0][0] for hw in resnet_sizes[0][1:])
        fc = mcfg.encoder.spatial.frame_chunk
        chunks = -(-T // fc) if 0 < fc < T else 1
        lift_rec = {"frame_chunks": chunks, "resized_maps": resized}

        def lift_counts():
            return {k.name: k.launches for k in kernels.LIFT_KERNELS}

        def lift_gates(name, before, steps, remat):
            implied = {"spatial_lift": steps * chunks * (2 if remat else 1),
                       "lift_resize_t": steps * chunks * resized}
            got = {k: v - before[k] for k, v in lift_counts().items()}
            lift_rec[name] = {"launches": got, "implied": implied}
            return all([gate(f"lift_launches.{name}.{k}", abs(got[k] - implied[k]), 0)
                        for k in implied])

        # remat against no remat: one bf16 forward and backward in training
        # mode, deterministic algorithms where torch has them (the gather's
        # backward adds with atomics; the trilinear upsample's backward has
        # no deterministic version, warn only)
        def lift_step(remat):  # forward_backward, the lift's launches gated
            before = lift_counts()
            run = forward_backward(torch, fresh(dev, torch.bfloat16, remat=remat),
                                   lambda m: voxel_net_forward_loss(m, batch)[0])
            if not lift_gates("remat" if remat else "no_remat", before, 1, remat):
                raise RuntimeError(f"the lift's launches are not the step's: {lift_rec}")
            return run

        with deterministic_algorithms(torch):
            remat_rec = remat_record(torch, lift_step(True), lift_step(False), fitted)

        # timed bf16 train steps on the loader batch
        model.load_state_dict(fitted)
        torch.cuda.reset_peak_memory_stats()
        before = lift_counts()
        train_ms = synced_calls(torch, lambda: train_step(model, opt, batch),
                                VOXELNET_WARMUP + VOXELNET_TIMED_STEPS)[0]
        step_peak = torch.cuda.max_memory_allocated()
        if not lift_gates("timed_steps", before, VOXELNET_WARMUP + VOXELNET_TIMED_STEPS,
                          mcfg.remat):
            raise RuntimeError(f"the lift's launches are not the steps': {lift_rec}")
        med_ms = statistics.median(train_ms[VOXELNET_WARMUP:])

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
        lift_launches = lift_counts()
        if any(launches.values()):
            raise RuntimeError(f"the VoxelNet phase launched TPU-kernel ports ({launches})")
        emit({"phase": "voxelnet", "config": "configs/experiment/seqs_multigeo_voxelnet.yaml",
              "precision": precision, "lift_launches": lift_launches, "lift_steps": lift_rec,
              "batch": {"frames": [T, H, W], "resnet_input": [2 * H, 2 * W],
                        "voxel_dim_train": list(mcfg.voxel_dim_train)},
              "fit": fit_rec, "launches": launches, "card_vs_cpu_f32": device_rec,
              "precision_discipline": precision_rec, "remat_vs_plain": remat_rec,
              "train_step_ms": {"median": med_ms, "all": train_ms,
                                "peak_memory_bytes": step_peak},
              "predict": {"meta": predict_meta, "seconds": predict_s, "scenes": results},
              "eval": {scene: rec["pred"] for scene, rec in eval_rec.items()},
              "card": smi})
    return launches, {"lift_launches": lift_launches}


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
    """Phase 11 (see the module docstring); returns the launch counts of
    the main-path runs (the fits with their validations, the timed bf16
    steps, the frustum, gradient and spatial steps, the held-out predict,
    the reconstruct at the flagship's grid, the render) and each kernel's
    largest error against its plain version in the phase."""
    GATES.phase = "flagship_bf16"
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
    from gennerf_tpu_torch.tools.measure import FPS_INNER, cuda_ms
    from gennerf_tpu_torch.ops.grid_decode import grid_decode_flops
    from gennerf_tpu_torch.train.predict import dense_grid_points, uses_grid_decode
    from gennerf_tpu_torch.train import step as step_module
    from gennerf_tpu_torch.train.state import make_optimizer
    from gennerf_tpu_torch.train.step import batch_to_device, gen_nerf_forward_loss, train_step

    totals = {k.name: 0 for k in kernels.KERNELS}

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
        trainer = make_trainer(torch, dev, model, cfg, run_dir, FLAGSHIP_EPOCHS,
                               precision=precision)
        datamodule = ScannetDataModule(cfg["data"], seed=SEED)

        torch.cuda.reset_peak_memory_stats()
        fit_s, launches, encodes, _ = counted_run(torch, totals, lambda: trainer.fit(
            datamodule.train_dataloader(), datamodule.val_dataloader()))
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
        main path). Returns (step ms, launches, peak bytes, losses)."""
        gen = torch.Generator(device=dev).manual_seed(SEED)
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        ms, steps = synced_calls(torch, lambda: train_step(model, opt, batch, gen),
                                 FLAGSHIP_WARMUP + n)
        launches = (read_launches(totals) if main_path
                    else {k.name: k.launches for k in kernels.KERNELS})
        return (ms, launches, torch.cuda.max_memory_allocated(),
                [float(m["combined"]) for m in steps])

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
        if not (gate("bf16_loss_rel", precision_rec["loss_rel_diff"], FLAGSHIP_BF16_LOSS_RTOL)
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
        if not gate("device_over_max_abs", device_rec_tol, FLAGSHIP_DEVICE_TOL):
            raise RuntimeError(f"the float32 flagship on the card and on the CPU disagree: "
                               f"{device_rec}")
        del outs

        # timed bf16 steps on the loader batch (the main path), then the same in float32
        model.load_state_dict(fitted)
        ms16, launches16, peak16, losses16 = timed_steps(
            model, opt, batch, FLAGSHIP_TIMED_STEPS)
        n16 = FLAGSHIP_WARMUP + FLAGSHIP_TIMED_STEPS
        if launches16["fps"] != n16 or not all(math.isfinite(x) for x in losses16):
            raise RuntimeError(f"the timed bf16 steps: K1 {launches16['fps']} in {n16} steps, "
                               f"losses {losses16}")
        m32 = fresh(dev, torch.float32)
        opt32 = make_optimizer(m32.parameters(), mcfg.optimizer)
        ms32, launches32, peak32, _ = timed_steps(m32, opt32, batch, FLAGSHIP_TIMED_STEPS,
                                                  main_path=False)
        del m32, opt32
        steps_rec = {
            "bf16": {"step_ms_median": statistics.median(ms16[FLAGSHIP_WARMUP:]),
                     "step_ms_all": ms16, "launches": launches16, "peak_memory_bytes": peak16},
            "f32": {"step_ms_median": statistics.median(ms32[FLAGSHIP_WARMUP:]),
                    "step_ms_all": ms32, "launches": launches32, "peak_memory_bytes": peak32}}

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
        # CPU, on the same inputs and with the float64 step's ReLU and
        # max-pool picks (ReluPicks), and the card's bf16-mixed step as the
        # control, for EIKONAL_SEEDS draws (deterministic algorithms on the
        # card); the card's float32 step on its own picks beside them, read
        # and not gated
        cpu = torch.device("cpu")
        f32, f64, bf16 = torch.float32, torch.float64, torch.bfloat16
        runs = (("cpu_f64", cpu, f64, f32), ("card", dev, f32, f32), ("cpu", cpu, f32, f32),
                ("card_bf16", dev, f32, bf16), ("card_own_picks", dev, f32, f32))
        eik_seeds = []
        with deterministic_algorithms(torch):
            for seed in range(SEED + 2, SEED + 2 + EIKONAL_SEEDS):
                eik_draws = ray_draws(torch, cpu, eik_model.cfg, batch, seed)
                same_inputs, eik_fps_flips = cpu_inputs(torch, dev, eik_model.cfg, batch,
                                                         eik_draws)
                relu_picks = ReluPicks(torch)
                steps_, picks_off = {}, {}
                for name, device, dtype, compute in runs:
                    m = fresh(device, compute, eik_model.cfg, eik_state).to(dtype).train()

                    def to(v):
                        return v.to(device, dtype) if v.is_floating_point() else v.to(device)

                    d = eik_draws._replace(**{k: to(getattr(eik_draws, k))
                                              for k in eik_draws._fields
                                              if getattr(eik_draws, k) is not None})
                    picks = (relu_picks.recording(m) if name == "cpu_f64" else
                             relu_picks.replaying(m, pin=name != "card_own_picks"))
                    with same_inputs(), picks as counts:
                        loss, metrics = gen_nerf_forward_loss(
                            m, {k: to(v) for k, v in batch.items()}, draws=d)
                        loss.backward()
                    if counts is not None:
                        picks_off[name] = counts
                    steps_[name] = (float(loss.detach()), float(metrics["eikonal"].detach()),
                                    {n: q.grad.cpu().double() for n, q in m.named_parameters()})
                    del m
                del relu_picks

                def to_f64(a):
                    errs = {n: float((steps_[a][2][n] - g).abs().max())
                            / max(float(g.abs().max()), 1e-30)
                            for n, g in steps_["cpu_f64"][2].items()}
                    worst = max(errs, key=errs.get)
                    return errs[worst], worst

                dist = {k: to_f64(k) for k in ("card", "cpu", "card_bf16", "card_own_picks")}
                eik_seeds.append({
                    "seed": seed, "loss_card": steps_["card"][0], "loss_cpu": steps_["cpu"][0],
                    "loss_cpu_f64": steps_["cpu_f64"][0], "eikonal_card": steps_["card"][1],
                    "eikonal_cpu": steps_["cpu"][1],
                    "loss_rel_err": abs(steps_["card"][0] - steps_["cpu"][0])
                    / abs(steps_["cpu"][0]),
                    "grad_vs_f64_over_max_abs": {k: v[0] for k, v in dist.items()},
                    "worst_grad": {k: v[1] for k, v in dist.items()},
                    "ratio_to_cpu_f32": {k: dist[k][0] / dist["cpu"][0]
                                         for k in ("card", "card_bf16", "card_own_picks")},
                    "picks_off_f64": picks_off,
                    "k1_on_card_clouds_index_mismatches": eik_fps_flips})
                del steps_
        if not all([gate(f"eikonal.seed{r['seed']}.loss_rel", r["loss_rel_err"], TRAIN_LOSS_RTOL)
                    and gate(f"eikonal.seed{r['seed']}.card_over_cpu_f32",
                             r["ratio_to_cpu_f32"]["card"], EIKONAL_NOISE_FACTOR)
                    and gate(f"eikonal.seed{r['seed']}.bf16_control_over_cpu_f32",
                             r["ratio_to_cpu_f32"]["card_bf16"], EIKONAL_NOISE_FACTOR, "beyond")
                    for r in eik_seeds]):
            raise RuntimeError(f"the float32 eikonal step on the card and on the CPU disagree, "
                               f"or the gate cannot tell a bf16 step from float32: {eik_seeds}")
        # the eikonal bf16 step against the flagship's bf16 step
        eik_opt = eik_trainer.optimizer
        eik_gen = torch.Generator(device=dev).manual_seed(SEED)
        kernels.reset_launch_counts()
        eik_ms = host_ms(torch, lambda: train_step(eik_model, eik_opt, batch, eik_gen), 5)
        read_launches(totals)
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
            launches = read_launches(totals)
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
        recording_k2 = recorded(grid_decode_module.grid_decode_cuda, decoded)

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
        predict_launches = read_launches(totals)
        with open(os.path.join(pred_dir, "predict_meta.json")) as f:
            predict_meta = json.load(f)
        if not (predict_meta["precision"] == "bf16-mixed"
                and predict_launches["grid_decode"] == len(decoded) == len(results) == 2):
            raise RuntimeError(f"held-out predict: {predict_meta}, K2 "
                               f"{predict_launches['grid_decode']} for {len(results)} scenes")
        pred_grid = recorded_k2_errors(decoded)
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
        recon_launches = read_launches(totals)
        tables, weights, _ = decoded[0]
        recon_grid = recorded_k2_errors(decoded)
        k2_ms = cuda_ms(torch, lambda: grid_decode_module.grid_decode_cuda(tables, weights),
                        reps=10)
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
                and grid_gates("k2_predict", *pred_grid[:2])
                & grid_gates("k2_reconstruct", *recon_grid[:2])
                & gate("k2_reconstruct.live_share", recon_grid[2], FIELD_MIN_LIVE_SHARE, "min")):
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
        k3_rec = dict(k3_points(torch, model, repr_, pts), field_shift=render_shift)
        del pts
        if not point_gates("k3", k3_rec):
            raise RuntimeError(f"K3 at d_in 64 on the bf16 flagship's planes: {k3_rec}")

        # the view through K3 (the main path), against the plain march
        kernels.reset_launch_counts()
        render_rec = k3_march(torch, model, repr_, view["depth"], view["intrinsics"], view["pose"])
        render_launches = read_launches(totals)
        render_rec.update(scene=scene_batch["scene"][0], launches=render_launches,
                          field_shift=render_shift)
        if not (render_launches["point_decode"] >= 1 and march_gates("k3_march", render_rec)):
            raise RuntimeError(f"the bf16 render through K3: {render_rec}")
        del repr_

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
        spatial_launches = read_launches(totals)
        spatial_rec = {"loss_bf16": float(smetrics["combined"]), "loss_f32": sloss32,
                       "loss_rel_diff": abs(float(smetrics["combined"]) - sloss32) / abs(sloss32),
                       "launches": spatial_launches, "grads_finite": grads_finite(s16)}
        if not (spatial_launches["fps"] == 1 and spatial_rec["grads_finite"]
                and gate("spatial_bf16_loss_rel", spatial_rec["loss_rel_diff"],
                         FLAGSHIP_BF16_LOSS_RTOL)):
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
    # each kernel's largest error against its plain version at this path's shapes
    errors = {"fps": float((idx_k - idx_p).abs().max()),
              "grid_decode": max(pred_grid[0], recon_grid[0]),
              "point_decode": k3_rec["max_abs_err"]}
    return totals, errors


def distill_phase(torch, dev, smi: str, root: str) -> tuple:
    """Phase 12 (see the module docstring); returns the launch counts of
    the main-path runs (the two fits through the train CLI, the timed
    steps of each mode, the trained model's reconstruct and its held-out
    view through K3, the use_auxiliary step, reconstruct and render) and
    K2's and K3's largest errors against their plain versions in the
    phase."""
    GATES.phase = "distill"
    from unittest import mock

    import numpy as np

    from gennerf_tpu_torch.data.datamodule import ScannetDataModule
    from gennerf_tpu_torch.data.synthetic import generate_scene
    from gennerf_tpu_torch.ops import grid_decode as grid_decode_module
    from gennerf_tpu_torch.ops import kernels
    from gennerf_tpu_torch.predict import build_model, reconstruct
    from gennerf_tpu_torch.render import render_views
    from gennerf_tpu_torch.train import step as step_module
    from gennerf_tpu_torch.train.__main__ import main as train_main
    from gennerf_tpu_torch.train.predict import dense_grid_points, uses_grid_decode
    from gennerf_tpu_torch.train.state import make_optimizer
    from gennerf_tpu_torch.train.step import batch_to_device, gen_nerf_forward_loss, train_step

    totals = {k.name: 0 for k in kernels.KERNELS}

    t0 = time.perf_counter()
    info = generate_scene(root, num_frames=DISTILL_FRAMES)
    scene_s = time.perf_counter() - t0
    cpu = torch.device("cpu")

    def fit(path, run_dir):
        """The train CLI on the config (its 10 epochs, validation every 5),
        counters reset just before and read just after; each epoch's row
        of metrics.csv. Returns (trainer, record)."""
        fit_s, launches, evals, trainer = counted_run(torch, totals, lambda: train_main(
            ["--config", path, "--data-dir", root, "--out", run_dir, "--device", dev.type]))
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
        if not (gate(f"card_vs_cpu.seed{seed}.loss_rel", rec["loss_rel_err"], TRAIN_LOSS_RTOL)
                & gate(f"card_vs_cpu.seed{seed}.hit_agree", rec.get("hit_agree", 1.0),
                       RENDER_MASK_AGREE, "agree")
                & gate(f"card_vs_cpu.seed{seed}.point_dist_m", rec.get("point_dist_max_m", 0.0),
                       RENDER_DEPTH_TOL)):
            raise RuntimeError(f"a distillation step on the card and on the CPU disagree: {rec}")
        return rec

    def timed_steps(model, opt, batch):
        """DISTILL_WARMUP + DISTILL_TIMED_STEPS synchronized train steps
        (counters reset just before and read just after)."""
        gen = torch.Generator(device=dev).manual_seed(SEED)
        kernels.reset_launch_counts()
        ms, steps = synced_calls(torch, lambda: train_step(model, opt, batch, gen),
                                 DISTILL_WARMUP + DISTILL_TIMED_STEPS)
        metrics = steps[-1]
        launches = read_launches(totals)
        rec = {"step_ms_median": statistics.median(ms[DISTILL_WARMUP:]), "step_ms_all": ms,
               "launches": launches, "metrics": {k: float(v) for k, v in metrics.items()}}
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

        # K2 on the trained distillation head (d_geo 64, lin_out 128 wide):
        # the scene's test frames through reconstruct, the field centred
        # first if it is saturated there
        scene_batch = next(iter(ScannetDataModule(data_cfg, seed=SEED).predict_dataloader()))
        view = {k: torch.as_tensor(scene_batch[k][0]).to(dev)
                for k in ("projection", "image", "depth", "intrinsics", "pose")}
        frames = (view["projection"], view["image"], view["depth"])
        decoded = []
        recording_k2 = recorded(grid_decode_module.grid_decode_cuda, decoded)

        def k2_reconstruct():
            decoded.clear()
            kernels.reset_launch_counts()
            with mock.patch.object(grid_decode_module, "grid_decode_cuda", recording_k2):
                vol = reconstruct(model, *frames, mcfg.voxel_dim_test,
                                  torch.Generator().manual_seed(SEED))
            torch.cuda.synchronize()
            launches = read_launches(totals)
            d_in = int(decoded[0][1]["w_in"].shape[0])
            return {"launches": launches, "finite": bool(torch.isfinite(vol).all()), "d_in": d_in,
                    **dict(zip(("max_abs_err", "mean_abs_err", "live_share"),
                               recorded_k2_errors(decoded)))}

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
                and k2_final["finite"]
                and gate("k2.live_share", k2_final["live_share"], FIELD_MIN_LIVE_SHARE, "min")
                & grid_gates("k2", max(r["max_abs_err"] for r in k2_rec.values()
                                       if isinstance(r, dict)),
                             max(r["mean_abs_err"] for r in k2_rec.values()
                                 if isinstance(r, dict)))):
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

        def k3_view():
            kernels.reset_launch_counts()
            with torch.no_grad():
                repr_ = model.encode(*(f[None] for f in frames),
                                     torch.Generator().manual_seed(SEED))
            torch.cuda.synchronize()
            encode_launches = read_launches(totals)
            rec = dict(k3_points(torch, model, repr_, pts), encode_launches=encode_launches)
            kernels.reset_launch_counts()
            rec.update(k3_march(torch, model, repr_, view["depth"], view["intrinsics"],
                                view["pose"]), launches=read_launches(totals))
            return rec, repr_

        k3_rec = {"field_shift": 0.0}
        k3_final, repr_ = k3_view()
        k3_rec["trained" if k2_rec["field_shift"] == 0.0 else "centred_for_k2"] = k3_final
        if (k3_final["live_share"] < FIELD_MIN_LIVE_SHARE
                or k3_final["hit_share"] < RENDER_MIN_HIT_SHARE):
            k3_rec["field_shift"] = center_field(torch, model, repr_, grid_pts)
            k3_rec["centred"] = k3_final = k3_view()[0]
        del repr_, pts
        k3_runs = [r for r in k3_rec.values() if isinstance(r, dict)]
        if not (k3_final["launches"]["point_decode"] >= 1 and k3_final["launches"]["fps"] == 0
                and k3_final["encode_launches"] == {"fps": 1, "grid_decode": 0, "point_decode": 0}
                and point_gates("k3", {"max_abs_err": max(r["max_abs_err"] for r in k3_runs),
                                       "mean_abs_err": max(r["mean_abs_err"] for r in k3_runs),
                                       "live_share": k3_final["live_share"]})
                & march_gates("k3_march", k3_final)):
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
                           "launches": read_launches(totals)}
        aux.eval()
        kernels.reset_launch_counts()
        vol = reconstruct(aux, *frames, mcfg.voxel_dim_test, torch.Generator().manual_seed(SEED))
        out = render_views(aux, *frames, view["intrinsics"], view["pose"], num_views=1,
                           generator=torch.Generator().manual_seed(SEED))
        torch.cuda.synchronize()
        aux_rec.update(launches=read_launches(totals),
                       volume_finite=bool(torch.isfinite(vol).all()),
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
    """Phase 13 (see the module docstring); returns the launch counts of
    the main-path runs (the fit with its test pass, the resume, the sweep,
    the overhead fits) and K2's largest error against its plain version
    over the fit's tails."""
    GATES.phase = "harness"
    import io
    import signal
    from unittest import mock

    import numpy as np

    from gennerf_tpu_torch.data.datamodule import ScannetDataModule
    from gennerf_tpu_torch.ops import grid_decode as grid_decode_module
    from gennerf_tpu_torch.ops import kernels
    from gennerf_tpu_torch.ops import sampling as sampling_module
    from gennerf_tpu_torch.predict import build_model
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

    def csv_rows(path):
        with open(path) as f:
            return list(csv.DictReader(f))

    with tempfile.TemporaryDirectory() as tmp:
        # (1) one fit through the train CLI with the harness options
        run = os.path.join(tmp, "fit")
        prof_dir = os.path.join(tmp, "prof")
        decoded, sampled = [], []
        fit_s, launches, evals, trainer = counted_run(
            torch, totals, lambda: train_main(["--config", EXPERIMENT, "--data-dir", root,
                                               "--out", run, "--device", dev.type,
                                               *HARNESS_OVERRIDES,
                                               f"trainer.profile_dir={prof_dir}"]),
            mock.patch.object(grid_decode_module, "grid_decode_cuda",
                              recorded(grid_decode_module.grid_decode_cuda, decoded)),
            mock.patch.object(sampling_module, "fps_cuda",
                              recorded(sampling_module.fps_cuda, sampled)))
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
        tails = len(decoded)
        grid_max, grid_mean, _ = recorded_k2_errors(decoded)
        # each K1 launch of the fit against the plain FPS on its inputs
        fps_diff = [(out - sampling_module.farthest_point_sample_plain(xyz, npoint, start)).abs()
                    for xyz, npoint, start, out in sampled]
        fps_mismatches = [int((d != 0).sum()) for d in fps_diff]
        fps_max = max(float(d.max()) for d in fps_diff)
        del fps_diff
        k1_shapes = sorted({(*xyz.shape[:2], npoint) for xyz, npoint, _, _ in sampled})
        del sampled

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
            "k2_vs_plain": {"max_abs": grid_max, "mean_abs": grid_mean, "tails": tails},
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
        if n_tail != epochs_run + 1 or tails != n_tail or not grid_gates(
                "k2_tails", grid_max, grid_mean):
            raise RuntimeError(f"the tails' K2 volumes against the plain decode: {tails} tails, "
                               f"max {grid_max}, mean {grid_mean}")
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
        overhead_launches = read_launches(totals)
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
        resume_launches = read_launches(totals)
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
        sweep_launches = read_launches(totals)
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
    """Phase 14 (see the module docstring); returns the launch counts of
    the main-path runs (the CLIs on the reference checkpoint, the option
    groups' steps and reconstructs, PointNet++) and each kernel's largest
    error against its plain version there."""
    GATES.phase = "weights_options"
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
    from gennerf_tpu_torch.train.checkpoints import load_checkpoint, save_checkpoint
    from gennerf_tpu_torch.train.predict import uses_grid_decode
    from gennerf_tpu_torch.train.state import make_optimizer
    from gennerf_tpu_torch.train.step import batch_to_device, gen_nerf_forward_loss, train_step
    from gennerf_tpu_torch.utils.port_reference import (
        port_reference_state, read_reference_checkpoint, reference_state_dict,
    )

    t_phase = time.perf_counter()
    totals = {k.name: 0 for k in kernels.KERNELS}
    cpu = torch.device("cpu")

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

    recording_k2 = recorded(real_k2, decoded)

    def k1_vs_plain():
        """Each recorded K1 launch against the plain FPS on its inputs."""
        recs = [{"shape": list(xyz.shape), "npoint": npoint, "plan": plan,
                 "index_mismatches": int((out != sampling_module.farthest_point_sample_plain(
                     xyz, npoint, start)).sum())} for xyz, npoint, start, out, plan in sampled]
        sampled.clear()
        return recs

    def k2_vs_plain(pin: bool = False):
        """(max error, mean error, pinned) of each recorded K2 call against
        the plain bf16-feed decode; with `pin` the third is k2_pinned_error's
        record (these fabricated weights carry one rounding flip to
        0.04-0.05 at a voxel, as far as a decode summed in float64 lies from
        the plain one), else None."""
        errs = []
        for tables, weights, out in decoded:
            plain = grid_decode_module.separable_grid_decode_plain(tables, weights,
                                                                   bf16_feeds=True)
            err = (out - plain).abs()
            pinned = k2_pinned_error(torch, tables, weights, out, plain) if pin else None
            if pin and at_edge(gate_margin(pinned["max_abs"], REFERENCE_K2_PINNED_TOL),
                               gate_margin(pinned["unexplained_max_abs"], GRID_MAX_ABS_TOL),
                               gate_margin(float(err.mean()), GRID_MEAN_ABS_TOL)):
                pinned["analysis"] = k2_analysis(torch, tables, weights, out, plain)
            errs.append((float(err.max()), float(err.mean()), pinned))
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
        # seqs_multigeo_4cm through the predict and render CLIs' --params,
        # under deterministic algorithms: the field centred and the kernels
        # compared on the same planes in every run (the encode's scatter
        # atomics otherwise move the worst voxel's and ray's readings from
        # run to run)
        determinism = contextlib.ExitStack()
        determinism.enter_context(deterministic_algorithms(torch))
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
        kernels.reset_launch_counts()
        with torch.no_grad():
            repr_ = model.encode(view["projection"][None], view["image"][None],
                                 view["depth"][None], torch.Generator().manual_seed(SEED))
        torch.cuda.synchronize()
        encode_launches = read_launches(totals)
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
        cli_launches = read_launches(totals)
        cli_k1 = k1_vs_plain()
        cli_k2 = k2_vs_plain(pin=True)
        with open(os.path.join(pred_dir, "predict_meta.json")) as f:
            predict_meta = json.load(f)
        if not (cli_launches["fps"] == 2 and cli_launches["grid_decode"] == 1
                and cli_launches["point_decode"] >= 1 and len(cli_k1) == 2 and len(cli_k2) == 1
                and all(r["index_mismatches"] == 0 for r in cli_k1)
                and reference_k2_gates("reference_ckpt_k2", *cli_k2[0])
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
        k3_rec = k3_march(torch, reader_model, repr_, view["depth"], view["intrinsics"],
                          view["pose"])
        k3_rec["field_shift"] = shift
        if not march_gates("reference_ckpt_k3_march", k3_rec):
            raise RuntimeError(f"the reference checkpoint's view through K3: {k3_rec}")
        del repr_

        determinism.close()

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
                    "k2_vs_plain": {"max_abs": cli_k2[0][0], "mean_abs": cli_k2[0][1],
                                    "pinned": cli_k2[0][2]},
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
            # Each encode backprojects through the CPU's pixel picks
            # (cpu_projections): a voxel whose projection lies within an ulp
            # of a pixel edge takes the other pixel on the other device (the
            # card's own picks that differ are counted)
            flips = []
            for device, m in ((cpu, ocpu.train(name == "voxelnet")),
                              (dev, omodel.train(name == "voxelnet"))):
                b = {k: v.to(device) for k, v in batch.items()}
                with torch.no_grad(), cpu_projections(torch, flips):
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
            # volumes are held by the share of elements within the
            # tolerance, as the voxelnet phase holds them; planes (on the
            # CPU's points) and the loss by their largest difference
            rec = {}
            for k, v in outs["cpu"][0].items():
                err = (outs[dev.type][0][k] - v).abs()
                rec[k] = {"max_rel": float(err.max()) / float(v.abs().max()),
                          "share_within": float((err <= OPTIONS_DEVICE_RTOL * v.abs().max())
                                                .double().mean())}
            rec["volume"].update(pixel_picks_otherwise=sum(flips), voxel_frame_picks=int(
                OTHER_FRAMES * math.prod(omodel.cfg.voxel_dim_train)))
            loss_err = abs(outs[dev.type][1] - outs["cpu"][1]) / abs(outs["cpu"][1])
            others[name] = {"tensors": len(ref_o), "read_ms": o_read_ms,
                            "left_at_init": loaded["unfilled"], "card_vs_cpu": rec,
                            "loss_rel_err": loss_err, "frames": OTHER_FRAMES}
            volumes_ok = all([gate(f"{name}_ckpt.{k}_share_within", r["share_within"],
                                   VOXELNET_DEVICE_SHARE, "agree") if k.startswith("vol")
                              else gate(f"{name}_ckpt.{k}_rel", r["max_rel"], OPTIONS_DEVICE_RTOL)
                              for k, r in rec.items()])
            if not volumes_ok or not gate(f"{name}_ckpt.loss_rel", loss_err,
                                          OPTIONS_DEVICE_RTOL) or (
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
            launches = read_launches(totals)
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
                    and gate(f"group_{group}.loss_rel", loss_err, OPTIONS_DEVICE_RTOL)
                    & gate(f"group_{group}.planes_rel", max(plane_err["initial"].values()),
                           OPTIONS_DEVICE_RTOL)
                    & gate(f"group_{group}.grad_vs_f64", grad_dist["card"][0],
                           max(TRAIN_GRAD_TOL, EIKONAL_NOISE_FACTOR * grad_dist["cpu"][0]))
                    & all([grid_gates(f"group_{group}.k2", *e[:2]) for e in k2_errs])):
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
        pnpp_launches = read_launches(totals)
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
                        "reference_k2_max_abs_pinned": REFERENCE_K2_PINNED_TOL,
                        "render": {"mask_agree": RENDER_MASK_AGREE, "depth_m": RENDER_DEPTH_TOL,
                                   "depth_agree": RENDER_DEPTH_AGREE,
                                   "min_hit_share": RENDER_MIN_HIT_SHARE},
                        "card_vs_cpu_rel": OPTIONS_DEVICE_RTOL},
          "phase_s": time.perf_counter() - t_phase, "card": smi})
    return totals, errors


def model_options_phase(torch, dev, smi: str, root: str, synth_root: str) -> tuple:
    """Phase 15 (see the module docstring); returns the launch counts of
    the main-path runs (VoxelNet's steps and predicts, the spatial
    forwards, the bf16 option groups' steps, reconstructs and view, the
    bf16 distillation steps, reconstruct and view, the use_auxiliary step)
    and each kernel's largest error against its plain version there."""
    GATES.phase = "model_options"
    import warnings
    from unittest import mock

    import numpy as np

    from gennerf_tpu_torch.data.datamodule import ScannetDataModule
    from gennerf_tpu_torch.data.synthetic import ring_frames
    from gennerf_tpu_torch.models.backbone3d import DropoutDraws
    from gennerf_tpu_torch.models.voxel_net import VolumeRepr, VoxelNet
    from gennerf_tpu_torch.ops import grid_decode as grid_decode_module
    from gennerf_tpu_torch.ops import kernels
    from gennerf_tpu_torch.ops import sampling as sampling_module
    from gennerf_tpu_torch.ops.projection import get_3d_points
    from gennerf_tpu_torch.predict import build_model, reconstruct
    from gennerf_tpu_torch.train.predict import dense_grid_points, uses_grid_decode
    from gennerf_tpu_torch.train.state import make_optimizer
    from gennerf_tpu_torch.train.step import batch_to_device, forward_loss, train_step

    t_phase = time.perf_counter()
    totals = {k.name: 0 for k in kernels.KERNELS}
    errors = {"fps": 0.0, "grid_decode": 0.0, "point_decode": 0.0}
    cpu = torch.device("cpu")

    def first_batch(data_cfg, frames=None):
        batch = batch_to_device(next(iter(ScannetDataModule(data_cfg, seed=SEED)
                                          .train_dataloader())), dev)
        if frames:
            batch = {k: v[:, :frames] if v.dim() > 2 and k in FRAME_KEYS else v
                     for k, v in batch.items()}
        return batch

    def held_out_view(data_cfg):
        scene_batch = next(iter(ScannetDataModule(data_cfg, seed=SEED).predict_dataloader()))
        return {k: torch.as_tensor(np.asarray(scene_batch[k][0])).to(dev) for k in FRAME_KEYS}

    sampled, decoded = [], []
    recording_k1 = recorded(sampling_module.fps_cuda, sampled)
    recording_k2 = recorded(grid_decode_module.grid_decode_cuda, decoded)

    def recording():
        stack = contextlib.ExitStack()
        stack.enter_context(mock.patch.object(sampling_module, "fps_cuda", recording_k1))
        stack.enter_context(mock.patch.object(grid_decode_module, "grid_decode_cuda",
                                              recording_k2))
        return stack

    def kernels_vs_plain(bound):
        """Each recorded K1 launch against the plain FPS (index
        mismatches) and each K2 launch against the plain bf16-feed decode
        of its tables (max and mean error, the live share of its field)."""
        k1 = [int((out != sampling_module.farthest_point_sample_plain(xyz, n, s)).sum())
              for xyz, n, s, out in sampled]
        k2 = []
        for tables, weights, out in decoded:
            err = (out - grid_decode_module.separable_grid_decode_plain(
                tables, weights, bf16_feeds=True)).abs()
            k2.append({"max_abs_err": float(err.max()), "mean_abs_err": float(err.mean()),
                       "live_share": float((out.abs() < FIELD_LIVE * bound).double().mean())})
        sampled.clear()
        decoded.clear()
        if k1:
            errors["fps"] = max(errors["fps"], float(max(k1)))
        for r in k2:
            errors["grid_decode"] = max(errors["grid_decode"], r["max_abs_err"])
        return k1, k2

    def k2_ok(name, runs):
        return all([grid_gates(name, r["max_abs_err"], r["mean_abs_err"])
                    & gate(f"{name}.live_share", r["live_share"], FIELD_MIN_LIVE_SHARE, "min")
                    for r in runs])

    def k3_view(name, model, view, box_dim):
        """A held-out view through K3 (counted) against the plain march,
        and K3 against its plain bf16-feed version on 2^18 points in the
        march's box (a comparison, not counted), on the field centred on
        the view's measured surface (so that its rays cross zero)."""
        mcfg = model.cfg
        kernels.reset_launch_counts()
        with torch.no_grad():
            repr_ = model.encode(view["projection"][None], view["image"][None],
                                 view["depth"][None], torch.Generator().manual_seed(SEED))
        torch.cuda.synchronize()
        encode_launches = read_launches(totals)
        surface = get_3d_points(view["depth"][:1], view["projection"][:1]).reshape(-1, 3)
        shift = center_field(torch, model, repr_, surface[view["depth"][0].reshape(-1) > 0])
        box_pts = dense_grid_points(box_dim, mcfg.voxel_size, (0, 0, 0), dev)
        pts = box_pts[torch.randperm(box_pts.shape[0], generator=torch.Generator().manual_seed(
            SEED))[:N_POINTS // 4].to(dev)]
        points = k3_points(torch, model, repr_, pts)
        kernels.reset_launch_counts()
        rec = k3_march(torch, model, repr_, view["depth"], view["intrinsics"], view["pose"])
        launches = read_launches(totals)
        rec.update(points, planes_dtype=str(repr_.planes["xz"].dtype), field_shift=shift,
                   encode_launches=encode_launches, launches=launches)
        errors["point_decode"] = max(errors["point_decode"], rec["max_abs_err"])
        if not (launches["point_decode"] >= 1 and launches["fps"] == 0
                and point_gates(f"{name}.k3", rec) & march_gates(f"{name}.k3_march", rec)):
            raise RuntimeError(f"K3 on a bf16 option model: {rec}")
        return rec

    class RecordedDropout(DropoutDraws):
        """The keep masks drawn from a generator, kept to inject elsewhere."""

        def __init__(self, p, generator):
            super().__init__(p, None, generator)
            self.drawn = []

        def next(self, shape, device):
            mask = super().next(shape, device)
            self.drawn.append(mask)
            return mask

    def same_steps_f32(cfg_, batch, step_draws, states, key):
        """The float32 forward of each bf16 step on that step's weights,
        batch and draws (no_grad, training mode; a comparison, not
        counted): metric `key` of each."""
        m32 = build_model(cfg_, dev, SEED).train()
        out = []
        for d, state in zip(step_draws, states):
            m32.load_state_dict(state)
            with torch.no_grad():
                out.append(float(forward_loss(m32, batch, draws=d)[1][key]))
        kernels.reset_launch_counts()
        return out

    # (a) VoxelNet with GroupNorm and dropout, in its bf16-mixed, then with
    # the loss split 'none'
    vrec = {}
    for split in ("pred", "none"):
        vcfg = experiment_config(VOXELNET_EXPERIMENT, [
            f"paths.data_dir={root}", *VOXELNET_OPTIONS,
            *(["model.heads.tsdf.loss_split=none"] if split == "none" else [])])
        precision = str(vcfg["trainer"]["precision"])
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            vmodel = build_model(vcfg["model"], dev, SEED, precision).train()
        vc = vmodel.cfg
        if not (isinstance(vmodel, VoxelNet) and vmodel.dtype == torch.bfloat16
                and vc.backbone3d.norm == "GN" and vc.backbone3d.drop == VOXELNET_DROP
                and vc.heads.tsdf_loss_split == split and vc.backbone3d.channels == (32, 64, 128)
                and not [w for w in caught if issubclass(w.category, UserWarning)]):
            raise RuntimeError(f"not the GN + dropout VoxelNet: {precision}, {vc}, "
                               f"{[str(w.message) for w in caught]}")
        init = {k: v.detach().clone() for k, v in vmodel.state_dict().items()}
        batch = first_batch(vcfg["data"])
        opt = make_optimizer(vmodel.parameters(), vc.optimizer)
        gen = torch.Generator(device=dev).manual_seed(SEED)
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        losses = [float(train_step(vmodel, opt, batch, gen)["tsdf_loss"])
                  for _ in range(OPTIONS_STEPS)]
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) * 1e3 / OPTIONS_STEPS
        vmodel.eval()
        view = held_out_view(vcfg["data"])
        vol = reconstruct(vmodel, view["projection"], view["image"], view["depth"])
        torch.cuda.synchronize()
        launches = read_launches(totals)
        rec = {"losses": losses, "step_ms": step_ms, "launches": launches,
               "predict": {"voxel_dim": list(vol.shape),
                           "finite": bool(torch.isfinite(vol).all()),
                           "abs_max": float(vol.abs().max())}}
        if not (all(map(math.isfinite, losses)) and launches == {k: 0 for k in launches}
                and rec["predict"]["finite"] and tuple(vol.shape) == vc.voxel_dim_test
                and rec["predict"]["abs_max"] <= vc.heads.tsdf_label_smoothing):
            raise RuntimeError(f"the GN + dropout VoxelNet ({split}): {rec}")
        if split == "pred":
            # bf16 against float32: the same weights, batch and masks
            targets = {k: batch[k] for k in ("vol_%02d_tsdf" % vs for vs in vc.voxel_sizes)}
            m16 = build_model(vc, dev, SEED, precision).train()
            m16.load_state_dict(init)
            m32 = build_model(vc, dev, SEED).train()
            m32.load_state_dict(init)
            drawn = RecordedDropout(vc.backbone3d.drop, torch.Generator(device=dev).manual_seed(
                SEED + 1))
            with torch.no_grad():
                loss16 = float(sum(m16(batch["projection"], batch["image"], vc.voxel_dim_train,
                                       None, targets, drawn)[1].values()))
                loss32 = float(sum(m32(batch["projection"], batch["image"], vc.voxel_dim_train,
                                       None, targets, DropoutDraws(vc.backbone3d.drop,
                                                                   drawn.drawn))[1].values()))
            rec["bf16_vs_f32"] = {"loss16": loss16, "loss32": loss32,
                                  "rel": abs(loss16 - loss32) / abs(loss32),
                                  "masks": len(drawn.drawn),
                                  "keep_share": float(torch.cat([m.reshape(-1) for m in
                                                                 drawn.drawn]).double().mean())}
            del m16
            # float32 on the card against the CPU (OTHER_FRAMES frames): the
            # CPU's volume refined on both with the card's masks, the loss
            # and the first step's 3D backbone and head gradients, each
            # held to a float64 step on the CPU as the option groups'
            small = {k: v[:, :OTHER_FRAMES] if v.dim() > 2 and k in FRAME_KEYS else v
                     for k, v in batch.items()}
            mcpu = build_model(vc, cpu, SEED).train()
            mcpu.load_state_dict({k: v.cpu() for k, v in init.items()})
            with torch.no_grad():
                volume = mcpu.encode(small["projection"].cpu(), small["image"].cpu(),
                                     vc.voxel_dim_train)
            drawn = RecordedDropout(vc.backbone3d.drop, torch.Generator(device=dev).manual_seed(
                SEED + 2))
            steps = {}
            m64 = VoxelNet(vc).to(torch.float64).train()
            m64.load_state_dict({k: v.cpu().double() for k, v in init.items()})
            for name, m, device, dt in (("card", m32, dev, torch.float32),
                                        ("cpu", mcpu, cpu, torch.float32),
                                        ("cpu_f64", m64, cpu, torch.float64)):
                m.zero_grad(set_to_none=True)
                masks = drawn if name == "card" else DropoutDraws(vc.backbone3d.drop,
                                                                  drawn.drawn)
                with deterministic_algorithms(torch):
                    _, ls = m.refine(VolumeRepr(*(t.to(device, dt) for t in volume)),
                                     {k: v.to(device, dt) for k, v in targets.items()}, masks)
                    loss = sum(ls.values())
                    loss.backward()
                steps[name] = (float(loss.detach()), {k: p.grad.detach().cpu().double()
                                             for k, p in m.named_parameters()
                                             if p.grad is not None})
            del m32, mcpu, m64

            def to_f64(name):
                g64 = steps["cpu_f64"][1]
                errs = {k: float((steps[name][1][k] - g).abs().max())
                        / max(float(g.abs().max()), 1e-30) for k, g in g64.items()}
                worst = max(errs, key=errs.get)
                return errs[worst], worst

            rec["card_vs_cpu_f32"] = {
                "frames": OTHER_FRAMES, "masks": len(drawn.drawn),
                "loss_card": steps["card"][0], "loss_cpu": steps["cpu"][0],
                "loss_rel_err": abs(steps["card"][0] - steps["cpu"][0]) / abs(steps["cpu"][0]),
                "grads": len(steps["cpu_f64"][1]),
                "grad_vs_f64_over_max_abs": {"card": to_f64("card"), "cpu": to_f64("cpu")}}
            dist = rec["card_vs_cpu_f32"]["grad_vs_f64_over_max_abs"]
            if not (gate(f"voxelnet_{split}.bf16_loss_rel", rec["bf16_vs_f32"]["rel"],
                         OPTIONS_BF16_LOSS_RTOL)
                    & gate(f"voxelnet_{split}.device_loss_rel",
                           rec["card_vs_cpu_f32"]["loss_rel_err"], OPTIONS_DEVICE_RTOL)
                    & gate(f"voxelnet_{split}.grad_vs_f64", dist["card"][0],
                           max(TRAIN_GRAD_TOL, EIKONAL_NOISE_FACTOR * dist["cpu"][0]))):
                raise RuntimeError(f"the GN + dropout VoxelNet against float32 and the CPU: "
                                   f"{rec}")
        vrec[split] = rec
        del vmodel, opt, batch, vol

    # (b) the spatial encoder's norm_type and upsample options on
    # seqs_multigeo_spatial (OTHER_FRAMES frames of its loader batch)
    scfg = experiment_config(SPATIAL_EXPERIMENT, [f"paths.data_dir={root}"])
    sbatch = first_batch(scfg["data"], frames=OTHER_FRAMES)
    base = None
    srec = {}
    kernels.reset_launch_counts()
    for norm_type in ("batch", "sync_batch", "instance"):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            smodel = build_model(experiment_config(SPATIAL_EXPERIMENT, [
                f"paths.data_dir={root}", f"model.encoder.spatial.norm_type={norm_type}"])["model"],
                dev, SEED)
        warned = [str(w.message) for w in caught if "norm_type" in str(w.message)]
        if base is None:
            draws = ray_draws(torch, dev, smodel.cfg, sbatch, SEED + 4)
            state = smodel.state_dict()
        smodel.load_state_dict(state)
        with torch.no_grad(), deterministic_algorithms(torch):
            r = smodel.encode(sbatch["projection"], sbatch["image"], sbatch["depth"],
                              sel=draws.sel, start=draws.start,
                              voxel_dim=smodel.cfg.voxel_dim_train)
        if base is None:
            base = r
        srec[norm_type] = {"warned": warned,
                           "equal_to_batch": bool(torch.equal(r.volume, base.volume) and all(
                               torch.equal(r.planes[k], v) for k, v in base.planes.items()))}
        del smodel, r
    srec["launches"] = read_launches(totals)
    # one layer without a resize: the stem's map alone, card against CPU on
    # the CPU's sparse points
    ucfg = experiment_config(SPATIAL_EXPERIMENT, [
        f"paths.data_dir={root}", "model.encoder.spatial.num_layers=1",
        "model.encoder.spatial.upsample_interp=nearest"])
    umodel = build_model(ucfg["model"], dev, SEED)
    ucpu = build_model(ucfg["model"], cpu, SEED)
    ucpu.load_state_dict({k: v.cpu() for k, v in umodel.state_dict().items()})
    same = same_sparse(torch, dev, umodel.cfg, sbatch, draws)
    outs = {}
    for device, m in ((dev, umodel), (cpu, ucpu)):
        b = {k: v.to(device) for k, v in sbatch.items()}
        d = to_device(draws, device)
        with torch.no_grad(), same():
            r = m.encode(b["projection"], b["image"], b["depth"], sel=d.sel, start=d.start,
                         voxel_dim=m.cfg.voxel_dim_train)
        outs[device.type] = {"volume": r.volume.cpu(), **{k: v.cpu() for k, v in r.planes.items()}}
    urec = {}
    for k, v in outs["cpu"].items():
        err = (outs[dev.type][k] - v).abs()
        urec[k] = {"max_rel": float(err.max()) / float(v.abs().max()),
                   "share_within": float((err <= OPTIONS_DEVICE_RTOL * v.abs().max())
                                         .double().mean())}
    srec["nearest_one_layer"] = {"d_in": umodel.cfg.encoder_latent, "card_vs_cpu": urec}
    del umodel, ucpu, outs
    if not (srec["sync_batch"]["equal_to_batch"] and srec["instance"]["equal_to_batch"]
            and not srec["batch"]["warned"] and not srec["sync_batch"]["warned"]
            and len(srec["instance"]["warned"]) == 1
            and srec["launches"] == {"fps": 3, "grid_decode": 0, "point_decode": 0}
            and all([gate(f"nearest_one_layer.{k}_share_within", r["share_within"],
                          VOXELNET_DEVICE_SHARE, "agree") if k == "volume"
                     else gate(f"nearest_one_layer.{k}_rel", r["max_rel"], OPTIONS_DEVICE_RTOL)
                     for k, r in urec.items()])):
        raise RuntimeError(f"the spatial options: {srec}")

    # (c) the GenNerf options in bf16-mixed at the flagship's widths
    data_overrides = flagship_overrides(root)
    frames = [torch.from_numpy(a).to(dev) for a in ring_frames(
        NUM_FRAMES, HEIGHT, WIDTH, SCENE_CENTER, PRIMITIVES, seed=SEED)]
    grec = {}
    for group, overrides in BF16_OPTION_GROUPS.items():
        gcfg = experiment_config(FLAGSHIP_EXPERIMENT, [
            f"paths.data_dir={root}", *data_overrides, *(f"model.{o}" for o in overrides)])
        precision = str(gcfg["trainer"]["precision"])
        g16 = build_model(gcfg["model"], dev, SEED, precision).train()
        gc = g16.cfg
        if not (g16.dtype == torch.bfloat16 and gc.encoder.pointnet.c_dim == 64
                and gc.encoder.pointnet.plane_resolution == 128
                and gc.encoder.pointnet.num_sparse_points == 512):
            raise RuntimeError(f"not the flagship's widths in bf16: {precision}, {gc}")
        voxel_hash = gc.encoder.pointnet.sparsifier == "voxel_hash"
        init = {k: v.detach().clone() for k, v in g16.state_dict().items()}
        batch = first_batch(gcfg["data"])
        B, T, H, W = batch["depth"].shape
        step_draws = []
        for i in range(OPTIONS_STEPS):
            d = ray_draws(torch, dev, gc, batch, SEED + 40 + i)
            if voxel_hash:
                g = torch.Generator(device=dev).manual_seed(SEED + 50 + i)
                d = d._replace(start=torch.rand((B * T, gc.encoder.pointnet.fps_presample),
                                                generator=g, device=dev))
            step_draws.append(d)
        opt = make_optimizer(g16.parameters(), gc.optimizer)
        states = []
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        with recording():
            losses16 = []
            for d in step_draws:
                states.append({k: v.detach().clone() for k, v in g16.state_dict().items()})
                losses16.append(float(train_step(g16, opt, batch, draws=d)["combined"]))
            torch.cuda.synchronize()
            step_ms = (time.perf_counter() - t0) * 1e3 / OPTIONS_STEPS
            step_launches = read_launches(totals)
            step_k1, _ = kernels_vs_plain(gc.mlp.head_smoothing)
        losses32 = same_steps_f32(gc, batch, step_draws, states, "combined")
        del opt, states
        g16.eval()
        rel = [abs(a - b) / abs(b) for a, b in zip(losses16, losses32)]
        rec = {"overrides": list(overrides), "step_ms": step_ms, "step_launches": step_launches,
               "losses_bf16": losses16, "losses_f32_same_weights": losses32,
               "loss_rel": rel, "k1_index_mismatches": step_k1,
               "route": "grid_decode" if uses_grid_decode(g16) else "decode_dense"}
        if group == "iii":
            # the learned merger's merge of two bf16 encodes
            with torch.no_grad():
                r = g16.encode(*(f[None] for f in frames), torch.Generator().manual_seed(SEED))
                merged = g16.merge(r, r).planes
            rec["merge"] = {k: {"dtype": str(v.dtype), "finite": bool(torch.isfinite(v).all())}
                            for k, v in merged.items()}
            rec["field_shift"] = center_field(torch, g16, r, dense_grid_points(
                FLAGSHIP_GRID, gc.voxel_size, (0, 0, 0), dev)[::7])
            del r, merged
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        with recording():
            vol = reconstruct(g16, *frames, FLAGSHIP_GRID, torch.Generator().manual_seed(SEED))
            torch.cuda.synchronize()
            rec["reconstruct_ms"] = (time.perf_counter() - t0) * 1e3
            rec["reconstruct_launches"] = read_launches(totals)
            recon_k1, recon_k2 = kernels_vs_plain(gc.mlp.head_smoothing)
        rec.update(k2_vs_plain=recon_k2, reconstruct_k1_mismatches=recon_k1,
                   volume_finite=bool(torch.isfinite(vol).all()))
        del vol
        expect_fps = 0 if voxel_hash else 1
        expect_k2 = 1 if group == "iii" else 0
        if group == "iii":
            rec["view"] = k3_view(f"group_{group}", g16, held_out_view(gcfg["data"]),
                                  gc.voxel_dim_test)
        grec[group] = rec
        if not (all([gate(f"group_{group}.bf16_loss_rel_step{i}", r_, OPTIONS_BF16_LOSS_RTOL)
                     for i, r_ in enumerate(rel)])
                and step_launches == {"fps": expect_fps * OPTIONS_STEPS, "grid_decode": 0,
                                      "point_decode": 0}
                and len(step_k1) == expect_fps * OPTIONS_STEPS and not any(step_k1)
                and rec["reconstruct_launches"] == {"fps": expect_fps, "grid_decode": expect_k2,
                                                    "point_decode": 0}
                and not any(recon_k1) and rec["route"] == ("grid_decode" if expect_k2
                                                           else "decode_dense")
                and rec["volume_finite"] and k2_ok(f"group_{group}.k2", recon_k2)
                and all(v["dtype"] == "torch.bfloat16" and v["finite"]
                        for v in rec.get("merge", {}).values())):
            raise RuntimeError(f"bf16 option group {group}: {rec}")
        del g16, batch, init

    # (d) distillation in bf16-mixed: both modes' steps against float32, K2
    # and K3 on the bf16 surface model's d_geo-64 head, a use_auxiliary step
    drec = {}
    for name, path in (("surface", DISTILL_EXPERIMENT), ("render", DISTILL_RENDER_EXPERIMENT)):
        dcfg = experiment_config(path, [f"paths.data_dir={synth_root}",
                                        "trainer.precision=bf16-mixed"])
        d16 = build_model(dcfg["model"], dev, SEED, "bf16-mixed").train()
        dc = d16.cfg
        if not (d16.dtype == torch.bfloat16 and d16.teacher is not None
                and dc.loss.distill.mode == name and dc.mlp.d_out_geo == 64
                and uses_grid_decode(d16)):
            raise RuntimeError(f"not the bf16 {name} distillation model: {dc}")
        init = {k: v.detach().clone() for k, v in d16.state_dict().items()}
        batch = first_batch(dcfg["data"])
        B, T, H, W = batch["depth"].shape
        step_draws = []
        for i in range(OPTIONS_STEPS):
            g = torch.Generator(device=dev).manual_seed(SEED + 60 + i)
            step_draws.append(ray_draws(torch, dev, dc, batch, SEED + 60 + i)._replace(
                render_scores=torch.argsort(torch.rand((B * T, H * W), generator=g, device=dev),
                                            dim=1).to(torch.float32) / (H * W)))
        opt = make_optimizer(d16.parameters(), dc.optimizer)
        states = []
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        metrics16 = []
        for d in step_draws:
            states.append({k: v.detach().clone() for k, v in d16.state_dict().items()})
            metrics16.append({k: float(v) for k, v in train_step(d16, opt, batch,
                                                                 draws=d).items()})
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) * 1e3 / OPTIONS_STEPS
        step_launches = read_launches(totals)
        distill32 = same_steps_f32(dc, batch, step_draws, states, "distill")
        del opt, states
        rel = [abs(a["distill"] - b) / abs(b) for a, b in zip(metrics16, distill32)]
        rec = {"step_ms": step_ms, "step_launches": step_launches,
               "train_distill_bf16": [m_["distill"] for m_ in metrics16],
               "train_distill_f32_same_weights": distill32, "distill_rel": rel,
               "combined_bf16": [m_["combined"] for m_ in metrics16]}
        if name == "render":
            rec["render_hit_rate"] = [m_["render_hit_rate"] for m_ in metrics16]
        if not (all([gate(f"{name}.bf16_distill_rel_step{i}", r_, OPTIONS_BF16_LOSS_RTOL)
                     for i, r_ in enumerate(rel)])
                and step_launches == {"fps": OPTIONS_STEPS, "grid_decode": 0, "point_decode": 0}
                and all(math.isfinite(v) for m_ in metrics16 for v in m_.values())):
            raise RuntimeError(f"bf16 {name} distillation: {rec}")
        if name == "surface":
            # K2 on the d_geo-64 head: reconstruct of the scene's test
            # frames on the field centred on the test grid
            d16.eval()
            view = held_out_view(dcfg["data"])
            scene = (view["projection"], view["image"], view["depth"])
            with torch.no_grad():
                r = d16.encode(*(f[None] for f in scene), torch.Generator().manual_seed(SEED))
            rec["field_shift"] = center_field(torch, d16, r, dense_grid_points(
                dc.voxel_dim_test, dc.voxel_size, (0, 0, 0), dev))
            del r
            kernels.reset_launch_counts()
            with recording():
                vol = reconstruct(d16, *scene, None, torch.Generator().manual_seed(SEED))
                torch.cuda.synchronize()
                rec["reconstruct_launches"] = read_launches(totals)
                recon_k1, recon_k2 = kernels_vs_plain(dc.mlp.head_smoothing)
            rec.update(k2_vs_plain=recon_k2, reconstruct_k1_mismatches=recon_k1,
                       volume_finite=bool(torch.isfinite(vol).all()))
            rec["view"] = k3_view(name, d16, view, dc.voxel_dim_test)
            if not (rec["reconstruct_launches"] == {"fps": 1, "grid_decode": 1,
                                                    "point_decode": 0}
                    and not any(recon_k1) and rec["volume_finite"]
                    and k2_ok(f"{name}.k2", recon_k2)):
                raise RuntimeError(f"K2 on the bf16 distillation head: {rec}")
            del vol
        drec[name] = rec
        del d16, batch, init
    acfg = experiment_config(DISTILL_EXPERIMENT, [f"paths.data_dir={synth_root}",
                                                  "trainer.precision=bf16-mixed", *AUX_OVERRIDES])
    aux = build_model(acfg["model"], dev, SEED, "bf16-mixed").train()
    abatch = first_batch(acfg["data"])
    aopt = make_optimizer(aux.parameters(), aux.cfg.optimizer)
    kernels.reset_launch_counts()
    ametrics = train_step(aux, aopt, abatch, torch.Generator(device=dev).manual_seed(SEED))
    torch.cuda.synchronize()
    drec["use_auxiliary"] = {"d_in": aux.cfg.encoder_latent, "launches": read_launches(totals),
                             "metrics": {k: float(v) for k, v in ametrics.items()},
                             "route": "grid_decode" if uses_grid_decode(aux) else "decode_dense"}
    with torch.no_grad():
        aloss32 = float(forward_loss(build_model(aux.cfg, dev, SEED).train(), abatch,
                                     torch.Generator(device=dev).manual_seed(SEED))[0])
    a = drec["use_auxiliary"]
    a.update(loss_f32_same_draws=aloss32,
             loss_rel=abs(a["metrics"]["combined"] - aloss32) / abs(aloss32))
    del aux, aopt, abatch
    if not (a["launches"] == {"fps": 1, "grid_decode": 0, "point_decode": 0}
            and gate("use_auxiliary.bf16_loss_rel", a["loss_rel"], OPTIONS_BF16_LOSS_RTOL)
            and a["route"] == "decode_dense" and "distill" in a["metrics"]
            and all(map(math.isfinite, a["metrics"].values()))):
        raise RuntimeError(f"the bf16 use_auxiliary step: {a}")

    emit({"phase": "model_options",
          "configs": {"voxelnet": "configs/experiment/seqs_multigeo_voxelnet.yaml",
                      "spatial": "configs/experiment/seqs_multigeo_spatial.yaml",
                      "bf16_groups": "configs/experiment/seq1_frames8_evenspaced_pointnet.yaml",
                      "distill": ["configs/experiment/distill_synthetic.yaml",
                                  "configs/experiment/distill_render_synthetic.yaml"]},
          "voxelnet": {"overrides": list(VOXELNET_OPTIONS), **vrec}, "spatial": srec,
          "bf16_groups": grec, "distill_bf16": drec,
          "tolerance": {"bf16_loss_rel": OPTIONS_BF16_LOSS_RTOL,
                        "card_vs_cpu_rel": OPTIONS_DEVICE_RTOL,
                        "volume_share": VOXELNET_DEVICE_SHARE,
                        "grad_vs_f64": {"tol": TRAIN_GRAD_TOL,
                                        "cpu_factor": EIKONAL_NOISE_FACTOR},
                        "grid": {"max_abs": GRID_MAX_ABS_TOL, "mean_abs": GRID_MEAN_ABS_TOL},
                        "point": {"max_abs": POINT_MAX_ABS_TOL, "mean_abs": POINT_MEAN_ABS_TOL},
                        "render": {"mask_agree": RENDER_MASK_AGREE, "depth_m": RENDER_DEPTH_TOL,
                                   "depth_agree": RENDER_DEPTH_AGREE,
                                   "min_hit_share": RENDER_MIN_HIT_SHARE},
                        "min_live_share": FIELD_MIN_LIVE_SHARE},
          "phase_s": time.perf_counter() - t_phase, "card": smi})
    return totals, errors


def prepare_phase(torch, dev, smi: str, work: str) -> tuple:
    """Phase 16 (see the module docstring): raw ScanNet in, ground truth out,
    then the flagship trained on it. Returns the launch counts of the
    main-path runs (the fit with its validation, the reconstruct at the
    flagship's grid, the rendered view) and each kernel's largest error
    against its plain version in the phase."""
    GATES.phase = "prepare"
    from unittest import mock

    import numpy as np

    from gennerf_tpu_torch.data.colormaps import NYU40_COLORMAP
    from gennerf_tpu_torch.data.datamodule import ScannetDataModule
    from gennerf_tpu_torch.data.datasets import load_info_json
    from gennerf_tpu_torch.data.prepare import prepare_data
    from gennerf_tpu_torch.data.prepare.sensor_data import SensorData
    from gennerf_tpu_torch.data.prepare.synthetic_scannet import COLOR_SIZE, DEPTH_SIZE, write_scene
    from gennerf_tpu_torch.ops import grid_decode as grid_decode_module
    from gennerf_tpu_torch.ops import kernels
    from gennerf_tpu_torch.ops.projection import get_3d_points
    from gennerf_tpu_torch.ops.sampling import (
        farthest_point_sample_plain, fps_cuda, uniform_presample,
    )
    from gennerf_tpu_torch.predict import build_model, reconstruct
    from gennerf_tpu_torch.tools import build_scannet, read_scannet
    from gennerf_tpu_torch.tools.measure import FPS_INNER, cuda_ms
    from gennerf_tpu_torch.train.predict import dense_grid_points
    from gennerf_tpu_torch.train.step import batch_to_device
    from gennerf_tpu_torch.tsdf.fusion import TSDFFusion
    from gennerf_tpu_torch.tsdf.tsdf import TSDF
    from gennerf_tpu_torch.data.transforms import ResizeImage
    from gennerf_tpu_torch.utils.image import decode_jpeg, read_jpeg, read_png
    from gennerf_tpu_torch.utils.mesh import Mesh

    totals = {k.name: 0 for k in kernels.KERNELS}

    t_phase = time.perf_counter()
    raw, export, data = (os.path.join(work, d) for d in ("raw", "export", "data"))
    scene = f"scans/{PREPARE_SCENE}"
    scene_dir = os.path.join(data, scene)
    cpu = torch.device("cpu")

    # 1. the raw scene through the port's .sens writer
    written = write_scene(raw, PREPARE_SCENE, PREPARE_FRAMES, seed=SEED,
                          threads=os.cpu_count() or 1)
    # 2. exported into archives, unpacked, prepared with fusion on the card
    with contextlib.redirect_stdout(io.StringIO()):
        t0 = time.perf_counter()
        read_scannet.main(["--path", raw, "--output", export, "--workers", "1", "--tar"])
        export_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        build_scannet.main(["--source", export, "--target", data, "--workers", "1"])
        build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    stages = prepare_data.prepare_scannet(data, data, max_depth=PREPARE_MAX_DEPTH, verbose=0,
                                          voxel_sizes=PREPARE_VOXEL_SIZES, device=dev)[scene]
    prepare_s = time.perf_counter() - t0
    info = load_info_json(os.path.join(scene_dir, "info.json"))
    splits = sorted(f for f in os.listdir(data) if f.endswith(".txt"))

    # 3. the exports: depth lossless, colour within the bound of the render
    sens = SensorData(written["sens"])
    if not (len(info["frames"]) == PREPARE_FRAMES and "file_name_image_temp" not in
            info["frames"][0] and all(f"file_name_vol_{vs:02d}" in info
                                      for vs in PREPARE_VOXEL_SIZES)):
        raise RuntimeError(f"prepare_scannet's info.json: {sorted(info)}, "
                           f"{len(info['frames'])} frames")

    def psnr(a, b):
        mse = float(np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2))
        return 10 * math.log10(255.0 ** 2 / mse) if mse else math.inf

    depth_equal, psnr_db, generation_db = 0, [], []
    for t, frame in enumerate(info["frames"]):
        depth_equal += int(np.array_equal(read_png(frame["file_name_depth"]),
                                          written["depth_mm"][t]))
        exported = read_jpeg(frame["file_name_image"])
        first = sens.frames[t].decompress_color(sens.color_compression_type)
        psnr_db.append(psnr(exported, written["color"][t]))
        generation_db.append(psnr(first, written["color"][t]) - psnr_db[-1])
    with open(info["frames"][0]["file_name_image"], "rb") as f:
        jpeg_bytes = f.read()
    decode_ms = host_ms(torch, lambda: decode_jpeg(jpeg_bytes), 20)
    # the loaders' pad (1296x968 -> 1296x972) and bilinear reduction to
    # 640x480 of that frame, in the host library
    reduce_ms = host_ms(torch, lambda: ResizeImage((640, 480))({"frames": [
        {"image": exported, "intrinsics": np.eye(3, dtype=np.float32)}]}), 20)
    exports = {"depth_frames_equal": depth_equal, "psnr_db_min": min(psnr_db),
               "psnr_db_median": statistics.median(psnr_db),
               "second_generation_db_max": max(generation_db),
               "color_shape": list(exported.shape)}
    if not (depth_equal == PREPARE_FRAMES
            and gate("export.psnr_db", min(psnr_db), PREPARE_PSNR_MIN, "min_db")
            & gate("export.second_generation_db", max(generation_db), PREPARE_GENERATION_DB)
            and tuple(exported.shape[:2]) == COLOR_SIZE):
        raise RuntimeError(f"the exported frames: {exports}")

    # 4. the fused volumes: each voxel size fused again on the card from the
    # prepared frames (loaded once), timed, equal to the volume prepare wrote;
    # 16 cm against the CPU; the 4 cm mesh; a labelled fusion's semseg mesh
    dataset = prepare_data.scene_frames(os.path.join(scene_dir, "info.json"))
    t0 = time.perf_counter()
    frames = list(prepare_data.prefetch(dataset, range(len(dataset))))
    load_s = time.perf_counter() - t0
    card_frames = [prepare_data.frame_tensors(f, PREPARE_MAX_DEPTH, dev) for f in frames]
    volumes, fusion_s, fused = {}, {}, {}
    for vs in PREPARE_VOXEL_SIZES:
        saved = TSDF.load(info[f"file_name_vol_{vs:02d}"])
        grid = (tuple(saved.tsdf_vol.shape), vs / 100, saved.origin.reshape(3))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fusion = TSDFFusion(*grid, color=True, device=dev)
        for P_, d_, im_ in card_frames:
            fusion.integrate(P_, d_, im_)
        torch.cuda.synchronize()
        fusion_s[vs] = time.perf_counter() - t0
        again = fusion.get_tsdf()
        volumes[vs] = {"voxel_dim": list(grid[0]), "origin": saved.origin.reshape(3).tolist(),
                       "band_share": float((saved.tsdf_vol.abs() < 1).double().mean()),
                       "same_as_prepared": bool(
                           torch.equal(again.tsdf_vol.cpu(), saved.tsdf_vol) and torch.equal(
                               again.attribute_vols["color"].cpu(),
                               saved.attribute_vols["color"]))}
        fused[vs] = (grid, fusion.state)
    grid16, card16 = fused[16]
    cpu_fusion = TSDFFusion(*grid16, color=True, device=cpu)
    for frame in frames:
        cpu_fusion.integrate(*prepare_data.frame_tensors(frame, PREPARE_MAX_DEPTH, cpu))
    cpu16 = cpu_fusion.state
    card_vs_cpu = {"weight_mismatches": int((card16.weight.cpu() != cpu16.weight).sum()),
                   "tsdf_mismatches": int((card16.tsdf.cpu() != cpu16.tsdf).sum()),
                   "color_mismatches": int((card16.color.cpu() != cpu16.color).sum()),
                   "touched_voxels": int((cpu16.weight > 0).sum())}
    mesh04 = Mesh.load(os.path.join(scene_dir, "mesh_04.ply"))
    mesh_rec = {"vertices": int(len(mesh04.vertices)), "faces": int(len(mesh04.faces)),
                "colours": 0 if mesh04.vertex_colors is None
                else int(len(np.unique(mesh04.vertex_colors, axis=0))),
                "faces_meshed_again": int(len(TSDF.load(info["file_name_vol_04"])
                                              .get_mesh().faces))}
    # labels: NYU40 classes 1-3 by each pixel's strongest colour channel
    semseg = TSDFFusion(*grid16, color=False, label=True, device=dev)
    for P_, d_, im_ in card_frames:
        semseg.integrate(P_, d_, None, (im_.argmax(0) + 1).to(torch.int32))
    sem_mesh = semseg.get_tsdf("semseg").get_mesh("semseg")
    palette = {tuple(c) for c in NYU40_COLORMAP}
    sem_colours = {tuple(int(v) for v in c) for c in sem_mesh.vertex_colors}
    mesh_rec.update(semseg_faces=int(len(sem_mesh.faces)), semseg_colours=len(sem_colours),
                    semseg_colours_in_palette=sem_colours <= palette)
    del card_frames, fused, card16, cpu16
    if not (all(v["same_as_prepared"] for v in volumes.values())
            and card_vs_cpu["weight_mismatches"] == card_vs_cpu["tsdf_mismatches"]
            == card_vs_cpu["color_mismatches"] == 0
            and mesh_rec["faces"] > 1000 and mesh_rec["colours"] > 10
            and mesh_rec["faces_meshed_again"] == mesh_rec["faces"]
            and mesh_rec["semseg_faces"] > 100 and mesh_rec["semseg_colours"] >= 2
            and mesh_rec["semseg_colours_in_palette"]):
        raise RuntimeError(f"the fused ground truth: {volumes}, {card_vs_cpu}, {mesh_rec}")

    # 5. the flagship at full width in bf16-mixed from the prepared JPEG
    # frames, through its own data keys (sequence_length cut to the scene)
    run_dir = os.path.join(work, "run")
    cfg = experiment_config(FLAGSHIP_EXPERIMENT, [
        f"paths.data_dir={data}", f"paths.output_dir={run_dir}",
        f"data.sequence_length={PREPARE_FRAMES}"])
    precision = str(cfg["trainer"]["precision"])
    model = build_model(cfg["model"], dev, SEED, precision)
    mcfg, p = model.cfg, model.cfg.encoder.pointnet
    trainer = make_trainer(torch, dev, model, cfg, run_dir, PREPARE_EPOCHS,
                           val_every=PREPARE_EPOCHS, precision=precision)
    opt = trainer.optimizer
    datamodule = ScannetDataModule(cfg["data"], seed=SEED)
    decoded = []
    recording_k2 = recorded(grid_decode_module.grid_decode_cuda, decoded)
    fit_s, fit_launches, encodes, _ = counted_run(
        torch, totals, lambda: trainer.fit(datamodule.train_dataloader(),
                                           datamodule.val_dataloader()),
        mock.patch.object(grid_decode_module, "grid_decode_cuda", recording_k2))
    steps = trainer.global_step
    n_eval, n_tail = encodes.count("eval_step"), encodes.count("reconstruct")
    tail_grid = recorded_k2_errors(decoded)
    fit_rec = {"precision": precision, "steps": steps, "eval_batches": n_eval, "tails": n_tail,
               "launches": fit_launches, "fit_s": fit_s,
               "step_ms": [t["step_ms"] for t in trainer.timings],
               "data_wait_ms": [t["data_wait_ms"] for t in trainer.timings],
               "metrics": dict(trainer.metrics),
               "tail_k2_vs_plain": {"max_abs": tail_grid[0], "mean_abs": tail_grid[1]}}
    if not (model.dtype == torch.bfloat16 and steps == PREPARE_EPOCHS
            and fit_launches["fps"] == steps + n_eval + n_tail
            and fit_launches["grid_decode"] == n_tail == 1
            and math.isfinite(fit_rec["metrics"].get("val_recon_tsdf_l1", math.nan))
            and grid_gates("k2_tail", *tail_grid[:2])):
        raise RuntimeError(f"the flagship fit on the prepared scene: {fit_rec}")

    # K1 against its plain version on a loader batch's clouds (a comparison)
    batch = batch_to_device(next(iter(datamodule.train_dataloader())), dev)
    B, Tn, H, W = batch["depth"].shape
    gen = torch.Generator().manual_seed(SEED)
    cloud = get_3d_points(batch["depth"].reshape(B * Tn, H, W),
                          batch["projection"].reshape(B * Tn, 3, 4)).reshape(B * Tn, -1, 3)
    xyz = uniform_presample(cloud, p.fps_presample, gen).contiguous()
    start = torch.randint(0, xyz.shape[1], (B * Tn,), generator=gen).to(dev, torch.int32)
    idx_k = fps_cuda(xyz, p.num_sparse_points, start)
    idx_p = farthest_point_sample_plain(xyz, p.num_sparse_points, start)
    k1_rec = {"shape": list(xyz.shape), "npoint": p.num_sparse_points,
              "plan": dict(kernels.FPS.last_launch),
              "index_mismatches": int((idx_k != idx_p).sum()),
              "ms": cuda_ms(torch, lambda: fps_cuda(xyz, p.num_sparse_points, start), reps=10,
                            inner=FPS_INNER)}
    if k1_rec["index_mismatches"] or list(batch["image"].shape[-2:]) != [480, 640]:
        raise RuntimeError(f"K1 on the prepared scene's batch: {k1_rec}, "
                           f"{list(batch['image'].shape)}")
    del batch, cloud, xyz

    # the scene's validation item (8 frames of 480x640, the volume centred on
    # the ground truth's extent, so the room lies in the 190x180x50 box; the
    # predict loader's offset would leave the floor at the 2 m box's top):
    # one reconstruct at the flagship's grid, the field centred there first
    # (K2 against the plain decode), then a view through K3 against the
    # plain march, the field centred on the march's box, and K3 against its
    # plain version there
    item = next(iter(datamodule.val_dataloader()))
    view = {k: torch.as_tensor(item[k][0]).to(dev) for k in FRAME_KEYS}
    model.eval()
    with torch.no_grad():
        repr_ = model.encode(view["projection"][None], view["image"][None], view["depth"][None],
                             torch.Generator().manual_seed(SEED))
    grid_pts = dense_grid_points(FLAGSHIP_GRID, mcfg.voxel_size, (0, 0, 0), dev)
    recon_shift = center_field(torch, model, repr_, grid_pts[::7])
    del grid_pts
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    with mock.patch.object(grid_decode_module, "grid_decode_cuda", recording_k2):
        vol = reconstruct(model, view["projection"], view["image"], view["depth"], FLAGSHIP_GRID,
                          torch.Generator().manual_seed(SEED))
    torch.cuda.synchronize()
    recon_ms = (time.perf_counter() - t0) * 1e3
    recon_launches = read_launches(totals)
    recon_grid = recorded_k2_errors(decoded)
    k2_rec = {"voxel_dim": list(FLAGSHIP_GRID), "launches": recon_launches,
              "reconstruct_ms": recon_ms, "field_shift": recon_shift,
              "max_abs_err": recon_grid[0], "mean_abs_err": recon_grid[1],
              "live_share": recon_grid[2], "negative_share": float((vol < 0).double().mean())}
    if not (recon_launches["grid_decode"] == 1 and recon_launches["fps"] == 1
            and bool(torch.isfinite(vol).all()) and grid_gates("k2_reconstruct", *recon_grid[:2])
            & gate("k2_reconstruct.live_share", recon_grid[2], FIELD_MIN_LIVE_SHARE, "min")):
        raise RuntimeError(f"K2 on the prepared scene: {k2_rec}")
    del vol
    box = np.array(mcfg.voxel_dim_test, np.float32) * mcfg.voxel_size
    render_shift = center_field(torch, model, repr_, dense_grid_points(
        mcfg.voxel_dim_test, mcfg.voxel_size, (0, 0, 0), dev)[::7])
    pts = torch.from_numpy(np.random.default_rng(SEED).uniform(0, box, (N_POINTS, 3))
                           .astype(np.float32)).to(dev)
    k3_rec = dict(k3_points(torch, model, repr_, pts), field_shift=render_shift)
    del pts
    if not point_gates("k3", k3_rec):
        raise RuntimeError(f"K3 on the prepared scene's planes: {k3_rec}")
    kernels.reset_launch_counts()
    render_rec = k3_march(torch, model, repr_, view["depth"], view["intrinsics"], view["pose"])
    render_launches = render_rec["launches"] = read_launches(totals)
    if not (render_launches["point_decode"] >= 1
            and render_rec["image"] == [DEPTH_SIZE[0], DEPTH_SIZE[1]]
            and march_gates("k3_march", render_rec)):
        raise RuntimeError(f"the view through K3 on the prepared scene: {render_rec}")
    del repr_, model, opt, trainer

    phase_s = time.perf_counter() - t_phase
    timing = {"phase": "prepare_timing", "sens_write_s": written["write_s"],
              "sens_render_s": written["render_s"],
              "export_ms_per_frame": export_s / PREPARE_FRAMES * 1e3,
              "jpeg_decode_ms_1296x968": decode_ms,
              "pad_and_reduce_ms_1296x968_to_640x480": reduce_ms,
              "fusion_s_on_card": {f"{vs}cm": s for vs, s in fusion_s.items()},
              "loader_wait_ms_median": statistics.median(fit_rec["data_wait_ms"]),
              "step_ms_median": statistics.median(fit_rec["step_ms"]),
              "phase_s": phase_s, "card": smi}
    emit({"phase": "prepare", "scene": scene, "frames": PREPARE_FRAMES,
          "color": list(COLOR_SIZE), "depth": list(DEPTH_SIZE),
          "reduced": {"frames": f"{PREPARE_FRAMES} (a ScanNet scene holds ~1,500)",
                      "data.sequence_length": f"{PREPARE_FRAMES} (the config's 710)",
                      "epochs": f"{PREPARE_EPOCHS} (the config's 300)"},
          "sens": {"render_s": written["render_s"], "write_s": written["write_s"],
                   "bytes": os.path.getsize(written["sens"])},
          "export_s": export_s, "build_s": build_s, "prepare_s": prepare_s,
          "prepare_stages_s": stages, "splits": splits, "exports": exports,
          "frames_load_s": load_s, "fusion_s": fusion_s, "volumes": volumes,
          "card_vs_cpu_16cm": card_vs_cpu, "meshes": mesh_rec, "fit": fit_rec,
          "k1": k1_rec, "k2_flagship_grid": k2_rec, "k3": k3_rec, "render": render_rec,
          "tolerance": {"psnr_db_min": PREPARE_PSNR_MIN,
                        "second_generation_db": PREPARE_GENERATION_DB,
                        "fusion_card_vs_cpu": "bit for bit",
                        "grid": {"max_abs": GRID_MAX_ABS_TOL, "mean_abs": GRID_MEAN_ABS_TOL},
                        "point": {"max_abs": POINT_MAX_ABS_TOL, "mean_abs": POINT_MEAN_ABS_TOL},
                        "render": {"mask_agree": RENDER_MASK_AGREE, "depth_m": RENDER_DEPTH_TOL,
                                   "depth_agree": RENDER_DEPTH_AGREE}},
          "card": smi})
    emit(timing)
    errors = {"fps": float((idx_k - idx_p).abs().max()),
              "grid_decode": max(tail_grid[0], recon_grid[0]),
              "point_decode": k3_rec["max_abs_err"]}
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

    import numpy as np

    from gennerf_tpu_torch.eval.metrics import DEPTH_METRICS
    from gennerf_tpu_torch.tsdf.tsdf import TSDF
    from gennerf_tpu_torch.utils.mesh import Mesh

    keys = DEPTH_METRICS + ("l1", "dist1", "dist2", "prec", "recal", "fscore")
    devices = set()

    class RecordingFusion(evaluation.TSDFFusion):
        def integrate(self, projection, depth):
            super().integrate(projection, depth)
            devices.update(t.device.type for t in (*self.state, projection, depth)
                           if t is not None)

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
            if not gate(f"eval.{scene}.{name}_vs_cpu", diff, EVAL_DEVICE_TOL):
                raise RuntimeError(f"{scene} {name}: the evaluation on {dev} and on the CPU "
                                   f"differ by {diff}: {metrics} against {on_cpu}")
        oracle = rec["oracle"]
        if at_edge(gate_margin(oracle["AbsRel"], ORACLE_ABSREL_MAX)):
            # where the oracle's depth error comes from: its mesh rendered
            # at the ground truth's views against the measured depth
            frames = evaluation.SceneDataset(info_file, frame_types=["depth"],
                                             from_archive=False)
            mesh = Mesh.load(os.path.join(oracle_dir, f"{scene}.ply"))
            pairs = []
            for i in range(len(frames)):
                f = frames[i]
                trgt = np.asarray(f["depth"], np.float32)
                pairs.append((evaluation.render_mesh_depth(mesh, f["intrinsics"], f["pose"],
                                                           *trgt.shape), trgt))
            rec["oracle_depth_breakdown"] = depth_error_breakdown(
                [np.where(p_ > 10.0, 0.0, p_) for p_, _ in pairs], [t_ for _, t_ in pairs])
        if not (gate(f"eval.{scene}.oracle_fscore", oracle["fscore"], ORACLE_FSCORE_MIN, "agree")
                & gate(f"eval.{scene}.oracle_absrel", oracle["AbsRel"], ORACLE_ABSREL_MAX)
                and oracle["l1"] == 0.0):
            raise RuntimeError(f"{scene}: the oracle evaluation fails its gates: {oracle}")
        out[scene] = rec
    if devices != {dev.type}:
        raise RuntimeError(f"the re-fusion ran on {devices}, not on {dev.type}")
    return out


def mesh_phase(torch, dev, model, frames, planes_ref, table_args: dict, smi: str):
    """Phase 4 (see the module docstring); returns the launch counts of
    the `reconstruct` it drives and the phase's record."""
    GATES.phase = "mesh"
    import tempfile

    import numpy as np

    from gennerf_tpu_torch.eval.metrics import eval_mesh
    from gennerf_tpu_torch.ops import kernels
    from gennerf_tpu_torch.ops.grid_decode import grid_tables, separable_grid_decode_plain
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
    weights = decoder_weights(model, point=False)
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
    if not gate("fscore", metrics["fscore"], MESH_FSCORE_MIN, "agree"):
        raise RuntimeError(f"K2's mesh disagrees with the plain mesh: {rec}")
    if not (np.array_equal(loaded.faces, mesh_k.faces)
            and np.array_equal(loaded.vertices, mesh_k.vertices.astype(np.float32))):
        raise RuntimeError("the PLY did not load back as written")
    return launches, rec


# -- 18. parallel ------------------------------------------------------------------

# one data-parallel step against world size 1 on the same global batch of
# PARALLEL_BATCH loader items, at the CPU tests' bounds (tests/test_torch_
# parallel_step.py, test_torch_parallel_bn.py); float32: loss and metrics
# 1e-5 relative, reduced gradients 1e-5 of max-abs, running statistics 1e-5
# (floor 1e-5 of max-abs); bf16-mixed: loss 1e-4, gradients 2e-2 of
# max-abs, running statistics 1e-5. One step, as there: Adam's first update
# moves a parameter by lr in its gradient's sign, so a near-zero gradient's
# float32 noise flips whole steps of lr, and three steps of VoxelNet put its
# running statistics 1.6e-2 (float32) to 1.6e-1 (bf16) of max-abs apart
# (H100 80GB HBM3, 700 W)
PARALLEL_BATCH, PARALLEL_RANKS, PARALLEL_STEPS, PARALLEL_TRAINER_STEPS = 2, 2, 1, 10
PARALLEL_TOL = {"loss": 1e-5, "grad": 1e-5, "stats": 1e-5}
PARALLEL_BF16_TOL = {"loss": 1e-4, "grad": 2e-2, "stats": 1e-5}
# VoxelNet at full width carries float32 noise of its own beyond the CPU
# bounds: its world-size-1 evaluations (the whole batch; each convolution
# one rank's rows at a time, `per_rank_convolutions`; the sharded step at
# world size 1) lie 1.7e-3 to 2.1e-3 of max-abs (the worst gradient tensor,
# a norm's scale or bias among them) from a float64 step and up to 2.1e-3
# from one another (H100 80GB HBM3, 700 W). So its ranks are refereed by
# the next wider step (float64 for float32, the float32 step for bf16): no
# farther from it than PARALLEL_REFEREE_FACTOR times the farthest of those
# evaluations. Most of the float32 distance is ~290 ReLU and ~10,000 ResNet
# max-pool picks made otherwise than float64's in every float32 step, so
# the float32 ranks and evaluations take float64's picks (ReluPicks; 2.6e-4
# to 5.7e-4 from float64 then); bf16 differs from float32 in millions of
# picks and keeps its own
PARALLEL_REFEREE_FACTOR = 1.25
# the NCCL world-size-1 trainer against the plain steps: the same work, its
# reductions over one rank (two-pass BatchNorm statistics, sums over
# counts) in another float32 order
PARALLEL_WORLD1_RTOL = 1e-5
# K2's x-slab splits checked against the whole grid (slab counts)
SLAB_COUNTS = {(96, 96, 56): (2, 4, 8), (190, 180, 50): (2, 5)}
# prefetch_batches 0 against 2 on the data phase's loader-fed steps, in
# turns; the same weights, batches and draws, so the first step's loss
# differs only by the scatter atomics' order (no deterministic algorithms
# while timing; over 16 Adam steps that order moved the last loss by up to
# 6.1e-4 on an H100 80GB HBM3 at 700 W)
PREFETCH_EPOCHS, PREFETCH_TURNS, PREFETCH_LOSS_RTOL = 2, (0, 2, 0, 2), 1e-5


def _parallel_rank(rank: int, world: int, backend: str, port: int, job_path: str,
                   out_path: str) -> None:
    """One rank of the parallel phase (a spawned process): joins the group,
    runs each case's steps on its rows of the global batch and the sharded
    grid decode, the kernel counters reset just before and read just after
    each, and saves what it got to out_path."""
    from unittest import mock

    import torch

    from gennerf_tpu_torch import set_reference_precision
    from gennerf_tpu_torch.models import backbone3d as backbone3d_module
    from gennerf_tpu_torch.models import resnet as resnet_module
    from gennerf_tpu_torch.models.gen_nerf import SceneRepr
    from gennerf_tpu_torch.ops import kernels
    from gennerf_tpu_torch.parallel import distributed
    from gennerf_tpu_torch.parallel.mesh import shard_batch
    from gennerf_tpu_torch.predict import build_model
    from gennerf_tpu_torch.train.predict import predict_tsdf_volume
    from gennerf_tpu_torch.train.state import make_optimizer
    from gennerf_tpu_torch.train.step import batch_to_device, train_step

    dev = torch.device("cuda", rank if backend == "nccl" else 0)
    set_reference_precision()
    distributed.init_distributed(dev, backend=backend, coordinator_address=f"localhost:{port}",
                                 num_processes=world, process_id=rank)
    try:
        job = torch.load(job_path, weights_only=False)
        out = {"backend": distributed.backend(), "device": str(dev), "cases": {}}
        # float64's picks of the global batch (ReluPicks), this rank's rows
        picks = ReluPicks(torch, (resnet_module, backbone3d_module))
        picks.picks = job["picks"]
        picks = picks.rows(rank, world)
        for name, case in job["cases"].items():
            model = build_model(case["model"], dev, SEED, case["precision"])
            model.load_state_dict(case["state"])
            opt = make_optimizer(model.parameters(), model.cfg.optimizer, case["clip"])
            local, split = shard_batch(case["batch"])
            batch = batch_to_device(local, dev)
            gen = torch.Generator(device=dev).manual_seed(SEED)
            metrics, grads = [], None
            # a planted fault: BatchNorm's statistics take a backward that
            # is not all-reduced (each rank keeps its rows' share)
            plant = (mock.patch.object(distributed._SharedSum, "backward",
                                       distributed._GlobalSum.backward)
                     if case.get("plant") == "local_bn_backward" else contextlib.nullcontext())
            # with "picks": count this rank's picks made otherwise than
            # float64's ("count") or take them ("pin")
            replay = (picks.replaying(model, pin=case["picks"] == "pin") if case.get("picks")
                      else contextlib.nullcontext())
            kernels.reset_launch_counts()
            with deterministic_algorithms(torch), plant, replay as counts:
                for step in range(PARALLEL_STEPS):
                    m = train_step(model, opt, batch, gen, sharded=split)
                    metrics.append({k: float(v) for k, v in m.items()})
                    if grads is None:
                        grads = {n: p.grad.detach().cpu() for n, p in model.named_parameters()
                                 if p.grad is not None}
            torch.cuda.synchronize()
            out["cases"][name] = {
                "picks_off_f64": dict(counts) if counts else None,
                "rows": int(local["image"].shape[0]), "sharded": split, "metrics": metrics,
                "grads": grads, "state": {k: v.detach().cpu() for k, v in
                                          model.state_dict().items()},
                "launches": {k.name: k.launches for k in kernels.KERNELS}}
        decode = job["decode"]
        if decode is None:
            torch.save(out, out_path)
            return
        model = build_model(decode["model"], dev, SEED)
        model.load_state_dict(decode["state"])
        repr_ = SceneRepr({k: v.to(dev) for k, v in decode["planes"].items()})
        kernels.reset_launch_counts()
        vol = predict_tsdf_volume(model, repr_, decode["voxel_dim"], model.cfg.voxel_size,
                                  torch.zeros(3, device=dev), sharded=True)
        torch.cuda.synchronize()
        out["decode"] = {"volume": vol.cpu(),
                         "launches": {k.name: k.launches for k in kernels.KERNELS}}
        torch.save(out, out_path)
    finally:
        distributed.shutdown()


def run_parallel_ranks(torch, world: int, backend: str, job: dict, tmp: str) -> list:
    """Each rank's results of `job` on `world` spawned ranks (raises if a
    rank fails or does not finish in 600 s; every rank is stopped)."""
    import socket

    import torch.multiprocessing as mp

    job_path = os.path.join(tmp, f"job_{backend}.pt")
    torch.save(job, job_path)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    ctx = mp.get_context("spawn")
    outs = [os.path.join(tmp, f"{backend}_rank{r}.pt") for r in range(world)]
    procs = [ctx.Process(target=_parallel_rank, args=(r, world, backend, port, job_path, outs[r]))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.time() + 600
    try:
        for p in procs:
            p.join(max(1.0, deadline - time.time()))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    codes = [p.exitcode for p in procs]
    if codes != [0] * world or not all(os.path.exists(o) for o in outs):
        raise RuntimeError(f"{backend} ranks exited with {codes}")
    return [torch.load(o, weights_only=False) for o in outs]


def _max_rel(a, b) -> float:
    return float((a.double() - b.double()).abs().max()) / max(float(b.double().abs().max()),
                                                              1e-30)


@contextlib.contextmanager
def per_rank_convolutions(parts: int):
    """Within: every convolution of the port's models (`resnet._CastConv`)
    runs on `parts` equal slices of its batch, one after the other and
    concatenated, as `parts` ranks run it on their rows."""
    from gennerf_tpu_torch.models import resnet

    import torch

    forward = resnet._CastConv.forward

    def sliced(self, x):
        if x.shape[0] % parts:
            return forward(self, x)
        return torch.cat([forward(self, c) for c in x.chunk(parts)])

    resnet._CastConv.forward = sliced
    try:
        yield
    finally:
        resnet._CastConv.forward = forward


def _distances(runs: list, ref: dict) -> dict:
    """The worst gradient and running-statistic distance (each of its
    tensor's max-abs) of runs ({"grads", "state"}) from ref's."""
    return {"grad": max(_max_rel(run["grads"][n], g) for run in runs
                        for n, g in ref["grads"].items()),
            "stats": max([0.0] + [_max_rel(run["state"][k], v) for run in runs
                                  for k, v in ref["state"].items() if "running_" in k])}


def distance_distribution(runs: list, others: list, ref: dict, top: int = 8) -> dict:
    """Each parameter's gradient distance from ref's (its tensor's
    max-abs; the farthest of `runs`): quantiles over the parameters, and
    the `top` farthest with the farthest of `others` beside each."""
    import numpy as np

    def per(rs):
        return {n: max(_max_rel(r["grads"][n], g) for r in rs) for n, g in ref["grads"].items()}

    mine, theirs = per(runs), per(others)
    d = np.array(list(mine.values()))
    worst = sorted(mine, key=mine.get, reverse=True)[:top]
    return {"parameters": len(d),
            "quantiles": {q: float(np.quantile(d, float(q)))
                          for q in ("0.5", "0.9", "0.99", "1.0")},
            "top": [[n, mine[n], theirs[n]] for n in worst]}


def rank_distances(ranks: list, name: str, ref: dict) -> dict:
    """The ranks' worst loss / metric (relative), gradient and
    running-statistic distance from a world-size-1 step."""
    runs = [r["cases"][name] for r in ranks]
    loss = max(abs(m[k] - v) / max(abs(v), 1e-30) for run in runs
               for m, mr in zip(run["metrics"], ref["metrics"]) for k, v in mr.items())
    return {"loss": loss, **_distances(runs, ref)}


def _within(d: dict, tol: dict, name: str) -> bool:
    """Every key of `tol` within it, each recorded as a gate `name`.key."""
    return all([gate(f"{name}.{k}", d[k], tol[k]) for k in tol])


def compare_ranks(ranks: list, reference: dict, wider: dict) -> tuple:
    """(report, failures) of the ranks' step against world size 1 (module
    docstring): every case's loss within PARALLEL_TOL / PARALLEL_BF16_TOL
    and the ranks' states bit-equal; GenNerf's gradients and statistics
    within those bounds too; VoxelNet's refereed by the next wider step
    (`wider`: float64 for float32, float32 for bf16), no farther from it
    than PARALLEL_REFEREE_FACTOR times the farthest of the world-size-1
    evaluations (the reference and its `variants`), with the distances'
    spread over the parameters (`by_parameter`) where a bound reads EDGE
    of itself or more. Two planted faults on the float32 VoxelNet case
    must read beyond that bound: the gradients averaged over the ranks
    instead of summed, and BatchNorm's backward not all-reduced (the
    `voxelnet_f32_planted_bn` case the ranks ran)."""
    report, failures = {}, []
    for name, ref in reference.items():
        runs = [r["cases"][name] for r in ranks]
        d = rank_distances(ranks, name, ref)
        tol = PARALLEL_TOL if ref["precision"] == "32-true" else PARALLEL_BF16_TOL
        equal = all(all(bool((runs[0]["state"][k] == run["state"][k]).all())
                        for k in ref["state"]) for run in runs[1:])
        rec = report[name] = {
            "rows_per_rank": runs[0]["rows"], **d, "ranks_bit_equal": equal, "tolerance": tol,
            "vector_params_grad": max(_max_rel(run["grads"][n], g) for run in runs
                                      for n, g in ref["grads"].items() if g.dim() == 1),
            "launches": [run["launches"] for run in runs]}
        for label, variant in ref.get("variants", {}).items():
            rec["vs_" + label] = rank_distances(ranks, name, variant)
        ok = equal & gate(f"{name}.loss", d["loss"], tol["loss"])
        if name in wider:
            one = [ref, *ref.get("variants", {}).values()]
            own = {k: max(_distances([o], wider[name])[k] for o in one) for k in ("grad", "stats")}
            vs = rec["vs_wider"] = {
                "ranks": _distances(runs, wider[name]), "one_process": own,
                "bound": {k: PARALLEL_REFEREE_FACTOR * v for k, v in own.items()},
                "picks_off_f64": {"ranks": [r.get("picks_off_f64") for r in runs],
                                  "one_process": [o.get("picks_off_f64") for o in one]}}
            ok &= _within(vs["ranks"], vs["bound"], f"{name}.vs_wider")
            if at_edge(gate_margin(vs["ranks"]["grad"], vs["bound"]["grad"])):
                vs["by_parameter"] = distance_distribution(runs, one, wider[name])
        else:
            ok &= _within(d, {k: tol[k] for k in ("grad", "stats")}, name)
        if not ok:
            failures.append(f"{name} on {len(ranks)} ranks disagrees with world size 1: {rec}")
    base = "voxelnet_f32"
    halved = [dict(r["cases"][base], grads={
        n: g / len(ranks) for n, g in r["cases"][base]["grads"].items()}) for r in ranks]
    planted = {"gradients_averaged": _distances(halved, wider[base]),
               "bn_backward_local": _distances([r["cases"]["voxelnet_f32_planted_bn"]
                                                for r in ranks], wider[base])}
    bound = report[base]["vs_wider"]["bound"]
    report["planted_faults"] = {"vs_wider": planted, "bound": bound}
    for k, d in planted.items():
        if not gate(f"planted_{k}.over_bound", max(d[j] / bound[j] for j in bound), 1.0,
                    "beyond"):
            failures.append(f"the planted fault {k} reads within the bounds: {d}")
    return report, failures


def parallel_phase(torch, dev, smi: str, root: str) -> tuple:
    """Phase 17 (see the module docstring); returns (the launch counts of
    the phase's main-path runs, its kernel errors)."""
    GATES.phase = "parallel"
    import tempfile
    from unittest import mock

    from gennerf_tpu_torch.data.datamodule import ScannetDataModule
    from gennerf_tpu_torch.ops import kernels
    from gennerf_tpu_torch.ops.grid_decode import (
        grid_decode_cuda, grid_tables, separable_grid_decode_plain, slab_tables,
    )
    from gennerf_tpu_torch.ops.projection import get_3d_points
    from gennerf_tpu_torch.ops.sampling import (
        farthest_point_sample_plain, fps_cuda, uniform_presample,
    )
    from gennerf_tpu_torch.models import backbone3d as backbone3d_module
    from gennerf_tpu_torch.models import resnet as resnet_module
    from gennerf_tpu_torch.parallel import distributed
    from gennerf_tpu_torch.predict import build_model
    from gennerf_tpu_torch.tools.measure import cuda_ms
    from gennerf_tpu_torch.train import loop as loop_module
    from gennerf_tpu_torch.train.loop import Trainer
    from gennerf_tpu_torch.train.predict import decode_grid, predict_tsdf_volume
    from gennerf_tpu_torch.train.state import make_optimizer
    from gennerf_tpu_torch.train.step import batch_to_device, train_step
    from gennerf_tpu_torch.utils.config import load_experiment_config

    import numpy as np

    t_phase = time.perf_counter()
    totals = {k.name: 0 for k in kernels.KERNELS}
    errors = {"fps": 0.0, "grid_decode": 0.0}

    def add(launches):
        for k, v in launches.items():
            totals[k] += v

    # the global batches: PARALLEL_BATCH loader items of each config
    cases = {}
    for name, path, precision in (("gennerf", EXPERIMENT, None),
                                  ("voxelnet", VOXELNET_EXPERIMENT, None),
                                  ("voxelnet_f32", VOXELNET_EXPERIMENT, "32-true")):
        cfg = load_experiment_config(path, "train", [f"paths.data_dir={root}"])
        data_cfg = dict(cfg["data"], batch_size=PARALLEL_BATCH)
        batch = next(iter(ScannetDataModule(data_cfg, seed=SEED).train_dataloader()))
        batch = {k: v for k, v in batch.items() if isinstance(v, np.ndarray)}
        precision = precision or str(cfg["trainer"].get("precision", "32-true"))
        model = build_model(cfg["model"], dev, SEED, precision)
        state = cases["voxelnet"]["state"] if name == "voxelnet_f32" else {
            k: v.detach().cpu() for k, v in model.state_dict().items()}
        cases[name] = {"model": cfg["model"], "precision": precision, "batch": batch,
                       "clip": cfg["trainer"].get("gradient_clip_val"), "state": state}

    def reference_run(case, per_rank: bool = False, sharded: bool = False, picks=None,
                      pin: bool = False):
        """World-size-1 steps of `case`; with `picks`, each step replays
        them (counting its own picks made otherwise; `pin`: taking them)."""
        model = build_model(case["model"], dev, SEED, case["precision"])
        model.load_state_dict(case["state"])
        opt = make_optimizer(model.parameters(), model.cfg.optimizer, case["clip"])
        batch = batch_to_device(case["batch"], dev)
        gen = torch.Generator(device=dev).manual_seed(SEED)
        metrics, grads = [], None
        replay = picks.replaying(model, pin=pin) if picks else contextlib.nullcontext()
        with deterministic_algorithms(torch), (per_rank_convolutions(PARALLEL_RANKS) if per_rank
                                               else contextlib.nullcontext()), replay as counts:
            for _ in range(PARALLEL_STEPS):
                m = train_step(model, opt, batch, gen, sharded=sharded)
                metrics.append({k: float(v) for k, v in m.items()})
                if grads is None:
                    grads = {n: p.grad.detach().cpu() for n, p in model.named_parameters()
                             if p.grad is not None}
        return {"precision": case["precision"], "metrics": metrics, "grads": grads,
                "state": {k: v.detach().cpu() for k, v in model.state_dict().items()},
                "picks_off_f64": dict(counts) if counts else None}

    # float64 gradients of VoxelNet's first step at world size 1 (the
    # projections stay float32: the backprojection's lookup is float32),
    # and its ReLU and max-pool picks (VoxelNet's BatchNorms pick nothing)
    case = cases["voxelnet_f32"]
    m64 = build_model(case["model"], dev, SEED, "32-true")
    m64.load_state_dict(case["state"])
    m64 = m64.double().train()
    b64 = {k: torch.from_numpy(v).to(dev, torch.float64) for k, v in case["batch"].items()}
    picks64 = ReluPicks(torch, (resnet_module, backbone3d_module))
    with deterministic_algorithms(torch), picks64.recording(m64):
        _, losses64 = m64(torch.from_numpy(case["batch"]["projection"]).to(dev),
                          b64["image"], m64.cfg.voxel_dim_train, None,
                          {k: b64[k] for k in b64 if k.endswith("_tsdf")})
        sum(losses64.values()).backward()
    wider = {"voxelnet_f32": {
        "grads": {n: p.grad.detach().cpu() for n, p in m64.named_parameters()
                  if p.grad is not None},
        "state": {k: v.detach().cpu() for k, v in m64.state_dict().items()}}}
    del m64, b64, losses64

    # world size 1: the whole batch and each convolution on one rank's rows
    # at a time; VoxelNet's bf16 counting its picks off float64's, its
    # float32 taking them; bf16's referee, the float32 step on its own picks
    reference = {}
    for name, case in cases.items():
        picks = picks64 if name.startswith("voxelnet") else None
        pin = name == "voxelnet_f32"
        reference[name] = reference_run(case, per_rank=bool(picks), picks=picks, pin=pin)
        if picks:
            reference[name]["variants"] = {"whole": reference_run(case, picks=picks, pin=pin)}
    wider["voxelnet"] = reference_run(cases["voxelnet_f32"])
    gc.collect()
    torch.cuda.empty_cache()  # the ranks share the card with this process

    # the grid decode's scene: the GenNerf case's first item encoded
    gcase = cases["gennerf"]
    gmodel = build_model(gcase["model"], dev, SEED)
    gmodel.load_state_dict(gcase["state"])
    gb = batch_to_device({k: v[:1] for k, v in gcase["batch"].items()}, dev)
    with torch.no_grad():
        repr_ = gmodel.encode(gb["projection"], gb["image"], gb["depth"],
                              torch.Generator(device=dev).manual_seed(SEED))
    planes = {k: v.detach().cpu() for k, v in repr_.planes.items()}
    decode_job = {"model": gcase["model"], "state": gcase["state"], "planes": planes,
                  "voxel_dim": VOXEL_DIM}
    whole = decode_grid(gmodel, repr_, VOXEL_DIM, gmodel.cfg.voxel_size,
                        torch.zeros(3, device=dev)).cpu()

    ran, failures = [], []
    record = {"phase": "parallel", "global_batch": PARALLEL_BATCH,
              "devices": torch.cuda.device_count(), "card": smi}
    with tempfile.TemporaryDirectory() as tmp:
        # (a) NCCL at world size 1 in this process: the data-parallel
        # trainer's steps against the plain steps, the machinery's cost
        distributed.init_distributed(dev, backend="nccl",
                                     coordinator_address=f"localhost:{_free_port()}",
                                     num_processes=1, process_id=0)
        try:
            ran.append("nccl_world1")
            for name in ("voxelnet", "voxelnet_f32"):
                reference[name]["variants"]["sharded_world1"] = reference_run(
                    cases[name], per_rank=True, sharded=True, picks=picks64,
                    pin=name == "voxelnet_f32")
            case = cases["gennerf"]
            batch_np = case["batch"]

            def fresh(case):
                model = build_model(case["model"], dev, SEED, case["precision"])
                model.load_state_dict(case["state"])
                return model, make_optimizer(model.parameters(), model.cfg.optimizer,
                                             case["clip"])

            def machinery_cost(case, dp, plain) -> dict:
                """ms of the coalesced gradient all-reduce, and of the
                sharded against the plain step (turns: sharded, plain,
                sharded, plain; each the median of 10 steps)."""
                batch = batch_to_device(case["batch"], dev)
                gens = [torch.Generator(device=dev).manual_seed(SEED) for _ in range(2)]
                steps = {"sharded": lambda: train_step(*dp, batch, gens[0], sharded=True),
                         "plain": lambda: train_step(*plain, batch, gens[1])}
                steps["sharded"]()  # the gradients the all-reduce sums
                with distributed.sharded():
                    allreduce = cuda_ms(torch, lambda: distributed.all_reduce_gradients(
                        dp[0].parameters()), reps=20)
                turns = {"sharded": [], "plain": []}
                for label in ("sharded", "plain") * 2:
                    turns[label].append(cuda_ms(torch, steps[label], reps=10))
                return {"precision": case["precision"], "grad_allreduce_ms": allreduce,
                        "grad_bytes": sum(p.numel() * p.element_size()
                                          for p in dp[0].parameters()),
                        "sharded_step_ms": turns["sharded"], "plain_step_ms": turns["plain"]}

            plain_model, plain_opt = fresh(case)
            plain_gen = torch.Generator(device=dev).manual_seed(SEED)
            plain_batch = batch_to_device(batch_np, dev)
            plain_losses = []
            with deterministic_algorithms(torch):
                for _ in range(PARALLEL_TRAINER_STEPS):
                    plain_losses.append(float(train_step(plain_model, plain_opt, plain_batch,
                                                         plain_gen)["combined"]))
            dp_model, dp_opt = fresh(case)
            dp_losses, dp_sharded = [], []

            def recording_step(*a, **k):
                dp_sharded.append(k.get("sharded", False))
                m = train_step(*a, **k)
                dp_losses.append(float(m["combined"]))
                return m

            trainer = Trainer(dp_model, dp_opt, torch.Generator(device=dev).manual_seed(SEED),
                              None, max_epochs=1, log_every_n_steps=PARALLEL_TRAINER_STEPS,
                              num_sanity_val_steps=0, prefetch_batches=2)
            kernels.reset_launch_counts()
            with deterministic_algorithms(torch), \
                    mock.patch.object(loop_module, "train_step", recording_step):
                trainer.fit([batch_np] * PARALLEL_TRAINER_STEPS)
            torch.cuda.synchronize()
            world1_launches = {k.name: k.launches for k in kernels.KERNELS}
            add(world1_launches)
            loss_rel = max(abs(a - b) / abs(b) for a, b in zip(dp_losses, plain_losses))
            plain_sd, dp_sd = plain_model.state_dict(), dp_model.state_dict()
            param_rel = max(_max_rel(dp_sd[k], plain_sd[k]) for k in plain_sd)
            param_equal = all(bool(torch.equal(dp_sd[k], plain_sd[k])) for k in plain_sd)
            del plain_sd, dp_sd
            # K1 on the rank's rows (every row at world size 1): the
            # batch's presampled clouds against the plain FPS
            cfg = plain_model.cfg
            depth = plain_batch["depth"].flatten(0, 1)
            clouds = get_3d_points(depth, plain_batch["projection"].flatten(0, 1))
            xyz = uniform_presample(clouds.reshape(depth.shape[0], -1, 3),
                                    cfg.encoder.pointnet.fps_presample,
                                    torch.Generator().manual_seed(SEED)).contiguous()
            start = torch.randint(0, xyz.shape[1], (xyz.shape[0],),
                                  generator=torch.Generator().manual_seed(SEED)).to(dev)
            npoint = cfg.encoder.pointnet.num_sparse_points
            k1_mismatch = int((fps_cuda(xyz, npoint, start.to(torch.int32)).long()
                               != farthest_point_sample_plain(xyz, npoint, start).long()).sum())
            errors["fps"] = max(errors["fps"], float(k1_mismatch))
            # the machinery's cost: the gradient all-reduce and the step
            cost = {"gennerf": machinery_cost(case, (dp_model, dp_opt), (plain_model, plain_opt))}
            del dp_model, dp_opt, plain_model, plain_opt, trainer
            cost["voxelnet"] = machinery_cost(cases["voxelnet"], fresh(cases["voxelnet"]),
                                              fresh(cases["voxelnet"]))
            gc.collect()
            torch.cuda.empty_cache()
            # the sharded grid decode at world size 1: K2 once, the whole grid
            kernels.reset_launch_counts()
            vol1 = predict_tsdf_volume(gmodel, repr_, VOXEL_DIM, gmodel.cfg.voxel_size,
                                       torch.zeros(3, device=dev), sharded=True)
            torch.cuda.synchronize()
            decode1_launches = {k.name: k.launches for k in kernels.KERNELS}
            add(decode1_launches)
            record["nccl_world1"] = {
                "backend": distributed.backend(), "steps": PARALLEL_TRAINER_STEPS,
                "sharded_steps": sum(dp_sharded), "loss_rel": loss_rel,
                "param_rel_over_max_abs": param_rel, "params_bit_equal": param_equal,
                "tolerance_rel": PARALLEL_WORLD1_RTOL, "launches": world1_launches,
                "k1_rows_index_mismatches": k1_mismatch, "k1_clouds": list(xyz.shape),
                "machinery_cost": cost, "decode_launches": decode1_launches,
                "decode_equal": bool(torch.equal(vol1.cpu(), whole))}
        finally:
            distributed.shutdown()
        w1 = record["nccl_world1"]
        if (w1["sharded_steps"] != PARALLEL_TRAINER_STEPS
                or not gate("nccl_world1.loss_rel", w1["loss_rel"], PARALLEL_WORLD1_RTOL)
                & gate("nccl_world1.param_rel", w1["param_rel_over_max_abs"],
                       PARALLEL_WORLD1_RTOL) or k1_mismatch
                or w1["launches"]["fps"] != PARALLEL_TRAINER_STEPS
                or decode1_launches["grid_decode"] != 1 or not w1["decode_equal"]):
            raise RuntimeError(f"NCCL world size 1 disagrees with the plain path: {w1}")

        # (b) 2 ranks on the one card over gloo (CUDA tensors); (c) NCCL at
        # world size 2 where the machine has two cards
        job = {"cases": {name: {k: case[k] for k in ("model", "precision", "batch", "clip",
                                                       "state")}
                         for name, case in cases.items()},
               "decode": decode_job, "picks": [p.cpu() for p in picks64.picks]}
        del picks64
        job["cases"]["voxelnet"]["picks"] = "count"
        job["cases"]["voxelnet_f32"]["picks"] = "pin"
        job["cases"]["voxelnet_f32_planted_bn"] = dict(job["cases"]["voxelnet_f32"],
                                                       plant="local_bn_backward")
        runs = [("gloo_2ranks_one_card", "gloo")]
        if torch.cuda.device_count() >= 2:
            runs.append(("nccl_world2", "nccl"))
        else:
            record["nccl_world2"] = "not run: one card"
        for label, backend in runs:
            gc.collect()
            torch.cuda.empty_cache()
            t0 = time.perf_counter()
            ranks = run_parallel_ranks(torch, PARALLEL_RANKS, backend, job, tmp)
            ran.append(label)
            rep, failed = compare_ranks(ranks, reference, wider)
            failures += failed
            gathered = [r["decode"]["volume"] for r in ranks]
            for r in ranks:
                for c in r["cases"].values():
                    add(c["launches"])
                add(r["decode"]["launches"])
            record[label] = {
                "backend": [r["backend"] for r in ranks], "devices": [r["device"] for r in ranks],
                "cases": rep, "seconds": time.perf_counter() - t0,
                "decode_launches": [r["decode"]["launches"] for r in ranks],
                "decode_equal_whole_k2": all(bool(torch.equal(g, whole)) for g in gathered)}
            if not record[label]["decode_equal_whole_k2"] or any(
                    r["decode"]["launches"]["grid_decode"] != 1 for r in ranks):
                failures.append(f"{label}: the sharded decode is not the whole grid's "
                                f"({record[label]['decode_launches']})")
            for name in ranks[0]["cases"]:
                fps = [r["cases"][name]["launches"]["fps"] for r in ranks]
                if any(f != (PARALLEL_STEPS if name == "gennerf" else 0) for f in fps):
                    failures.append(f"{label}: {name} launched K1 {fps} times")

    # (d) K2's x-slab split: each slab through K2, concatenated, against the
    # whole grid through K2 and the plain bf16-feed decode
    slabs = {}
    fcfg = load_experiment_config(FLAGSHIP_EXPERIMENT, "train", flagship_overrides(root))
    fmodel = build_model(fcfg["model"], dev, SEED)
    reso = fmodel.cfg.encoder.pointnet.plane_resolution
    c_dim = fmodel.cfg.encoder.pointnet.c_dim
    pgen = torch.Generator(device=dev).manual_seed(SEED)
    fplanes = {k: 0.5 * torch.randn((1, c_dim, reso, reso), generator=pgen, device=dev)
               for k in ("xz", "xy", "yz")}
    for voxel_dim, (model, pl) in (((96, 96, 56), (gmodel, repr_.planes)),
                                   ((190, 180, 50), (fmodel, fplanes))):
        weights = decoder_weights(model, point=False)
        mcfg = model.cfg
        extent = [d * mcfg.voxel_size for d in mcfg.voxel_dim_train]
        norm = mcfg.encoder.pointnet.normalize_coords
        tables = grid_tables(pl["xz"][0], pl["xy"][0], pl["yz"][0], torch.zeros(3, device=dev),
                             weights, voxel_dim=voxel_dim, voxel_size=mcfg.voxel_size,
                             num_freqs=mcfg.code.num_freqs, freq_factor=mcfg.code.freq_factor,
                             include_input=mcfg.code.include_input,
                             padding=mcfg.encoder.pointnet.padding,
                             coord_center=tuple(e / 2 for e in extent) if norm else None,
                             coord_scale=max(extent) if norm else None)
        full = grid_decode_cuda(tables, weights)
        plain = separable_grid_decode_plain(tables, weights, bf16_feeds=True)
        for n in SLAB_COUNTS[voxel_dim]:
            k = voxel_dim[0] // n
            parts = [grid_decode_cuda(slab_tables(tables, i * k, (i + 1) * k), weights)
                     for i in range(n)]
            cat = torch.cat(parts, dim=0)
            err = (cat - plain).abs()
            slabs[f"{'x'.join(map(str, voxel_dim))}/{n}"] = {
                "d_in": int(pl["xz"].shape[1]),
                "equal_whole_k2": bool(torch.equal(cat, full)),
                "vs_plain_max_abs": float(err.max()), "vs_plain_mean_abs": float(err.mean())}
            errors["grid_decode"] = max(errors["grid_decode"], float(err.max()))
    record["slabs"] = slabs
    if not all([s["equal_whole_k2"] and grid_gates(f"slabs.{k}", s["vs_plain_max_abs"],
                                                   s["vs_plain_mean_abs"])
                for k, s in slabs.items()]):
        failures.append(f"K2's x-slab split disagrees: {slabs}")

    # (e) prefetch_batches 0 against 2 on the data phase's loader-fed steps
    prefetch = {}
    cfg = load_experiment_config(EXPERIMENT, "train", [f"paths.data_dir={root}"])
    for size in PREFETCH_TURNS:
        model = build_model(cfg["model"], dev, SEED)
        opt = make_optimizer(model.parameters(), model.cfg.optimizer,
                             cfg["trainer"].get("gradient_clip_val"))
        trainer = Trainer(model, opt, torch.Generator(device=dev).manual_seed(SEED), None,
                          max_epochs=PREFETCH_EPOCHS, log_every_n_steps=1,
                          num_sanity_val_steps=0, prefetch_batches=size)
        first = []

        def first_loss(*a, **k):
            metrics = train_step(*a, **k)
            if not first:
                first.append(metrics["combined"])
            return metrics

        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        with mock.patch.object(loop_module, "train_step", first_loss):
            trainer.fit(ScannetDataModule(cfg["data"], seed=SEED).train_dataloader())
        fit_s = time.perf_counter() - t0
        launches = {k.name: k.launches for k in kernels.KERNELS}
        add(launches)
        waits = [t["data_wait_ms"] for t in trainer.timings]
        steps = [t["step_ms"] for t in trainer.timings]
        prefetch.setdefault(str(size), []).append({
            "steps": len(steps), "data_wait_ms_median": statistics.median(waits),
            "step_ms_median": statistics.median(steps), "fit_s": fit_s,
            "loss_first": float(first[0]), "loss_last": trainer.metrics["train_combined"],
            "k1_launches": launches["fps"]})
        if launches["fps"] != trainer.global_step or len(steps) < 16:
            failures.append(f"prefetch {size}: {launches} in {trainer.global_step} steps")
    losses = [run["loss_first"] for runs in prefetch.values() for run in runs]
    spread = (max(losses) - min(losses)) / abs(min(losses))
    record["prefetch"] = {"turns": list(PREFETCH_TURNS), **prefetch,
                          "first_loss_spread_rel": spread, "tolerance_rel": PREFETCH_LOSS_RTOL}
    if not gate("prefetch.first_loss_spread", spread, PREFETCH_LOSS_RTOL):
        failures.append(f"prefetch_batches changed the run: {prefetch}")
    record.update(ran=ran, launches=totals, seconds=time.perf_counter() - t_phase,
                  failures=failures)
    emit(record)
    if failures:
        raise RuntimeError("; ".join(failures))
    return totals, errors


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


# the kernels phase: each kernel alone at the shape PERF.md's kernel table
# reports. The decodes' widths are seqs_multigeo_4cm's at full width
# (ResnetFC H 256 x 5 blocks, c_dim 32 features, a 39-wide positional code)
DECODER_H, DECODER_BLOCKS, DECODER_D_IN, DECODER_D_CODE = 256, 5, 32, 39
# the lift rows: the VoxelNet cell's maps (frame_chunk 4 x batch 3 images of
# ResNet-50 at feature_scale 2 on 480x640 frames, 1,856 -> 32 channels)
LIFT_IMAGES, LIFT_OUT = 12, 32
LIFT_MAPS = ((64, 480, 640), (256, 240, 320), (512, 120, 160), (1024, 60, 80))
# the kernel and the plain path sum the same bf16 products in f32 in other
# orders (~1e-6 of a sum), so a rounding flips on ~1e-3 of the elements
LIFT_DIFFERING_SHARE = 0.01
# the volume sample row: one decode chunk of the spatial cell's grid (its
# 13th of 24), 262,144 points of the 512-channel f32 mean-feature volume
VS_CHANNELS, VS_CHUNK, VS_CHUNK_INDEX = 512, 262144, 12
# the kernel's time a cell chunk, at most (ms; its bound by bytes is 0.32)
VS_MAX_MS = 1.0
# the backprojection row: the spatial cell's 8 frames of 512 bf16 channels
# at 480x640 (the images' own size) into its grid
BP_FRAMES, BP_CHANNELS, BP_HW = 8, 512, (480, 640)


@dataclasses.dataclass(frozen=True)
class KernelRow:
    """A kernel of the `kernels` phase. `make(torch, dev, shape)` builds its
    inputs at `shape` and returns {"kernel", "plain": the kernel's and its
    plain version's calls on them, "check": a call taking their outputs
    and returning {gate: (value, limit)}, the kernel held against its
    plain version, "bytes", "ops": what its bound moves and computes}, and
    where the row needs them "peak" (the operations a second its ops run
    at, else the bf16 tensor peak), "inner" (calls a timed sample),
    "parts" ((kernel, plain) calls timed one by one and their ms summed,
    in place of the two calls) and "extras" (a call returning the row's
    own readings). `shape` is the one PERF.md's kernel table reports,
    `tiny` a CPU-sized one of the same form; `max_ms` gates the kernel's
    ms."""
    name: str
    source: str
    replaces: str | None
    shape: tuple
    tiny: tuple
    make: Callable
    max_ms: float | None = None


def _normal(torch, dev):
    """scale * N(0, 1) draws of any shape on `dev`, seeded by SEED."""
    gen = torch.Generator(device=dev).manual_seed(SEED)
    return lambda *shape, scale=1.0: scale * torch.randn(shape, generator=gen, device=dev)


def _random_decoder(rnd, H: int, nb: int, d_in: int, d_code: int) -> dict:
    """Random ResnetFC arrays in extract_resnetfc_weights' form, every
    matrix non-zero (fc_1's too)."""
    return {"w_in": rnd(d_in, H, scale=d_in ** -0.5), "b_in": rnd(H, scale=0.1),
            "wz": rnd(nb, d_code, H, scale=d_code ** -0.5), "bz": rnd(nb, H, scale=0.1),
            "w0": rnd(nb, H, H, scale=H ** -0.5), "w1": rnd(nb, H, H, scale=H ** -0.5),
            "b0": rnd(nb, H, scale=0.1), "b1": rnd(nb, H, scale=0.1),
            "w_last": rnd(H, scale=H ** -0.5), "b_last": 0.05, "alpha": 0.7, "smoothing": 1.05}


def ring_clouds(torch):
    """The (NUM_FRAMES, HEIGHT * WIDTH, 3) depth clouds of the scene's ring
    frames, on the CPU."""
    from gennerf_tpu_torch.data.synthetic import ring_frames
    from gennerf_tpu_torch.ops.projection import get_3d_points

    P, _, depth = (torch.from_numpy(a) for a in ring_frames(
        NUM_FRAMES, HEIGHT, WIDTH, SCENE_CENTER, PRIMITIVES, seed=SEED))
    return get_3d_points(depth, P).reshape(NUM_FRAMES, -1, 3)


def _max_abs(a, b) -> float:
    """The largest |a - b| of two outputs (tensors or lists of them), in
    float64 a slice of 2^26 elements at a time."""
    pairs = zip(a, b) if isinstance(a, list) else [(a, b)]
    step = 1 << 26
    return max(float((x[i:i + step].double() - y[i:i + step].double()).abs().max())
               for x, y in ((x.reshape(-1), y.reshape(-1)) for x, y in pairs)
               for i in range(0, x.numel(), step))


def ring_projections(torch, dev, B: int, T: int, image_hw, grid, voxel: float, seed: int):
    """(B, T, 3, 4) world->image projections of cameras on a ring around
    the centre of a grid of `voxel` cells at origin 0, looking at it
    (f = 0.6 W), a little above it."""
    import numpy as np

    from gennerf_tpu_torch.data.synthetic import look_at_pose

    rng = np.random.default_rng(seed)
    H, W = image_hw
    K = np.array([[0.6 * W, 0, W / 2], [0, 0.6 * W, H / 2], [0, 0, 1]])
    ext = np.asarray(grid, np.float64) * voxel
    center, radius = ext / 2, 0.45 * float(ext[:2].max())
    out = np.empty((B, T, 3, 4), np.float32)
    for b in range(B):
        for t in range(T):
            ang = 2 * np.pi * t / T + 0.4 * b + 0.05 * rng.standard_normal()
            eye = center + np.array([radius * np.cos(ang), radius * np.sin(ang), 0.3 * ext[2]])
            out[b, t] = (K @ np.linalg.inv(look_at_pose(eye, center))[:3]).astype(np.float32)
    return torch.from_numpy(out).to(dev)


def _fps_row(torch, dev, shape) -> dict:
    """K1 on B presampled depth clouds of the ring frames (with
    replacement: duplicates, ties) of N points, npoint; the indices equal
    to the plain version's; extras: the plan the wrapper launched, the
    clusters the card runs at once for each size, one call's ms."""
    from gennerf_tpu_torch.ops import kernels
    from gennerf_tpu_torch.ops.sampling import (
        FPS_CLUSTERS, farthest_point_sample_plain, fps_cuda, uniform_presample,
    )
    from gennerf_tpu_torch.tools.measure import FPS_INNER, cuda_ms

    B, N, npoint = shape
    cloud = ring_clouds(torch)
    gen = torch.Generator().manual_seed(SEED)
    xyz = uniform_presample(cloud[torch.arange(B) % NUM_FRAMES], N, gen).contiguous().to(dev)
    start = torch.randint(0, N, (B,), generator=gen).to(dev, torch.int32)

    def kernel():
        return fps_cuda(xyz, npoint, start)

    def extras():
        kernel()
        return {"launched": dict(kernels.FPS.last_launch),
                "active_clusters": {cl: kernels.fps_plan(N, cl)["active_clusters"]
                                    for cl in FPS_CLUSTERS},
                "single_call_ms": cuda_ms(torch, kernel, 10)}

    # distance update + running min + argmax compare: 10 f32 ops per point per iteration
    return {"kernel": kernel, "plain": lambda: farthest_point_sample_plain(xyz, npoint, start),
            "check": lambda k, p: {"index_mismatches": (int((k != p).sum()), 0)},
            "bytes": 4 * (xyz.numel() + B + B * npoint), "ops": 10 * B * N * npoint,
            "peak": PEAK_F32, "inner": FPS_INNER, "extras": extras}


def _grid_decode_row(torch, dev, shape) -> dict:
    """K2 on random tables of an (nx, ny, nz) grid and a random decoder of
    width H and nb blocks, within the grid tolerances of its plain
    bf16-feed decode."""
    from gennerf_tpu_torch.ops.grid_decode import (
        GridTables, grid_decode_cuda, grid_decode_flops, separable_grid_decode_plain,
    )
    from gennerf_tpu_torch.ops.weight_slabs import pack_decode_weights

    H, nb, dims = shape
    nx, ny, nz = dims
    rnd = _normal(torch, dev)
    weights = pack_decode_weights(_random_decoder(rnd, H, nb, 1, 1), point=False)
    tables = GridTables(rnd(ny * nz, H), rnd(nx, nz, H), rnd(nx, ny, H), rnd(nx, nb, H, scale=0.3),
                        rnd(nb, ny, H, scale=0.3), rnd(nb, nz, H, scale=0.3))
    packed = sum(weights[k].numel() * weights[k].element_size()
                 for k in ("k_slabs", "k_b0", "k_b1", "k_w_last"))
    return {"kernel": lambda: grid_decode_cuda(tables, weights),
            "plain": lambda: separable_grid_decode_plain(tables, weights, bf16_feeds=True),
            "check": lambda k, p: _decode_check(k, p, GRID_MAX_ABS_TOL, GRID_MEAN_ABS_TOL),
            "bytes": 4 * sum(t.numel() for t in tables) + packed + 4 * math.prod(dims),
            "ops": grid_decode_flops(dims, H, nb)}


def _decode_check(k, p, max_tol: float, mean_tol: float) -> dict:
    """A decode kernel's output `k` against its plain version's `p`."""
    err = (k - p).abs()
    return {"max_abs": (float(err.max()), max_tol), "mean_abs": (float(err.mean()), mean_tol)}


def _point_decode_row(torch, dev, shape) -> dict:
    """K3 on N random points' features (d_in) and codes (d_code) and a
    random decoder of width H and nb blocks, within the point tolerances
    of its plain bf16-feed decode."""
    from gennerf_tpu_torch.ops.point_decode import (
        fused_resnetfc_tsdf_cuda, fused_resnetfc_tsdf_plain, pack_point_weights, point_decode_flops,
    )

    N, d_in, d_code, H, nb = shape
    rnd = _normal(torch, dev)
    weights = pack_point_weights(_random_decoder(rnd, H, nb, d_in, d_code))
    feat, code = rnd(N, d_in), rnd(N, d_code)
    packed = sum(t.numel() * t.element_size() for k, t in weights.items()
                 if k.startswith("k_") and isinstance(t, torch.Tensor))
    return {"kernel": lambda: fused_resnetfc_tsdf_cuda(feat, code, weights),
            "plain": lambda: fused_resnetfc_tsdf_plain(feat, code, weights, bf16_feeds=True),
            "check": lambda k, p: _decode_check(k, p, POINT_MAX_ABS_TOL, POINT_MEAN_ABS_TOL),
            "bytes": 4 * (feat.numel() + code.numel() + N) + packed,
            "ops": point_decode_flops(N, d_in, d_code, H, nb)}


def _lift_row(torch, dev, shape) -> dict:
    """The fused lift's forward on `images` images of random bf16 maps
    (C, H, W) to `out` channels: no element farther from the plain path's
    than one bf16 step a rounding, under LIFT_DIFFERING_SHARE of them
    differing at all, a second run bit-equal; the bound: the maps read
    once and the output written once, or the products at the bf16 peak;
    extras: both paths' forward + backward ms and peak memory."""
    from gennerf_tpu_torch.ops.spatial_lift import (
        spatial_lift, spatial_lift_cuda, spatial_lift_plain,
    )
    from gennerf_tpu_torch.tools.measure import cuda_ms

    images, maps_shape, out = shape
    rnd = _normal(torch, dev)
    maps = [rnd(images, *s).to(torch.bfloat16) for s in maps_shape]
    K = sum(s[0] for s in maps_shape)
    weight, bias = rnd(out, K, 1, 1, scale=K ** -0.5), rnd(out, scale=0.1)
    g = rnd(images, out, *maps_shape[0][1:]).to(torch.bfloat16)
    HW = maps_shape[0][1] * maps_shape[0][2]

    def grads(fn):
        leaves = [t.detach().requires_grad_() for t in (*maps, weight, bias)]
        return torch.autograd.grad(fn(leaves[:-2], leaves[-2], leaves[-1]), leaves, g)

    def steps(v):  # one bf16 step (2^-7 of the binade) at each value
        return torch.ldexp(torch.ones_like(v, dtype=torch.float32), torch.frexp(v.float())[1] - 8)

    def check(k, p):
        y = spatial_lift_plain(maps, weight, torch.zeros_like(bias))
        diff = (k.float() - p.float()).abs()
        return {"beyond_one_step_per_rounding": (int((diff > steps(y) + steps(p)).sum()), 0),
                "differing_share": (float((diff > 0).float().mean()), LIFT_DIFFERING_SHARE),
                "rerun_differing": (int((spatial_lift_cuda(maps, weight, bias) != k).sum()), 0)}

    def extras():
        rec = {}
        for name, fn in (("fused", spatial_lift), ("plain", spatial_lift_plain)):
            ms = cuda_ms(torch, lambda: grads(fn), 3)
            torch.cuda.reset_peak_memory_stats()
            grads(fn)
            torch.cuda.synchronize()
            rec[name] = {"ms": ms, "peak_memory_bytes": torch.cuda.max_memory_allocated()}
        return {"forward_backward": rec}

    return {"kernel": lambda: spatial_lift_cuda(maps, weight, bias),
            "plain": lambda: spatial_lift_plain(maps, weight, bias), "check": check,
            "bytes": 2 * images * (sum(math.prod(s) for s in maps_shape) + out * HW),
            "ops": 2 * images * HW * K * out, "extras": extras}


def _lift_resize_t_row(torch, dev, shape) -> dict:
    """The lift backward's gather: a random bf16 gradient of `images` x
    `out` planes at the first map's size taken onto each other map's size,
    one launch a map (timed one by one and summed), against the plain
    version's two float32 products; no element farther from the float64
    transpose than float32 sums of its taps may round (n u sum |w g|, n
    a texel's taps at most, u 2^-24); the bound: the gradient read once a
    map, each map's sums written once in float32."""
    from gennerf_tpu_torch.ops.spatial_lift import resize_transpose_cuda, resize_transpose_plain

    images, maps_shape, out = shape
    bf16 = torch.bfloat16
    g = _normal(torch, dev)(images, out, *maps_shape[0][1:]).to(bf16)
    g32 = g.float()
    H, W = maps_shape[0][1:]
    sizes = [tuple(s[1:]) for s in maps_shape[1:]]

    def check(k, _):
        beyond = 0
        for got, (h, w) in zip(k, sizes):
            # an input texel takes the output rows within two of its
            # spacings, and an edge texel the clamped ones beyond it
            taps = (3 * math.ceil(H / h) + 2) * (3 * math.ceil(W / w) + 2)
            ref = resize_transpose_plain(g.double(), (h, w), bf16)
            bound = (taps + 2) * 2.0 ** -24 * resize_transpose_plain(g.double().abs(), (h, w), bf16)
            beyond += int(((got.double() - ref).abs() > bound).sum())
            del ref, bound
        return {"beyond_f32_sum_bound": (beyond, 0)}

    parts = [(lambda hw=hw: resize_transpose_cuda(g, hw),
              lambda hw=hw: resize_transpose_plain(g32, hw, bf16)) for hw in sizes]
    return {"kernel": lambda: [k() for k, _ in parts], "plain": lambda: [p() for _, p in parts],
            "check": check, "parts": parts,
            "bytes": sum(2 * g.numel() + 4 * images * out * h * w for h, w in sizes), "ops": 0}


def _volume_sample_row(torch, dev, shape) -> dict:
    """The trilinear sample of a random f32 volume of `grid` and C channels
    (SPATIAL_CELL_VOXEL voxels) at the index'th chunk of n of its dense
    grid's points, bit-equal to the composition (trilinear_interpolation_plain)
    on the volume in f32 and in bf16; the bound: each point's row read once
    and its features written once; extras: the same on the volume in bf16, the library's
    sampler (F.grid_sample) on the same chunk and the channels-last copy
    of the volume that the kernel needs and grid_sample would not."""
    import torch.nn.functional as F

    from gennerf_tpu_torch.ops.interpolation import (
        trilinear_interpolation_cuda, trilinear_interpolation_plain,
    )
    from gennerf_tpu_torch.tools.measure import cuda_ms
    from gennerf_tpu_torch.train.predict import dense_grid_points

    grid, C, n, index = shape
    voxel = SPATIAL_CELL_VOXEL
    origin = torch.zeros(3, device=dev)
    volume = _normal(torch, dev)(1, *grid, C)
    pts = dense_grid_points(grid, voxel, origin, dev)[index * n:(index + 1) * n][None].contiguous()

    def differing(got, want) -> int:  # f32 bits (a NaN only matches the same NaN)
        return int((got.view(torch.int32) != want.view(torch.int32)).sum())

    def check(k, p):
        rec = {"differing.cell_grid_f32": (differing(k, p), 0)}
        bf16 = volume.to(torch.bfloat16)
        rec["differing.cell_grid_bf16"] = (differing(
            trilinear_interpolation_cuda(bf16, pts, origin, voxel),
            trilinear_interpolation_plain(bf16, pts, origin, voxel)), 0)
        return rec

    def extras():
        # grid_sample on the channels-first volume (grid[..., 0] indexes its
        # last axis, z), the (C, N) output transposed to the decoder's rows
        volume_cf = volume.permute(0, 4, 1, 2, 3).contiguous()
        extent = torch.tensor(grid, dtype=torch.float32, device=dev) * voxel

        def library():
            norm = 2.0 * (pts - origin) / extent - 1.0
            out = F.grid_sample(volume_cf, norm.flip(-1).reshape(1, 1, 1, n, 3), mode="bilinear",
                                padding_mode="border", align_corners=True)
            return out.reshape(1, C, n).transpose(1, 2).contiguous()

        rec = {"library_ms": cuda_ms(torch, library, 5),
               "channels_last_copy_ms": cuda_ms(
                   torch, lambda: volume_cf.permute(0, 2, 3, 4, 1).contiguous(), 3)}
        del volume_cf
        bf16 = volume.to(torch.bfloat16)
        rec["bf16_ms"] = cuda_ms(
            torch, lambda: trilinear_interpolation_cuda(bf16, pts, origin, voxel), 10, inner=5)
        return rec

    return {"kernel": lambda: trilinear_interpolation_cuda(volume, pts, origin, voxel),
            "plain": lambda: trilinear_interpolation_plain(volume, pts, origin, voxel),
            "check": check, "bytes": 2 * n * C * 4, "ops": 0, "inner": 5, "extras": extras}


def _backproject_row(torch, dev, shape) -> dict:
    """The backprojection of T random bf16 frames of C channels at (Hf, Wf)
    (the images' own size), seen by a ring of cameras, into `grid` at
    SPATIAL_CELL_VOXEL: the sum and the count of the main path's route
    (channels-first features through backproject_fold_cuda: torch's
    channels_last copy, then the kernel) bit-equal to the composition
    (backproject_fold_plain, pixels included); the kernel timed alone, on
    channels_last features and precomputed pixels; the bound: the features
    read once, the pixels read, the sum and the count written once; extras:
    the whole no_grad fold on channels-first features (the pixels, the
    copy and the kernel), the pixels alone and the copy alone."""
    from gennerf_tpu_torch.ops.projection import (
        backproject_fold, backproject_fold_cuda, backproject_fold_plain, fold_pixels,
    )
    from gennerf_tpu_torch.tools.measure import cuda_ms

    T, C, hw, grid = shape
    voxel, origin = SPATIAL_CELL_VOXEL, torch.zeros(3, device=dev)
    feat = _normal(torch, dev)(T, C, *hw).to(torch.bfloat16)
    rows = feat.contiguous(memory_format=torch.channels_last)
    P = ring_projections(torch, dev, 1, T, hw, grid, voxel, SEED)
    pixel = fold_pixels(P, hw, hw, grid, voxel, origin)

    def differing(got, want) -> int:  # f32 bits (a NaN only matches the same NaN)
        return sum(int((g.view(torch.int32) != w.view(torch.int32)).sum())
                   for g, w in zip(got, want))

    def extras():
        def fold():
            with torch.no_grad():
                return backproject_fold(feat, P, hw, grid, voxel, origin)

        return {"fold_ms": cuda_ms(torch, fold, 5),
                "pixels_ms": cuda_ms(torch, lambda: fold_pixels(P, hw, hw, grid, voxel, origin),
                                     5),
                "channels_last_copy_ms": cuda_ms(
                    torch, lambda: feat.contiguous(memory_format=torch.channels_last), 5)}

    def plain():
        return list(backproject_fold_plain(feat, P, hw, grid, voxel, origin))

    V = math.prod(grid)
    return {"kernel": lambda: list(backproject_fold_cuda(feat, pixel, grid)), "plain": plain,
            "parts": [(lambda: list(backproject_fold_cuda(rows, pixel, grid)), plain)],
            "check": lambda k, p: {"differing.cell_bf16": (differing(k, p), 0)},
            "bytes": feat.numel() * 2 + pixel.numel() * 4 + (C + 1) * V * 4, "ops": 0,
            "extras": extras}


KERNEL_ROWS = (
    KernelRow("fps", "gennerf_tpu_torch/csrc/fps.cu", "gennerf_tpu/ops/pallas/fps.py:33",
              (NUM_FRAMES, PRESAMPLE, NPOINT), (2, 64, 8), _fps_row),
    KernelRow("grid_decode", "gennerf_tpu_torch/csrc/grid_decode.cu",
              "gennerf_tpu/ops/pallas/fused_decoder.py:353",
              (DECODER_H, DECODER_BLOCKS, VOXEL_DIM), (128, 1, (3, 4, 5)), _grid_decode_row),
    KernelRow("point_decode", "gennerf_tpu_torch/csrc/point_decode.cu",
              "gennerf_tpu/ops/pallas/fused_decoder.py:53",
              (N_POINTS, DECODER_D_IN, DECODER_D_CODE, DECODER_H, DECODER_BLOCKS),
              (50, 8, 9, 128, 1), _point_decode_row),
    KernelRow("spatial_lift", "gennerf_tpu_torch/csrc/spatial_lift.cu", None,
              (LIFT_IMAGES, LIFT_MAPS, LIFT_OUT), (2, ((16, 12, 16), (32, 6, 8)), 8), _lift_row),
    KernelRow("lift_resize_t", "gennerf_tpu_torch/csrc/spatial_lift.cu", None,
              (LIFT_IMAGES, LIFT_MAPS, LIFT_OUT), (2, ((16, 12, 16), (32, 6, 8)), 8),
              _lift_resize_t_row),
    KernelRow("volume_sample", "gennerf_tpu_torch/csrc/volume_sample.cu", None,
              (SPATIAL_CELL_GRID, VS_CHANNELS, VS_CHUNK, VS_CHUNK_INDEX), ((6, 5, 4), 8, 40, 1),
              _volume_sample_row, max_ms=VS_MAX_MS),
    KernelRow("backproject", "gennerf_tpu_torch/csrc/backproject.cu", None,
              (BP_FRAMES, BP_CHANNELS, BP_HW, SPATIAL_CELL_GRID), (2, 8, (12, 16), (6, 5, 4)),
              _backproject_row),
)


def kernels_phase(torch, dev, smi: str) -> dict:
    """Phase 6 (see the module docstring); returns each row's line by the
    kernel's name."""
    GATES.phase = "kernels"
    from gennerf_tpu_torch.tools.measure import cuda_ms

    recs = {}
    for row in KERNEL_ROWS:
        x = row.make(torch, dev, row.shape)
        # the plain version first: the backprojection row's composition peaks
        # at ~62 GB, which the kernel's 12.9 GB output would push to ~75
        ref = x["plain"]()
        out = x["kernel"]()
        checks, max_abs_err = x["check"](out, ref), _max_abs(out, ref)
        del out, ref
        torch.cuda.synchronize()
        parts = x.get("parts", [(x["kernel"], x["plain"])])
        ms = sum(cuda_ms(torch, k, 10, inner=x.get("inner", 1)) for k, _ in parts)
        plain_ms = sum(cuda_ms(torch, p, 3) for _, p in parts)
        by_bytes, by_ops = x["bytes"] / PEAK_BYTES, x["ops"] / x.get("peak", PEAK_BF16)
        rec = {"phase": "kernels", "kernel": row.name, "shape": row.shape, "ms": ms,
               "plain_ms": plain_ms, "bound_ms": 1e3 * max(by_bytes, by_ops),
               "bound_by": "bytes" if by_bytes >= by_ops else "operations",
               "bytes": x["bytes"], "ops": x["ops"], "max_abs_err": max_abs_err,
               "vs_plain": {name: value for name, (value, _) in checks.items()},
               **(x["extras"]() if "extras" in x else {}), "card": smi}
        del x
        emit(rec)
        recs[row.name] = rec
        if not all([gate(f"{row.name}.{name}", value, limit)
                    for name, (value, limit) in checks.items()]):
            raise RuntimeError(f"the {row.name} kernel disagrees with its plain version: "
                               f"{rec['vs_plain']}")
        if row.max_ms is not None and not gate(f"{row.name}.ms", ms, row.max_ms):
            raise RuntimeError(f"the {row.name} kernel took {ms} ms, beyond {row.max_ms}")
    return recs


PHASES = ("kernels", "train", "data", "spatial", "voxelnet", "flagship_bf16", "distill",
          "harness", "weights_options", "model_options", "prepare", "parallel")
# the phases that read the data phase's dataset
DATASET_PHASES = {"spatial", "voxelnet", "flagship_bf16", "harness", "weights_options",
                  "model_options", "parallel"}


def write_dataset(root: str) -> float:
    """The multigeo dataset of the data phase written to `root`; seconds."""
    from gennerf_tpu_torch.data.make_multigeo import make_multigeo

    t0 = time.perf_counter()
    make_multigeo(root, train=DATA_TRAIN_SCENES, frames=DATA_FRAMES, height=HEIGHT,
                  width=WIDTH, voxel_sizes=(4, 8))
    return time.perf_counter() - t0


def parse_phases(argv: list) -> set:
    """`--phases a,b` (phases 6-17 by name, PHASES) -> that set; none: all.
    Phases 1-5 always run."""
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated phases 6-17 to run after phases 1-5 "
                         f"(default all: {','.join(PHASES)}); '' runs phases 1-5 only")
    names = {n for n in ap.parse_args(argv).phases.split(",") if n}
    unknown = names - set(PHASES)
    if unknown:
        ap.error(f"unknown phases {sorted(unknown)}; choose from {', '.join(PHASES)}")
    return names


def main(argv=None) -> int:
    phases = parse_phases(sys.argv[1:] if argv is None else argv)
    try:
        return _main(phases)
    except BaseException:
        if GATES.records:  # the margins of the gates the failed run got to
            emit(GATES.line())
        raise


def _main(phases: set) -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from gennerf_tpu_torch import set_reference_precision
    from gennerf_tpu_torch.data.synthetic import ring_frames
    from gennerf_tpu_torch.models.gen_nerf import GenNerf
    from gennerf_tpu_torch.models.resnetfc import ResnetBlockFC
    from gennerf_tpu_torch.ops import kernels
    from gennerf_tpu_torch.ops.grid_decode import grid_tables, separable_grid_decode_plain
    from gennerf_tpu_torch.ops.projection import get_3d_points
    from gennerf_tpu_torch.ops.sampling import farthest_point_sample_plain, uniform_presample
    from gennerf_tpu_torch.tools.measure import build_report, check_build
    from gennerf_tpu_torch.predict import build_model, reconstruct
    from gennerf_tpu_torch.render import render_views
    from gennerf_tpu_torch.train.predict import (
        decode_dense, dense_grid_points, predict_tsdf_volume, predict_tsdf_volume_sparse,
        uses_grid_decode,
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

    # the model of phases 2-5: full-width weights, every matrix non-zero
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
    # one encode for phases 2-5, deterministic (the scatters' atomics add in
    # one order), so the render's field shift and its march agree run to run
    with torch.no_grad(), deterministic_algorithms(torch):
        repr_ = model.encode(P[None], image[None], depth[None], torch.Generator().manual_seed(SEED))
    weights = decoder_weights(model, point=False)
    extent = [d * cfg.voxel_size for d in cfg.voxel_dim_train]
    table_args = dict(
        voxel_dim=VOXEL_DIM, voxel_size=cfg.voxel_size, num_freqs=cfg.code.num_freqs,
        freq_factor=cfg.code.freq_factor, include_input=cfg.code.include_input,
        padding=cfg.encoder.pointnet.padding, coord_center=tuple(e / 2 for e in extent),
        coord_scale=max(extent))

    # 2. predict: the main path, counters reset just before, read just after
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
    GATES.phase = "predict"
    if not grid_gates("vs_plain_stages", pred_max, pred_mean):
        raise RuntimeError(f"predict disagrees with its plain stages: max {pred_max}, mean {pred_mean}")

    # 3. render: a random field need not cross zero, so lin_out's bias moves
    # along the head until the median pre-tanh head of the plain decode over
    # the grid is 0
    tables = grid_tables(repr_.planes["xz"][0], repr_.planes["xy"][0], repr_.planes["yz"][0],
                         origin, weights, **table_args)
    median = float(separable_grid_decode_plain(tables, weights, bf16_feeds=True).median())
    del tables
    d_geo = cfg.mlp.d_out_geo
    with torch.no_grad():
        shift = -math.atanh(median / smoothing)
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
    # the same march on the plain bf16-feed decode, on the phases' encode
    # (the shift moved only the decoder)
    march = k3_march(torch, model, repr_, depth, intrinsics, poses, NUM_VIEWS)
    render_ms = host_ms(torch, lambda: render_views(
        *render_args, num_views=NUM_VIEWS, generator=torch.Generator().manual_seed(SEED)), 3)
    rays = HEIGHT * WIDTH
    emit({"phase": "render", "config": "configs/experiment/seqs_multigeo_4cm.yaml",
          "views": [int(v) for v in out["views"]], "image": [HEIGHT, WIDTH],
          "launches": render_launches, "point_decode_launches_per_view":
          render_launches["point_decode"] / NUM_VIEWS,
          "point_decode_points_per_view": rays * (16 + 8 + 4),
          "first_call_ms": render_first_ms, "render_views_ms": render_ms,
          "host_ms_per_view": render_ms / NUM_VIEWS,
          "rays_per_s": NUM_VIEWS * rays / (render_ms / 1e3),
          "hit_share": [float(h) for h in hit_share], "k3_march": march,
          "tolerance": {"mask_agree": RENDER_MASK_AGREE, "depth_m": RENDER_DEPTH_TOL,
                        "depth_agree": RENDER_DEPTH_AGREE},
          "eval_depth_random_weights_not_quality": out["mean"], "card": smi})
    GATES.phase = "render"
    if not march_gates("k3_march", march, min_hits=False):
        raise RuntimeError(f"kernel march disagrees with the plain march: {march}")

    # 4. mesh: the render phase's weights cross zero inside the grid
    mesh_launches, mesh_rec = mesh_phase(torch, dev, model, (P, image, depth), planes_ref,
                                         table_args, smi)
    emit(mesh_rec)

    # 5. predict_sparse: the band decode through the user entry point, then
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
    GATES.phase = "predict_sparse"
    if not gate("vs_dense_max_abs", sparse_err, SPARSE_TOL):
        raise RuntimeError(f"sparse band decode disagrees with the dense decode: {sparse_err}")

    # 6. kernels: each kernel alone against its plain version's time and its bound
    timed = kernels_phase(torch, dev, smi) if "kernels" in phases else {}
    # 7.-17.: each returns its main-path launches (and its kernels' errors
    # against their plain versions); `phases` picks which run
    runs = {}
    if "train" in phases:
        runs["train"] = train_phase(torch, dev, cfg_dict, smi), {}
    with tempfile.TemporaryDirectory() as data_tmp:
        root, synth = os.path.join(data_tmp, "multigeo"), os.path.join(data_tmp, "synth0")
        if "data" in phases:
            # 8. data: the on-disk dataset through the loaders into training,
            # then held-out predict and render from the trained weights
            runs["data"] = data_phase(torch, dev, smi, root), {}
        elif phases & DATASET_PHASES:
            write_dataset(root)
        if "distill" not in phases and "model_options" in phases:
            from gennerf_tpu_torch.data.synthetic import generate_scene

            generate_scene(synth, num_frames=DISTILL_FRAMES)
        for name, fn in (
                # 9. spatial: the ResNet feature volume beside the triplanes,
                # trained on the same dataset, then a held-out reconstruct and
                # a dense decode of the spatial cell's grid
                ("spatial", lambda: spatial_phase(torch, dev, smi, root)),
                # 10. voxelnet: the second model family in bf16-mixed on the
                # same dataset, then a held-out predict and evaluation
                ("voxelnet", lambda: voxelnet_phase(torch, dev, smi, root)),
                # 11. flagship_bf16: the flagship GenNerf in bf16-mixed, its
                # eikonal and frustum children and the gradient loss on the
                # same dataset, then a held-out predict, the flagship's grid,
                # a render
                ("flagship_bf16", lambda: flagship_bf16_phase(torch, dev, smi, root)),
                # 12. distill: both distillation experiments through the train
                # CLI on their synthetic scene, K2 and K3 on the trained head,
                # use_auxiliary
                ("distill", lambda: distill_phase(torch, dev, smi, synth)),
                # 13. harness: the train CLI's harness (early stopping, batch
                # limits, the profiler window, the loggers, the SIGTERM save,
                # the sweep) on the data phase's dataset
                ("harness", lambda: harness_phase(torch, dev, smi, root)),
                # 14. weights_options: a reference checkpoint through the CLIs'
                # --params (K1, K2, K3), the writer and reader round trip, the
                # spatial and VoxelNet readers, the GenNerf options on the card
                # against the CPU, PointNet++'s K1
                ("weights_options", lambda: weights_options_phase(torch, dev, smi, root)),
                # 15. model_options: VoxelNet's GroupNorm, dropout and loss
                # split, the spatial norm_type and upsample, the GenNerf options
                # and distillation in bf16-mixed (K1, K2, K3)
                ("model_options", lambda: model_options_phase(torch, dev, smi, root, synth)),
                # 16. prepare: a raw ScanNet .sens through export and
                # preparation (fusion on the card), then the flagship trained
                # on it (K1, K2, K3)
                ("prepare", lambda: prepare_phase(torch, dev, smi,
                                                  os.path.join(data_tmp, "prepare"))),
                # 17. parallel: the process group (NCCL at world size 1, 2 ranks
                # on the card over gloo, NCCL at 2 on two cards), the
                # data-parallel steps against world size 1, K2's x-slab split,
                # host prefetch
                ("parallel", lambda: parallel_phase(torch, dev, smi, root))):
            if name in phases:
                runs[name] = fn()

    def main_path_launches(kernel: str):
        """Every main-path launch of `kernel` the run counted (None where
        the phase that counts it did not run)."""
        if kernel in launches:  # a TPU-kernel port: phases 2-5 and every phase run
            return (launches[kernel] + render_launches[kernel] + mesh_launches[kernel]
                    + sparse_launches[kernel] + sum(l_[kernel] for l_, _ in runs.values()))
        if kernel in ("volume_sample", "backproject"):
            return runs["spatial"][1][f"{kernel}_launches"] if "spatial" in runs else None
        return runs["voxelnet"][1]["lift_launches"][kernel] if "voxelnet" in runs else None

    def worst(kernel: str):
        """The largest error against its plain version a phase recorded."""
        return max([errors_[kernel] for _, errors_ in runs.values() if kernel in errors_]
                   + ([timed[kernel]["max_abs_err"]] if kernel in timed else []), default=None)

    kernel_line = {"kernels": [
        {"name": row.name, "route": "cuda", "source": row.source, "replaces": row.replaces,
         "launches": main_path_launches(row.name), "max_abs_err": worst(row.name),
         **{k: timed.get(row.name, {}).get(k) for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                                         "library_ms")}}
        for row in KERNEL_ROWS]}
    emit(GATES.line())
    emit(kernel_line)
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
