"""Semantic distillation and the teacher volume (use_auxiliary) under
bf16-mixed, in the port against the JAX package's op-by-op bf16 on the
CPU: the encode and decode of a teacher-volume model
(tests/test_torch_options_bf16.py's check), a train step in surface
mode with the teacher volume against `jax.value_and_grad` of the JAX
`gen_nerf_forward_loss` in bf16 (tests/test_torch_options_bf16_steps.py's
check), and render mode's march through the bf16 field
(`render_distill_points`, its pixel scores injected as JAX's
fold_in(k_sample, 7) draw) against the JAX step's. Under bf16 the teacher
computes in float32 (it takes no dtype), feat_sem comes out of ResnetFC
in float32, the distillation loss runs in float32 and the teacher's
channels go into the float32 volume, in both packages.

Sizes, draws and bounds are those files' (stated there): the options
config of tests/test_torch_options.py with an 8-channel random-projection
teacher (patch 8, stride 4) and 8 semantic channels; the march at
tests/test_torch_distill_render.py's sizes.
"""
import jax
import numpy as np
import torch

from gennerf_tpu.train.tasks import GenNerfTask
from gennerf_tpu_torch.models.config import GenNerfConfig, config_from_dict
from gennerf_tpu_torch.train.step import batch_to_device, render_distill_points
from gennerf_tpu_torch.train.tasks import GenNerfTask as TTask
from gennerf_tpu_torch.utils.port_params import gen_nerf_params_from_flax
from test_torch_distill import (  # noqa: F401
    T, VOXEL_DIM, _close, cfg_dict, full_batch, jax_params, step_draws,
)
from test_torch_distill_render import MARCH, RR, centred, jax_render_branch
from test_torch_options import _f32_highest  # noqa: F401
from test_torch_options_bf16 import check_encode_decode
from test_torch_options_bf16_steps import STRICT_BF16, check_step

import _torch_threads  # noqa: F401  (sizes torch's threads per xdist worker)


def test_encode_decode_bf16():
    """The teacher-volume model, whose volume holds the teacher's channels
    (distillation adds no module to the encode or the decode: its
    semantic channels are ResnetFC's, held in the step below)."""
    check_encode_decode("auxiliary")


def test_train_step_bf16():
    """Surface-mode distillation with the teacher volume: one step."""
    check_step("distill_surface", "auxiliary")


def test_render_march_bf16(full_batch):
    """Render mode's supervision under bf16: `render_distill_points` of a
    bf16 model against the JAX step's march replayed op by op in bf16
    (tests/test_torch_distill_render.py's `jax_render_branch`, its sizes
    and its centred field): the same pixels, the same hit masks, and the
    points where both hit within 1e-5 of their largest magnitude (float32
    march arithmetic on the same bf16 field values). The JAX march is
    compiled to op-by-op bf16 arithmetic (tests/test_torch_options_bf16_steps.py's
    STRICT_BF16); a step through it would take a third of this file's
    budget, so the step is the surface one above."""
    cfg = cfg_dict("render", **MARCH)
    task, params, _ = jax_params(cfg, full_batch)
    params = centred(task, params, full_batch)
    key = jax.random.PRNGKey(21)
    task16 = GenNerfTask(cfg, "bf16-mixed")
    hit_j, _, pts_j, _, h_j, w_j = jax.jit(
        lambda p: jax_render_branch(task16, p, full_batch, key)).lower(params).compile(
        compiler_options=STRICT_BF16)(params)
    hit_j = np.asarray(hit_j)
    assert 0.1 < hit_j.mean() < 0.9
    model = TTask.build(config_from_dict(GenNerfConfig, cfg), torch.bfloat16)
    model.load_state_dict(gen_nerf_params_from_flax(params))
    draws = step_draws(key, cfg)
    tb = batch_to_device(full_batch, "cpu")
    with torch.no_grad():
        repr_ = model.encode(tb["projection"], tb["image"], tb["depth"], sel=draws.sel,
                             start=draws.start, voxel_dim=VOXEL_DIM)
    assert repr_.planes["xz"].dtype == torch.bfloat16
    points, h, w, _, hit = render_distill_points(model, tb, repr_, torch.zeros(3), VOXEL_DIM,
                                                 scores=draws.render_scores)
    np.testing.assert_array_equal(h.numpy(), np.asarray(h_j))
    np.testing.assert_array_equal(w.numpy(), np.asarray(w_j))
    np.testing.assert_array_equal(hit.numpy(), hit_j)
    assert points.dtype == torch.float32
    _close(points[0].reshape(T, RR, 3)[hit], np.asarray(pts_j)[0].reshape(T, RR, 3)[hit_j],
           name="points")
