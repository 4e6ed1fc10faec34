"""The port's predict slice on the CPU: `reconstruct` (encode -> separable
grid decode -> fusion prior) against the JAX GenNerfTask.reconstruct, the
dispatch and prior pieces against their JAX counterparts, the CLI, and the
rule that the port imports nothing of JAX or the JAX package.

Sizes are small (2 frames of 12x16, c_dim 8, H 32, 2 blocks, a 16x16x8
grid). The JAX encoder's draws (presample from split(PRNGKey(0))[1], FPS
start from the split-off key) are injected into the port. The volumes
agree within 1e-4 absolute: float32 through encode and decode in another
summation order.
"""
import ast
import os
import shutil
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gennerf_tpu.models.gen_nerf import SceneRepr as JRepr
from gennerf_tpu.train import predict as jpred
from gennerf_tpu.train.tasks import GenNerfTask
from gennerf_tpu.tsdf.fusion import apply_fusion_prior as j_prior
from gennerf_tpu_torch.data.synthetic import ring_frames
from gennerf_tpu_torch.models.config import GenNerfConfig, config_from_dict
from gennerf_tpu_torch.models.gen_nerf import GenNerf, SceneRepr
from gennerf_tpu_torch.predict import build_model, main, reconstruct
from gennerf_tpu_torch.train import predict as tpred
from gennerf_tpu_torch.tsdf.fusion import apply_fusion_prior, prior_classes
from gennerf_tpu_torch.utils.port_params import gen_nerf_params_from_flax, save_params_npz

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL = 1e-4
VOXEL_DIM = (16, 16, 8)
CFG = {
    "type": "GenNerf", "voxel_size": 0.08,
    "voxel_dim_train": [16, 16, 8], "voxel_dim_val": [16, 16, 8], "voxel_dim_test": [16, 16, 8],
    "encoder": {
        "use_spatial": False, "use_pointnet": True,
        "pointnet": {"num_sparse_points": 32, "fps_presample": 64, "normalize_coords": True,
                     "c_dim": 8, "hidden_dim": 8, "plane_resolution": 16, "n_blocks": 2,
                     "unet": True, "unet_kwargs": {"depth": 2, "merge_mode": "concat",
                                                   "start_filts": 8}},
    },
    "mlp": {"d_out_sem": 1, "d_out_geo": 8, "n_blocks": 2, "d_hidden": 32,
            "alpha": 0.7, "head_smoothing": 1.05},
    "code": {"num_freqs": 6, "freq_factor": 0.5, "include_input": True},
}
PRIMS = [{"type": "sphere", "center": (0.6, 0.7, 0.25), "radius": 0.25},
         {"type": "box", "min": (0.75, 0.3, 0.0), "max": (1.0, 0.55, 0.3)}]


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(autouse=True)
def _f32_highest():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with jax.default_matmul_precision("highest"):
        yield


@pytest.fixture(scope="module")
def scene():
    P, image, depth = ring_frames(2, 12, 16, (0.64, 0.64, 0.25), PRIMS, camera_radius=1.4,
                                  camera_height=0.8)
    return P, image, depth


@pytest.fixture(scope="module")
def task_pair(scene):
    """JAX task + state (Dense_1 randomized, alpha 0.7) and the port model
    with the same weights."""
    P, image, depth = scene
    batch = {"projection": P[None], "image": image[None], "depth": depth[None]}
    with jax.default_matmul_precision("highest"):
        task = GenNerfTask(CFG)
        # the jitted init of GenNerfTask.init_state (its eager init is slow)
        variables = jax.jit(task.model.init, static_argnums=(6,))(
            jax.random.PRNGKey(0), jnp.asarray(P[None]), jnp.asarray(image[None]),
            jnp.asarray(depth[None]), jnp.zeros((1, 8, 3)), jax.random.PRNGKey(0),
            VOXEL_DIM, jnp.zeros(3))
    rng = np.random.default_rng(5)
    tree = jax.tree.map(np.asarray, dict(variables["params"]))

    def randomize(node):
        for k, v in node.items():
            if isinstance(v, dict):
                if k == "Dense_1":
                    v["kernel"] = (0.2 * rng.standard_normal(v["kernel"].shape)).astype(np.float32)
                    v["bias"] = (0.1 * rng.standard_normal(v["bias"].shape)).astype(np.float32)
                else:
                    randomize(v)

    randomize(tree)
    tree["mlp"]["alpha"] = np.asarray(0.7, np.float32)
    state = types.SimpleNamespace(params=jax.tree.map(jnp.asarray, tree), batch_stats={})
    model = GenNerf(config_from_dict(GenNerfConfig, CFG))
    model.load_state_dict(gen_nerf_params_from_flax(tree))
    return task, state, batch, tree, model.eval()


def _jax_draws(BT, N, presample):
    key_fps, k_pre = jax.random.split(jax.random.PRNGKey(0))
    sel = jax.random.randint(k_pre, (BT, presample), 0, N)
    start = jax.random.randint(key_fps, (BT,), 0, presample)
    return _t(sel), _t(start)


def test_reconstruct_matches_jax(task_pair, scene):
    task, state, batch, _, model = task_pair
    P, image, depth = scene
    with jax.default_matmul_precision("highest"):
        pred, trgt = task.reconstruct(state, batch)
    assert trgt is None
    ref = np.asarray(pred.tsdf_vol)
    sel, start = _jax_draws(2, 12 * 16, 64)
    assert tpred.uses_grid_decode(model)
    ours = reconstruct(model, P, image, depth, sel=sel, start=start)
    assert ours.dtype == torch.float32 and tuple(ours.shape) == VOXEL_DIM
    np.testing.assert_allclose(ours.numpy(), ref, atol=ATOL, rtol=0)
    # the scene exercises all three prior classes and the decoded band
    near = (np.abs(ref) < 1.0) & (ref != 1.0) & (ref != -1.0)
    assert near.any() and (ref == 1.0).any() and (ref == -1.0).any()


def test_predict_tsdf_volume_dense_vs_grid(task_pair, rng):
    """The chunked per-point decode and the separable grid decode give the
    same volume, and each matches its JAX counterpart."""
    task, state, _, tree, model = task_pair
    planes = {k: (0.5 * rng.standard_normal((1, 8, 16, 16))).astype(np.float32) for k in ("xz", "xy", "yz")}
    repr_t = SceneRepr({k: _t(v) for k, v in planes.items()})
    origin = np.array([0.04, -0.02, 0.0], np.float32)
    grid = tpred.predict_tsdf_volume(model, repr_t, VOXEL_DIM, 0.08, _t(origin))
    pts = tpred.dense_grid_points(VOXEL_DIM, 0.08, _t(origin))
    dense = tpred.decode_dense(model, repr_t, pts, chunk_size=500).reshape(VOXEL_DIM)
    np.testing.assert_allclose(grid.numpy(), dense.numpy(), atol=ATOL, rtol=0)
    variables = {"params": state.params, "batch_stats": state.batch_stats}
    repr_j = JRepr(None, None, {k: jnp.asarray(v) for k, v in planes.items()})
    with jax.default_matmul_precision("highest"):
        ref_pts = jpred.dense_grid_points(VOXEL_DIM, 0.08, origin)
        ref_dense = jpred.decode_dense(task.model, variables, repr_j, ref_pts, jnp.asarray(origin))
    np.testing.assert_array_equal(pts.numpy(), np.asarray(ref_pts))
    np.testing.assert_allclose(dense.reshape(-1).numpy(), np.asarray(ref_dense), atol=ATOL, rtol=0)


def test_nonzero_head_bias_goes_dense(task_pair, rng):
    """A trained head has a bias: the grid decode folds it into its last
    scalar, so the dispatch keeps the grid decode, and the volume matches
    the JAX f32 decode_dense of the same weights (the bound of
    test_predict_tsdf_volume_dense_vs_grid)."""
    task, state, _, tree, model = task_pair
    m2 = GenNerf(model.cfg)
    m2.load_state_dict(model.state_dict())
    with torch.no_grad():
        m2.head_geo.fc.bias.fill_(0.1)
    assert tpred.uses_grid_decode(model) and tpred.uses_grid_decode(m2.eval())
    planes = {k: (rng.standard_normal((1, 8, 16, 16))).astype(np.float32) for k in ("xz", "xy", "yz")}
    origin = np.array([0.04, -0.02, 0.0], np.float32)
    vol = tpred.predict_tsdf_volume(m2, SceneRepr({k: _t(v) for k, v in planes.items()}), VOXEL_DIM,
                                    0.08, _t(origin))
    params = jax.tree.map(np.asarray, dict(state.params))
    params["head_geo"] = {"Dense_0": dict(params["head_geo"]["Dense_0"],
                                          bias=np.full(1, 0.1, np.float32))}
    variables = {"params": jax.tree.map(jnp.asarray, params), "batch_stats": state.batch_stats}
    repr_j = JRepr(None, None, {k: jnp.asarray(v) for k, v in planes.items()})
    with jax.default_matmul_precision("highest"):
        ref = jpred.decode_dense(task.model, variables, repr_j,
                                 jpred.dense_grid_points(VOXEL_DIM, 0.08, origin), jnp.asarray(origin))
    np.testing.assert_allclose(vol.reshape(-1).numpy(), np.asarray(ref), atol=ATOL, rtol=0)
    base = tpred.predict_tsdf_volume(model, SceneRepr({k: _t(v) for k, v in planes.items()}),
                                     VOXEL_DIM, 0.08, _t(origin))
    assert (vol - base).abs().max() > 1e-3  # the bias moved the volume


def test_fusion_prior_matches_jax(scene, rng):
    P, _, depth = scene
    vol = rng.uniform(-1, 1, VOXEL_DIM).astype(np.float32)
    origin = np.array([0.0, 0.0, 0.0], np.float32)
    ref = j_prior(jnp.asarray(vol), 0.08, jnp.asarray(origin), jnp.asarray(P), jnp.asarray(depth))
    ours = apply_fusion_prior(_t(vol), 0.08, _t(origin), _t(P), _t(depth))
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))
    near, farfront = prior_classes(VOXEL_DIM, 0.08, _t(origin), 0.24, _t(P), _t(depth))
    assert near.any() and farfront.any()


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("only meaningful without a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model(CFG)
    assert next(build_model(CFG, device="cpu").parameters()).device.type == "cpu"


def test_cli_on_cpu(task_pair, scene, tmp_path):
    """`python -m gennerf_tpu_torch.predict` end to end on a copied configs
    tree with a small experiment, JAX params from an npz."""
    _, _, _, tree, model = task_pair
    P, image, depth = scene
    shutil.copytree(os.path.join(REPO, "configs"), tmp_path / "configs")
    (tmp_path / "configs" / "experiment" / "tiny_port.yaml").write_text(
        "defaults:\n  - overfit_synthetic\n"
        "model:\n  encoder:\n    pointnet:\n      num_sparse_points: 32\n      fps_presample: 64\n"
        "      c_dim: 8\n      hidden_dim: 8\n      plane_resolution: 16\n      n_blocks: 2\n"
        "      unet_kwargs: {depth: 2, merge_mode: concat, start_filts: 8}\n"
        "  mlp: {d_out_geo: 8, d_out_sem: 1, n_blocks: 2, d_hidden: 32, alpha: 0.7, head_smoothing: 1.05}\n"
        "data:\n  voxel_size: 0.08\n  voxel_dim_train: [16, 16, 8]\n  voxel_dim_test: [16, 16, 8]\n")
    save_params_npz(str(tmp_path / "params.npz"), tree)
    np.savez(tmp_path / "frames.npz", projection=P, image=image, depth=depth)
    main(["--config", str(tmp_path / "configs" / "experiment" / "tiny_port.yaml"),
          "--params", str(tmp_path / "params.npz"), "--frames", str(tmp_path / "frames.npz"),
          "--out", str(tmp_path / "out.npz"), "--device", "cpu"])
    with np.load(tmp_path / "out.npz") as out:
        vol = out["tsdf"]
    expect = reconstruct(model, P, image, depth, generator=torch.Generator().manual_seed(0))
    np.testing.assert_array_equal(vol, expect.numpy())


FORBIDDEN = ("jax", "jaxlib", "flax", "gennerf_tpu", "PIL", "skimage", "cv2", "scipy",
             "torchvision")


def test_port_imports_no_jax():
    """Importing the port and every submodule pulls in no jax, flax or
    gennerf_tpu module, no PIL, skimage or cv2 (the card's machine has
    none of them), no scipy and no torchvision; meshing, the KD-tree and the rasterizer
    then load nothing from the repo's native/ (the port builds its own
    host library); and chip_smoke.py imports none of them."""
    code = (
        "import importlib, os, pkgutil, sys, numpy as np, gennerf_tpu_torch\n"
        "for m in pkgutil.walk_packages(gennerf_tpu_torch.__path__, 'gennerf_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "from gennerf_tpu_torch.eval.metrics import eval_mesh\n"
        "from gennerf_tpu_torch.tsdf.tsdf import TSDF\n"
        "from gennerf_tpu_torch.utils.native import rasterize_depth\n"
        "import torch\n"
        "x = torch.linspace(-1, 1, 6)\n"
        "mesh = TSDF(0.1, torch.zeros(1, 3), (x[:, None, None] + 0 * x[None, :, None]\n"
        "            + 0 * x[None, None, :]).contiguous()).get_mesh()\n"
        "eval_mesh(mesh, mesh)\n"
        "rasterize_depth(mesh.vertices, mesh.faces, np.eye(3), np.eye(4), 4, 4)\n"
        f"bad = [k for k in sys.modules if k.split('.')[0] in {FORBIDDEN!r}]\n"
        "native = os.path.join(os.getcwd(), 'native') + os.sep\n"
        "maps = [line.split()[-1] for line in open('/proc/self/maps') if '/' in line]\n"
        "print(len([k for k in sys.modules if k.startswith('gennerf_tpu_torch')]), len(mesh),\n"
        "      bad, sorted({m for m in maps if m.startswith(native)}))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=120, env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
    assert out.returncode == 0, out.stderr
    n_modules, n_verts, rest = out.stdout.strip().split(" ", 2)
    assert int(n_modules) >= 20 and int(n_verts) > 0 and rest == "[] []", out.stdout
    with open(os.path.join(REPO, "chip_smoke.py")) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names = [node.module]
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, name
