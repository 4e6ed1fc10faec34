"""The port's logging and console surface against the JAX package's, byte
for byte, on the CPU: CRC32C, the tfevents writer (scalars, an image,
hparams, a mesh), the `MetricsLogger` backend choice and fan-out,
`log_hyperparameters` and `summarize_params` on a tiny GenNerf whose
weights the JAX model's init gave, the optional trackers (fake modules),
the progress line, the config tree, tags and `extras`, the shaded renders
of a fused ground-truth mesh and the sweep's trial points.

The wall clock (`time.time`) and the host name are patched on both sides.
The JAX PNG encoder prefers PIL, whose bytes differ from the
dependency-free writer's; the JAX side runs with PIL hidden, so that both
take the same writer (the one the port copies). Equality is exact
throughout, but for the camera pose (1e-6, float arithmetic of numpy).
"""
import importlib.util
import io
import os
import shutil
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from gennerf_tpu.train import callbacks as jcallbacks
from gennerf_tpu.train import loggers as jloggers
from gennerf_tpu.train.state import param_count
from gennerf_tpu.train.tasks import GenNerfTask
from gennerf_tpu.utils import console as jconsole
from gennerf_tpu.utils import visuals as jvisuals
from gennerf_tpu.utils.mesh import Mesh as JMesh
from gennerf_tpu_torch.data.datasets import load_info_json
from gennerf_tpu_torch.data.make_multigeo import make_multigeo
from gennerf_tpu_torch.data.synthetic import training_batch
from gennerf_tpu_torch.models.config import GenNerfConfig, config_from_dict
from gennerf_tpu_torch.models.gen_nerf import GenNerf
from gennerf_tpu_torch.train import callbacks, loggers, sweep
from gennerf_tpu_torch.utils import console, visuals
from gennerf_tpu_torch.utils.config import load_experiment_config
from gennerf_tpu_torch.utils.mesh import Mesh
from gennerf_tpu_torch.utils.port_params import gen_nerf_params_from_flax

import _torch_threads  # noqa: F401  (sizes torch's threads per xdist worker)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODEL = {
    "type": "GenNerf", "voxel_size": 0.08, "voxel_dim_train": [16, 16, 8],
    "voxel_dim_val": [16, 16, 8], "voxel_dim_test": [16, 16, 8],
    "encoder": {"use_spatial": False, "use_pointnet": True,
                "pointnet": {"num_sparse_points": 16, "fps_presample": 32, "c_dim": 8,
                             "hidden_dim": 8, "plane_resolution": 8, "n_blocks": 2,
                             "unet": True, "unet_kwargs": {"depth": 2, "merge_mode": "concat",
                                                           "start_filts": 8}}},
    "mlp": {"d_out_sem": 1, "d_out_geo": 8, "n_blocks": 2, "d_hidden": 16},
}


@pytest.fixture
def frozen(monkeypatch):
    """A fixed wall clock and host name, and the JAX PNG writer without PIL."""
    monkeypatch.setattr(loggers.time, "time", lambda: 1700000000.25)
    monkeypatch.setattr(loggers.socket, "gethostname", lambda: "host")
    monkeypatch.setitem(sys.modules, "PIL", None)


def _tree(root):
    """{relative path: bytes} of every file under root."""
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            path = os.path.join(d, f)
            with open(path, "rb") as fh:
                out[os.path.relpath(path, root)] = fh.read()
    return out


@pytest.fixture(scope="module")
def gt_mesh(tmp_path_factory):
    """The fused 8 cm ground truth of a multigeo scene (coloured by the
    colour fusion), as both packages' Mesh, and the scene's first two
    views."""
    root = str(tmp_path_factory.mktemp("multigeo"))
    make_multigeo(root, train=1, frames=3, height=24, width=32, voxel_sizes=(8,))
    info = load_info_json(os.path.join(root, "scans", sorted(os.listdir(
        os.path.join(root, "scans")))[0], "info.json"))
    mesh = Mesh.load(info["file_name_mesh_gt"])
    frames = [(np.array(f["intrinsics"]), np.array(f["pose"])) for f in info["frames"][:2]]
    return mesh, JMesh(mesh.vertices, mesh.faces, mesh.vertex_colors), frames


@pytest.fixture(scope="module")
def tiny_gennerf():
    """The JAX GenNerf's init params and the port's model carrying them."""
    task = GenNerfTask(MODEL)
    b = training_batch(1, 2, 24, 32, (16, 16, 8), 0.08, seed=3)
    variables = jax.jit(task.model.init, static_argnums=(6,))(
        jax.random.PRNGKey(0), jnp.asarray(b["projection"]), jnp.asarray(b["image"]),
        jnp.asarray(b["depth"]), jnp.zeros((1, 8, 3)), jax.random.PRNGKey(0), (16, 16, 8),
        jnp.zeros(3))
    params = jax.tree.map(lambda a: np.array(a, np.float32), dict(variables["params"]))
    model = GenNerf(config_from_dict(GenNerfConfig, MODEL))
    model.load_state_dict(gen_nerf_params_from_flax(params))
    return params, model


def test_crc32c_known_vectors():
    """The CRC-32C check value and the RFC 3720 vectors; the masked CRC as
    the JAX writer's on random bytes of lengths that take each of the
    port's paths (the byte loop below 16 KiB, numpy chunks above)."""
    assert loggers._crc32c(b"") == 0
    assert loggers._crc32c(b"123456789") == 0xE3069283
    assert loggers._crc32c(bytes(32)) == 0x8A9136AA
    assert loggers._crc32c(bytes([0xFF] * 32)) == 0x62A8AB43
    assert loggers._crc32c(bytes(range(32))) == 0x46DD794E
    data = np.random.default_rng(0).integers(0, 256, 300_001, dtype=np.uint8).tobytes()
    # the byte loop, the chunked version at 1024 and at 4096 chunks, and
    # zero-padded chunks
    for n in (1, 7, 64, 1000, (1 << 14) - 1, 1 << 14, 20_011, (1 << 18) - 1, 1 << 18, 300_001):
        assert loggers._masked_crc(data[:n]) == jloggers._masked_crc(data[:n]), n
    assert loggers._crc32c(bytes(40_000)) == jloggers._crc32c(bytes(40_000))


def test_tensorboard_writer_is_byte_identical(frozen, tmp_path, gt_mesh):
    """Scalars, a float and a CHW uint8 image, nested hparams and a mesh
    with and without colours: the same events file, byte for byte."""
    mesh = gt_mesh[0]
    files = []
    for mod, name in ((loggers, "port"), (jloggers, "jax")):
        rng = np.random.default_rng(1)
        colors = rng.integers(0, 256, (len(mesh.vertices), 3), dtype=np.uint8)
        tb = mod.TensorBoardLogger(str(tmp_path / name))
        tb.log_metrics({"train_combined": 0.5, "lr": np.float32(1e-3)}, step=3)
        tb.log_metrics({"val_combined": 0.25}, step=0)
        tb.log_image("val_render/overview", rng.random((6, 10, 3)).astype(np.float32), step=2)
        tb.log_image("val_render/frame0", np.arange(3 * 4 * 5, dtype=np.uint8).reshape(3, 4, 5))
        tb.log_hparams({"model": {"mlp": {"d_hidden": 16}, "name": None}, "tags": ["dev"],
                        "seed": 1, "flag": True, "lr": 1e-3})
        tb.log_mesh("val_mesh/pred", mesh.vertices, mesh.faces, step=4)
        tb.log_mesh("val_mesh/trgt", mesh.vertices, mesh.faces, colors, step=5)
        files.append(_tree(str(tmp_path / name)))
    assert list(files[0]) == ["tensorboard/events.out.tfevents.1700000000.host"]
    assert files[0] == files[1]


@pytest.mark.parametrize("group", ["csv", "many_loggers", "tensorboard_mesh", "none"])
def test_metrics_logger_fans_out_as_jax(frozen, tmp_path, gt_mesh, group):
    """The backends of a `logger` group (none: the CSV default) and the
    fan-out of log_metrics, log_hparams, log_image and log_mesh write the
    same files under the same names."""
    cfg = {}
    if group != "none":
        with open(os.path.join(REPO, "configs", "logger", group + ".yaml")) as f:
            cfg = yaml.safe_load(f)
    mesh_port, mesh_jax, _ = gt_mesh
    trees = []
    for mod, mesh, name in ((loggers, mesh_port, "port"), (jloggers, mesh_jax, "jax")):
        out = str(tmp_path / name)
        group_cfg = {k: {kk: out if vv == "${paths.output_dir}" else vv for kk, vv in v.items()}
                     for k, v in cfg.items()}
        ml = mod.MetricsLogger(out, group_cfg)
        ml.log_hparams({"model": {"lr": 1e-3}, "seed": 0})
        ml.log_metrics({"train_combined": 1.5, "epoch": 0}, 1)
        ml.log_metrics({"train_combined": 1.25, "val_combined": 2.0, "epoch": 1}, 2)
        ml.log_image("val_render/frame0", np.full((4, 6, 3), 7, np.uint8), step=1)
        ml.log_mesh("val_mesh/val_pred_mesh", mesh, step=1)
        trees.append(_tree(out))
    assert trees[0] == trees[1]
    assert ("csv/metrics.csv" in trees[0]) == (group != "tensorboard_mesh")
    assert any(k.startswith("tensorboard/") for k in trees[0]) == (group != "csv"
                                                                  and group != "none")


def test_log_hyperparameters_as_jax(tiny_gennerf):
    """The hparams a tiny GenNerf's run logs, its parameter counts those of
    the JAX params tree (param_count)."""
    params, model = tiny_gennerf
    cfg = load_experiment_config(os.path.join(REPO, "configs", "experiment",
                                              "seqs_multigeo_4cm.yaml"), "train", [])
    got = []

    class Sink:
        def log_hparams(self, h):
            got.append(h)

    loggers.log_hyperparameters(cfg, model, Sink())
    jloggers.log_hyperparameters(cfg, params, Sink())
    assert got[0] == got[1]
    assert got[0]["model/params/total"] == param_count(params) == sum(
        p.numel() for p in model.parameters())
    assert got[0]["model/params/non_trainable"] == 0 and got[0]["tags"] == cfg["tags"]


def test_summarize_params_totals_as_jax(tiny_gennerf):
    """The totals footer (count and size) equals the JAX table's; each
    depth aggregates the same parameters."""
    params, model = tiny_gennerf
    for depth in (-1, 1, 2):
        ours = callbacks.summarize_params(model, depth).splitlines()
        ref = jcallbacks.summarize_params(params, depth).splitlines()
        assert ours[-1].split()[1:] == ref[-1].split()[1:], (ours[-1], ref[-1])
        assert ours[0].split() == ref[0].split() and set(ours[1]) == {"-"}
    assert "mlp" in callbacks.summarize_params(model, 1)


class _Recorder(types.ModuleType):
    """A fake tracker package: every attribute, item and call result is
    another recorder; calls and item assignments are recorded by name."""

    def __init__(self, name, calls):
        super().__init__(name)
        self._calls = calls

    def __getattr__(self, attr):
        if attr.startswith("__"):
            raise AttributeError(attr)
        return _Recorder(f"{self.__name__}.{attr}", self._calls)

    def __call__(self, *a, **k):
        self._calls.append((self.__name__, a, tuple(sorted(k.items()))))
        return _Recorder(self.__name__ + "()", self._calls)

    def __setitem__(self, key, value):
        self._calls.append((f"{self.__name__}[{key}]=", (repr(value),), ()))

    def __getitem__(self, key):
        return _Recorder(f"{self.__name__}[{key}]", self._calls)


def test_optional_backends_with_fake_modules(monkeypatch, tmp_path):
    """Each tracker adapter, given a fake package, makes the same calls as
    the JAX adapter; a missing package warns and is skipped (wandb: CSV
    instead)."""
    cfg = {"wandb": {"project": "p", "mode": "offline"}, "mlflow": {"tracking_uri": "u",
                                                                     "experiment_name": "e"},
           "neptune": {"project": "n"}, "comet": {"project_name": "c"}, "aim": {"repo": "r"}}
    calls = {}
    for mod, name in ((loggers, "port"), (jloggers, "jax")):
        calls[name] = []
        for pkg in ("wandb", "mlflow", "neptune", "comet_ml", "aim"):
            monkeypatch.setitem(sys.modules, pkg, _Recorder(pkg, calls[name]))
        ml = mod.MetricsLogger(str(tmp_path / name), cfg)
        ml.log_metrics({"a": 1.0, "b": 2}, 3)
        ml.log_hparams({"seed": 0, "tags": ["dev"]})
    assert calls["port"] == calls["jax"] and len(calls["port"]) > 10
    for pkg in ("wandb", "mlflow", "neptune", "comet_ml", "aim"):
        monkeypatch.setitem(sys.modules, pkg, None)
    with pytest.warns(UserWarning) as record:
        ml = loggers.MetricsLogger(str(tmp_path / "missing"), cfg)
    assert len([w for w in record if "install" in str(w.message)]) == 5
    assert [type(lg).__name__ for lg in ml.scalar_loggers] == ["CSVLogger"]


def test_progress_bar_output_as_jax(monkeypatch):
    """The same lines on a StringIO under the same clock: throttled
    updates, the total and the shown metrics, the clearing at the end."""
    outs = []
    for mod in (callbacks, jcallbacks):
        clock = iter(np.arange(100.0, 200.0, 0.125))
        monkeypatch.setattr(mod.time, "time", lambda: float(next(clock)))
        stream = io.StringIO()
        bar = mod.ProgressBar(enabled=True, stream=stream)
        for epoch, total in ((0, None), (1, 12)):
            bar.start_epoch(epoch, total)
            for step in range(1, 13):
                bar.update(step, {"train_combined": 1.0 / step, "train_tsdf": 0.5, "lr": 1e-3,
                                  "extra": 9.0} if step > 4 else None)
            bar.end_epoch()
        outs.append(stream.getvalue())
    assert outs[0] == outs[1] and outs[0].count("\r") > 10
    assert not callbacks.ProgressBar(enabled=True).enabled  # stderr is not a terminal here


def test_config_tree_tags_and_extras_as_jax(tmp_path, capsys):
    """On a composed experiment config: the same tree text, and extras
    writes the same config_tree.log and tags.log; a config without tags
    gets ['dev'] (stdin is not a terminal)."""
    path = os.path.join(REPO, "configs", "experiment", "seqs_multigeo_4cm.yaml")
    cfg = load_experiment_config(path, "train", [])
    assert console.format_config_tree(cfg) == jconsole.format_config_tree(cfg)
    assert console.format_config_tree(cfg, ("trainer",)) == jconsole.format_config_tree(
        cfg, ("trainer",))
    trees = []
    for mod in (console, jconsole):
        out = tmp_path / "run"  # the same directory, named in the tree
        c = load_experiment_config(path, "train", [f"paths.output_dir={out}", "tags=null"])
        mod.extras(c)
        assert c["tags"] == ["dev"]
        trees.append(_tree(str(out)))
        shutil.rmtree(out)
    assert sorted(trees[0]) == ["config_tree.log", "tags.log"] and trees[0] == trees[1]
    printed = capsys.readouterr().out
    assert printed.count("CONFIG\n") == 2


def test_shaded_renders_are_byte_identical(gt_mesh):
    """render_mesh and render_comparison of a fused ground-truth mesh at two
    of its views and an overview: the same uint8 images and depths;
    compute_camera_pose within 1e-6; an empty mesh renders white."""
    mesh, jmesh, frames = gt_mesh
    H, W = 24, 32
    for K, pose in frames:
        ours, ours_depth = visuals.render_mesh(mesh, K, pose, H, W)
        ref, ref_depth = jvisuals.render_mesh(jmesh, K, pose, H, W)
        assert ours.dtype == np.uint8 and (ours != 255).mean() > 0.1
        np.testing.assert_array_equal(ours, ref)
        np.testing.assert_array_equal(ours_depth, ref_depth)
    K = frames[0][0]
    overview = visuals.compute_camera_pose(mesh, K, W, H)
    np.testing.assert_allclose(overview, jvisuals.compute_camera_pose(jmesh, K, W, H),
                               rtol=0, atol=1e-6)
    cmp = visuals.render_comparison(mesh, mesh, K, overview, H, W)
    assert cmp.shape == (H, 2 * W, 3)
    np.testing.assert_array_equal(cmp, jvisuals.render_comparison(jmesh, jmesh, K, overview, H, W))
    empty = Mesh(np.zeros((0, 3)))
    np.testing.assert_array_equal(visuals.render_comparison(empty, mesh, K, overview, H, W),
                                  jvisuals.render_comparison(JMesh(np.zeros((0, 3))), jmesh, K,
                                                             overview, H, W))
    np.testing.assert_array_equal(empty.bounds(), JMesh(np.zeros((0, 3))).bounds())
    np.testing.assert_array_equal(mesh.bounds(), jmesh.bounds())


def test_trial_overrides_as_jax():
    """The sweep's points in grid and random mode at one seed equal
    scripts/sweep.py's."""
    spec = importlib.util.spec_from_file_location("jax_sweep",
                                                  os.path.join(REPO, "scripts", "sweep.py"))
    jsweep = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jsweep)
    for name in ("gen_nerf_grid", "gen_nerf_random"):
        with open(os.path.join(REPO, "configs", "hparams_search", name + ".yaml")) as f:
            cfg = yaml.safe_load(f)
        ours = list(sweep.trial_overrides(cfg, np.random.default_rng(7)))
        ref = list(jsweep.trial_overrides(cfg, np.random.default_rng(7)))
        assert ours == ref and len(ours) == (6 if name.endswith("grid") else 8)
