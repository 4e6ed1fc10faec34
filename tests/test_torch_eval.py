"""The port's evaluation and the entry points that feed it trained weights,
on the CPU against the JAX package: `eval_mesh`, the KD-tree distances
and the depth rasterizer; `evaluation.process` / `evaluation_tsdf` and
their CLIs on a small dataset the port writes (2 scenes of 4 frames of
48x64, ground truth at 8 cm, mesh_gt.ply); the validation reconstruction
tail; checkpoint retention against the JAX (orbax) manager; and the
faults this slice repairs: F4 (predict read only the last epoch), F5 (no
top-k retention), F6 (no reconstruction tail in validation).

Tolerances:
- eval_mesh: 1e-6 (the same host code on both sides); nn_distances
  equal; rasterized depths equal on >= 99.9% of the pixels and within
  1e-5 m elsewhere;
- the evaluations: every metric within 1e-4 (the two packages' fused
  volumes differ by up to 2.1e-6, tests/test_torch_data.py, which can
  move a re-fused vertex and so a thresholded count);
- val_recon_tsdf_l1: 1e-4, the bound of the reconstructed volumes
  (tests/test_torch_predict.py).
"""
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gennerf_tpu import native as jnative
from gennerf_tpu.eval import evaluation as jevaluation
from gennerf_tpu.eval import evaluation_tsdf as jevaluation_tsdf
from gennerf_tpu.eval.metrics import eval_mesh as j_eval_mesh
from gennerf_tpu.train.checkpoints import CheckpointManager as JCheckpointManager
from gennerf_tpu.train.loggers import MetricsLogger
from gennerf_tpu.train.loop import Trainer as JTrainer
from gennerf_tpu.train.state import create_train_state
from gennerf_tpu.train.tasks import GenNerfTask
from gennerf_tpu.utils.mesh import Mesh as JMesh
from gennerf_tpu_torch.data.datasets import load_info_json
from gennerf_tpu_torch.data.synthetic import generate_scene, random_primitives, training_batch
from gennerf_tpu_torch.eval import evaluation, evaluation_tsdf
from gennerf_tpu_torch.eval.metrics import eval_mesh
from gennerf_tpu_torch.models.config import GenNerfConfig, config_from_dict
from gennerf_tpu_torch.models.gen_nerf import GenNerf
from gennerf_tpu_torch.predict import main as predict_main
from gennerf_tpu_torch.predict import reconstruct
from gennerf_tpu_torch.render import main as render_main
from gennerf_tpu_torch.train import loop
from gennerf_tpu_torch.train.__main__ import main as train_main
from gennerf_tpu_torch.train.checkpoints import CheckpointManager, load_checkpoint
from gennerf_tpu_torch.train.state import make_optimizer
from gennerf_tpu_torch.tsdf.tsdf import TSDF
from gennerf_tpu_torch.utils import native
from gennerf_tpu_torch.utils.mesh import Mesh
from test_torch_predict import _jax_draws
from test_torch_train import CFG as TRAIN_CFG
from test_torch_train import TINY_EXPERIMENT, _model, batch, jax_params  # noqa: F401

import _torch_threads  # noqa: F401  (sizes torch's threads per xdist worker)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
METRIC_TOL = 1e-4
DEPTH_KEYS = ("AbsRel", "AbsDiff", "SqRel", "RMSE", "LogRMSE", "r1", "r2", "r3", "complete")
MESH_KEYS = ("dist1", "dist2", "prec", "recal", "fscore")


@pytest.fixture(autouse=True)
def _f32_highest():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with jax.default_matmul_precision("highest"):
        yield


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    """Two scenes (spheres, boxes) written by the port: 4 frames of 48x64,
    ground truth and mesh_gt.ply at 8 cm; val.txt lists both, one.txt the
    first."""
    root = str(tmp_path_factory.mktemp("port_data"))
    rng = np.random.default_rng(0)
    infos = [os.path.relpath(generate_scene(root, scene=f"scene_{fam}", num_frames=4, H=48, W=64,
                                            voxel_sizes=(8,), seed=i,
                                            primitives=random_primitives(rng, fam)), root)
             for i, fam in enumerate(("spheres", "boxes"))]
    with open(os.path.join(root, "val.txt"), "w") as f:
        f.write("\n".join(infos) + "\n")
    with open(os.path.join(root, "one.txt"), "w") as f:
        f.write(infos[0] + "\n")
    return root


def _infos(root, split="val.txt"):
    with open(os.path.join(root, split)) as f:
        return [os.path.join(root, line.strip()) for line in f if line.strip()]


@pytest.fixture(scope="module")
def predictions(dataset, tmp_path_factory):
    """A predicted volume and mesh per scene: the ground truth with noise
    in its band, on the ground truth's grid for the first scene and on a
    grid 2 voxels larger on every side for the second (eval_tsdf then
    resamples)."""
    out = str(tmp_path_factory.mktemp("pred"))
    rng = np.random.default_rng(1)
    for n, info_file in enumerate(_infos(dataset)):
        info = load_info_json(info_file)
        gt = TSDF.load(info["file_name_vol_08"])
        vol = gt.tsdf_vol.numpy()
        band = np.abs(vol) < 1
        vol = np.where(band, np.clip(vol + 0.1 * rng.standard_normal(vol.shape), -1, 1), vol)
        origin = gt.origin.numpy()
        if n == 1:
            vol = np.pad(vol, 2, constant_values=1.0)
            origin = origin - 2 * 0.08
        pred = TSDF(0.08, torch.from_numpy(origin.astype(np.float32)),
                    torch.from_numpy(vol.astype(np.float32)))
        pred.save(os.path.join(out, f"{info['scene']}.npz"))
        pred.get_mesh().export(os.path.join(out, f"{info['scene']}.ply"))
    return out


def _copy(src, dst):
    shutil.copytree(src, dst)
    return str(dst)


def _assert_metrics_close(ours, ref, tol=METRIC_TOL):
    assert ours.keys() == ref.keys()
    for k, v in ref.items():
        if isinstance(v, str):
            assert ours[k] == v
        else:
            assert ours[k] == pytest.approx(v, abs=tol), k


# -- mesh metrics, KD-tree, rasterizer -------------------------------------------

def _noisy_sphere(rng, n, radius, noise):
    d = rng.standard_normal((n, 3))
    return radius * d / np.linalg.norm(d, axis=1, keepdims=True) + noise * rng.standard_normal((n, 3))


def test_eval_mesh_and_nn_distances_match_jax(rng):
    pred = _noisy_sphere(rng, 3000, 0.5, 0.02)
    trgt = _noisy_sphere(rng, 2500, 0.52, 0.0)
    ours = eval_mesh(Mesh(pred), Mesh(trgt))
    ref = j_eval_mesh(JMesh(pred), JMesh(trgt))
    _assert_metrics_close(ours, ref, 1e-6)
    assert 0 < ours["fscore"] < 1
    for empty in (eval_mesh(Mesh(np.zeros((0, 3))), Mesh(trgt)),
                  eval_mesh(Mesh(pred), Mesh(np.zeros((0, 3))))):
        assert empty == j_eval_mesh(JMesh(np.zeros((0, 3))), JMesh(trgt))
        assert empty["dist1"] == np.inf and empty["fscore"] == 0.0
    q = rng.uniform(-1, 1, (500, 3)).astype(np.float32)
    t = rng.uniform(-1, 1, (800, 3)).astype(np.float32)
    np.testing.assert_array_equal(native.nn_distances(q, t), jnative.nn_distances(q, t))
    assert np.isinf(native.nn_distances(q, np.zeros((0, 3), np.float32))).all()


def test_rasterize_depth_matches_jax(dataset):
    """The ground-truth mesh of a scene at each of its views."""
    info = load_info_json(_infos(dataset)[1])
    mesh = Mesh.load(info["file_name_mesh_gt"])
    assert len(mesh.faces) > 1000
    for frame in info["frames"]:
        K, pose = np.array(frame["intrinsics"]), np.array(frame["pose"])
        ours = evaluation.render_mesh_depth(mesh, K, pose, 48, 64)
        ref = jnative.rasterize_depth(mesh.vertices, mesh.faces, K, pose, 48, 64)
        assert (ours > 0).mean() > 0.2
        same = ours == ref
        assert same.mean() >= 0.999, same.mean()
        np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-5)
    empty = evaluation.render_mesh_depth(Mesh(np.zeros((0, 3))), K, pose, 48, 64)
    assert empty.shape == (48, 64) and not empty.any()


# -- evaluation CLIs ---------------------------------------------------------------

@pytest.mark.parametrize("mesh_gt", ["file", "meshed"])
def test_evaluation_matches_jax(dataset, predictions, tmp_path, mesh_gt):
    """Both packages' evaluation CLIs over the split: every per-scene
    metric and metrics_mean.json; 'meshed' drops file_name_mesh_gt from
    the scenes' info so both mesh the fused ground truth."""
    root = dataset
    if mesh_gt == "meshed":
        root = _copy(dataset, tmp_path / "data")
        for info_file in _infos(root):
            with open(info_file) as f:
                info = json.load(f)
            del info["file_name_mesh_gt"]
            with open(info_file, "w") as f:
                json.dump(info, f)
    port, ref = _copy(predictions, tmp_path / "port"), _copy(predictions, tmp_path / "jax")
    ours = evaluation.main(["--results", port, "--dataset", "val.txt", "--data-dir", root,
                            "--device", "cpu"])
    theirs = jevaluation.main(["--results", ref, "--dataset", "val.txt", "--data-dir", root])
    assert len(ours) == len(theirs) == 2
    for a, b in zip(ours, theirs):
        assert set(DEPTH_KEYS + MESH_KEYS + ("l1", "scene")) == set(b)
        _assert_metrics_close(a, b)
        with open(os.path.join(port, f"{a['scene']}_metrics.json")) as f:
            assert json.load(f) == a
        assert 0.5 < a["fscore"] <= 1 and 0 < a["l1"] < 0.2
    with open(os.path.join(port, "metrics_mean.json")) as f, \
            open(os.path.join(ref, "metrics_mean.json")) as g:
        _assert_metrics_close(json.load(f), json.load(g))


@pytest.mark.parametrize("align", [False, True])
def test_evaluation_tsdf_matches_jax(dataset, predictions, tmp_path, align):
    port, ref = _copy(predictions, tmp_path / "port"), _copy(predictions, tmp_path / "jax")
    extra = ["--align"] if align else []
    ours = evaluation_tsdf.main(["--results", port, "--dataset", "val.txt", "--data-dir", dataset]
                                + extra)
    theirs = jevaluation_tsdf.main(["--results", ref, "--dataset", "val.txt", "--data-dir",
                                    dataset] + extra)
    for a, b in zip(ours, theirs):
        _assert_metrics_close(a, b, 1e-6)
        with open(os.path.join(port, f"{a['scene']}_tsdf_metrics.json")) as f:
            assert json.load(f) == a


def test_evaluation_refuses_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("only meaningful without a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        evaluation.process("no_such_info.json", "no_such_dir")


# -- validation reconstruction tail (F6) ---------------------------------------------

def test_val_recon_tsdf_l1_matches_jax_validate_tail(jax_params, batch, tmp_path, monkeypatch):
    """F6: the port's validation ended without the reconstruction tail.
    Both Trainers validate one batch on the same weights, the JAX encoder's
    draws of its tail injected into the port's: val_recon_tsdf_l1 agrees,
    both write the predicted and target volumes and meshes, and the target
    meshes are the same file."""
    task = GenNerfTask(TRAIN_CFG)
    state = create_train_state({"params": jax.tree.map(jnp.asarray, jax_params)}, task.tx)
    jdir = str(tmp_path / "jax")
    jtrainer = JTrainer(devices=1, prefetch_batches=0, output_dir=jdir,
                        logger=MetricsLogger(jdir))
    ref = jtrainer.validate(task, state, [batch], jax.random.PRNGKey(3), reconstruct=True)

    T, H, W = batch["depth"].shape[1:]
    sel, start = _jax_draws(T, H * W, TRAIN_CFG["encoder"]["pointnet"]["fps_presample"])
    monkeypatch.setattr(loop, "reconstruct",
                        lambda *a, **k: reconstruct(*a, **dict(k, sel=sel, start=start)))
    model = _model(jax_params)
    pdir = str(tmp_path / "port")
    trainer = loop.Trainer(model, make_optimizer(model.parameters(), model.cfg.optimizer, None),
                           torch.Generator().manual_seed(0), pdir)
    ours = trainer.validate([batch])
    assert ours["val_recon_tsdf_l1"] == pytest.approx(ref["val_recon_tsdf_l1"], abs=1e-4)
    assert 0 < ours["val_recon_tsdf_l1"] < 2
    for d in (jdir, pdir):
        for rel in ("val_tsdf/val_pred_tsdf.npz", "val_tsdf/val_trgt_tsdf.npz",
                    "val_mesh/val_pred_mesh.ply", "val_mesh/val_trgt_mesh.ply"):
            assert os.path.isfile(os.path.join(d, "local", rel)), (d, rel)
    with open(os.path.join(pdir, "local/val_mesh/val_trgt_mesh.ply"), "rb") as f, \
            open(os.path.join(jdir, "local/val_mesh/val_trgt_mesh.ply"), "rb") as g:
        assert f.read() == g.read()
    pred = TSDF.load(os.path.join(pdir, "local/val_tsdf/val_pred_tsdf.npz")).tsdf_vol.numpy()
    with np.load(os.path.join(jdir, "local/val_tsdf/val_pred_tsdf.npz")) as f:
        np.testing.assert_allclose(pred, f["tsdf"], rtol=0, atol=1e-4)


# -- checkpoint retention (F5) ---------------------------------------------------------

# epochs 0..9, validated every second epoch and once more at epoch 4
VAL = {1: 0.50, 3: 0.30, 4: 0.45, 5: 0.40, 7: 0.20, 9: 0.35}


@pytest.mark.parametrize("monitor,mode,top_k", [("val_combined", "min", 3),
                                                ("val_combined", "max", 2),
                                                (None, "min", 2), (None, "min", -1)])
def test_checkpoint_retention_matches_jax(tmp_path, monitor, mode, top_k):
    """One sequence of epochs with and without validation metrics through
    both managers: the same ranked epochs kept, the same best epoch, the
    same latest epoch."""
    jmgr = JCheckpointManager(str(tmp_path / "jax"), save_top_k=top_k, monitor=monitor, mode=mode)
    mgr = CheckpointManager(str(tmp_path / "port"), save_top_k=top_k, monitor=monitor, mode=mode)
    model = torch.nn.Linear(2, 1)
    opt = torch.optim.SGD(model.parameters(), lr=0.1)
    for epoch in range(10):
        metrics = {"val_combined": VAL[epoch]} if epoch in VAL else None
        jmgr.save(epoch, {"w": jnp.full(2, float(epoch))}, metrics=metrics)
        mgr.save(epoch, epoch * 8, model, opt, metrics=metrics)
    jmgr.wait()
    assert mgr.kept_epochs() == sorted(jmgr._mgr.all_steps())
    assert mgr.best_epoch() == jmgr.best_epoch()
    assert mgr.latest_epoch() == jmgr.latest_epoch() == 9
    files = sorted(f for f in os.listdir(tmp_path / "port") if f.startswith("epoch_"))
    assert files == [f"epoch_{e:04d}.pt" for e in mgr.kept_epochs()]
    assert os.path.isfile(tmp_path / "port" / "last.pt")
    # another process reads the ranking from the directory
    reopened = CheckpointManager.open(str(tmp_path / "port"))
    assert (reopened.best_epoch(), reopened.kept_epochs()) == (mgr.best_epoch(), mgr.kept_epochs())
    path, epoch, selected_by = reopened.best_or_latest()
    assert epoch == (mgr.best_epoch() if monitor else 9)
    assert selected_by == (monitor or "latest") and load_checkpoint(path, model)["epoch"] == epoch
    jmgr.close()


# -- the train CLI's monitored checkpoints and the entry points on them (F4, F5) ------

MONITORED = TINY_EXPERIMENT + (
    "callbacks:\n  model_checkpoint: {monitor: val_combined, mode: max, save_top_k: 2}\n"
    "test: true\n")


@pytest.fixture(scope="module")
def monitored_run(tmp_path_factory):
    """The train CLI on the tiny synthetic experiment for 4 epochs,
    validated every epoch, keeping the 2 best by the largest val_combined
    (max, so that the best epoch is an early one while the loss falls),
    then the test pass (test: true) on the best epoch."""
    root = tmp_path_factory.mktemp("monitored")
    shutil.copytree(os.path.join(REPO, "configs"), root / "configs")
    exp = root / "configs" / "experiment" / "tiny_monitored.yaml"
    exp.write_text(MONITORED)
    out = root / "run"
    trainer = train_main(["--config", str(exp), "--out", str(out), "--epochs", "4",
                          "--synthetic", "--device", "cpu"])
    rows = (out / "metrics.jsonl").read_text().splitlines()
    val = [json.loads(r)["val_combined"] for r in rows if "val_combined" in r]
    return str(exp), str(out), trainer, val


def test_train_cli_keeps_the_monitored_top_k(monitored_run):
    """F5: the manager kept every epoch. The config's model_checkpoint
    (monitor val_combined, mode max, save_top_k 2) now keeps the two
    epochs with the largest val_combined and last.pt; the ranking is in
    checkpoints.json; every validation logged val_recon_tsdf_l1 (F6) and
    wrote the tail's files."""
    _, out, trainer, val = monitored_run
    assert len(val) == 4
    best_two = sorted(sorted(range(4), key=lambda e: (-val[e], e))[:2])
    ckpt_dir = os.path.join(out, "checkpoints")
    assert sorted(os.listdir(ckpt_dir)) == sorted(
        [f"epoch_{e:04d}.pt" for e in best_two] + ["last.pt", "checkpoints.json"])
    manager = CheckpointManager.open(out)
    assert manager.best_epoch() == max(range(4), key=lambda e: (val[e], -e))
    assert "val_recon_tsdf_l1" in trainer.metrics
    assert os.path.isfile(os.path.join(out, "local", "val_mesh", "val_pred_mesh.ply"))
    # the test pass ran on the best epoch's weights, with its tail
    assert {"test_combined", "test_recon_tsdf_l1"} <= set(trainer.metrics)
    assert os.path.isfile(os.path.join(out, "local", "test_mesh", "test_trgt_mesh.ply"))
    best = GenNerf(trainer.model.cfg)
    load_checkpoint(manager.checkpoint_path(manager.best_epoch()), best)
    for k, v in best.state_dict().items():
        assert torch.equal(trainer.model.state_dict()[k], v), k


def test_predict_ckpt_restores_the_best_epoch(monitored_run, tmp_path):
    """F4: the predict CLI could only read params.npz, the last epoch. With
    --ckpt on the run directory it restores the best monitored epoch: its
    volume is that epoch's reconstruction, not the last epoch's."""
    exp, out, trainer, val = monitored_run
    best = CheckpointManager.open(out).best_epoch()
    assert best != 3  # the loss fell: the largest val_combined is an early epoch
    frames = training_batch(1, 2, 24, 32, (16, 16, 8), 0.08, seed=9)
    np.savez(tmp_path / "frames.npz", **{k: frames[k][0] for k in ("projection", "image", "depth")})
    predict_main(["--config", exp, "--ckpt", out, "--frames", str(tmp_path / "frames.npz"),
                  "--out", str(tmp_path / "tsdf.npz"), "--device", "cpu"])
    with np.load(tmp_path / "tsdf.npz") as f:
        vol = f["tsdf"]
    for epoch, equal in ((best, True), (3, False)):
        model = GenNerf(trainer.model.cfg)
        path = (os.path.join(out, "checkpoints", f"epoch_{epoch:04d}.pt") if epoch == best
                else os.path.join(out, "checkpoints", "last.pt"))
        assert load_checkpoint(path, model)["epoch"] == epoch
        expect = reconstruct(model.eval(), frames["projection"][0], frames["image"][0],
                             frames["depth"][0], generator=torch.Generator().manual_seed(0))
        assert np.array_equal(vol, expect.numpy()) == equal, epoch


DATA_TINY = (
    "defaults:\n  - seqs_multigeo_4cm\n"
    "model:\n  encoder:\n    pointnet:\n      num_sparse_points: 32\n      fps_presample: 64\n"
    "      c_dim: 8\n      hidden_dim: 8\n      plane_resolution: 16\n      n_blocks: 2\n"
    "      unet_kwargs: {depth: 2, merge_mode: concat, start_filts: 8}\n"
    "  mlp: {d_out_geo: 8, d_out_sem: 1, n_blocks: 2, d_hidden: 32}\n"
    "data:\n  voxel_size: 0.08\n  voxel_dim_train: [16, 16, 8]\n  voxel_dim_val: [20, 20, 12]\n"
    "  voxel_dim_test: [48, 48, 28]\n  num_frames_test: 2\n  sequence_length: 4\n"
    "  num_workers_test: 0\n")


def test_predict_and_render_from_a_checkpoint_directory(dataset, tmp_path):
    """The predict CLI on the split from a checkpoint directory writes
    {scene}.npz, {scene}.ply and predict_meta.json (the best epoch,
    selected by the monitor); the render CLI's split mode renders a scene
    of a split from the same directory and scores its depth."""
    shutil.copytree(os.path.join(REPO, "configs"), tmp_path / "configs")
    exp = tmp_path / "configs" / "experiment" / "tiny_data.yaml"
    exp.write_text(DATA_TINY)
    torch.manual_seed(0)
    models = [GenNerf(config_from_dict(GenNerfConfig, TRAIN_CFG)) for _ in range(2)]
    mgr = CheckpointManager(str(tmp_path / "ckpt"), save_top_k=1, monitor="val_combined")
    for epoch, (model, value) in enumerate(zip(models, (0.2, 0.4))):
        mgr.save(epoch, epoch, model, make_optimizer(model.parameters(), model.cfg.optimizer, None),
                 metrics={"val_combined": value})
    results = predict_main(["--config", str(exp), "--ckpt", str(tmp_path / "ckpt"),
                            "--data-dir", dataset, "--split", "val.txt",
                            "--out", str(tmp_path / "pred"), "--device", "cpu"])
    with open(tmp_path / "pred" / "predict_meta.json") as f:
        meta = json.load(f)
    assert (meta["epoch"], meta["selected_by"], meta["precision"]) == (0, "val_combined", "32-true")
    for scene, result in results.items():
        mesh = Mesh.load(str(tmp_path / "pred" / f"{scene}.ply"))
        saved = TSDF.load(str(tmp_path / "pred" / f"{scene}.npz"))
        assert len(mesh) == result["vertices"] and saved.tsdf_vol.shape == (48, 48, 28)
        assert len(mesh) == len(saved.get_mesh())
    mean = render_main(["--config", str(exp), "--ckpt", str(tmp_path / "ckpt"), "--data-dir",
                        dataset, "--split", "one.txt", "--out", str(tmp_path / "views"),
                        "--num-views", "1", "--device", "cpu"])
    with open(tmp_path / "views" / "render_metrics.json") as f:
        record = json.load(f)
    assert list(record["per_scene"]) == ["scene_spheres"] and record["mean"] == mean
    assert set(mean) == set(DEPTH_KEYS)
    assert [n for n in os.listdir(tmp_path / "views") if n.endswith(".png")] == [
        "scene_spheres_view000.png"]
