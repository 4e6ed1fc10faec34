"""The port's data layer on the CPU against the JAX package: the PNG
reader and the resizes against PIL, the dataset writer, the data module's
batches, one train step on a loader batch, the held-out predict path and
the train and predict CLIs on a dataset.

The datasets are small: the JAX writer's scenes (3 scenes of 5 frames of
24x32, ground truth at 8 cm) in a temporary directory. Both data modules
draw from numpy generators seeded alike, so their draws are equal without
injection; the frames still reach the step at 480x640, the size every
loader resizes to.

Tolerances:
- PNG decoding, the depth resize (NEAREST on float depth) and the image
  resize (PIL's fixed-point BILINEAR, reproduced to the bit): exact;
- batches: frame ids and images exact; pose, intrinsics and projection
  within 1e-6; volumes within TSDF.transform's bound
  (tests/test_torch_tsdf.py: 1e-5, with at most 0.1% of the voxels on a
  nearest-tap tie);
- the writer: decoded frames exact; ground truth within 4e-6, two ulps of
  a 4 m camera depth over the 0.24 m truncation. test_fuse_frames holds
  1e-6 on a grid at the origin; on the generator's grid (origin -1.6 m)
  the two packages round the world and camera coordinates differently
  (XLA fuses the voxel position into one multiply-add and orders the
  projection's sum its own way), and 1.3% of the voxels differ by more
  than 1e-6, at most 2.1e-6;
- one train step: test_one_step_matches_jax_value_and_grad's bounds (loss
  1e-5 relative, each gradient 1e-4 of its tensor's max-abs);
- held-out predict: test_reconstruct_matches_jax's 1e-4.
"""
import importlib.util
import io
import json
import os
import shutil
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from gennerf_tpu.data import datamodule as jdm
from gennerf_tpu.data.synthetic import generate_scene as j_generate_scene
from gennerf_tpu.data.synthetic import random_primitives as j_random_primitives
from gennerf_tpu.train.step import gen_nerf_forward_loss as j_forward_loss
from gennerf_tpu.train.tasks import GenNerfTask
from gennerf_tpu.utils.mesh import Mesh as JMesh
from gennerf_tpu_torch.data import datamodule as tdm
from gennerf_tpu_torch.data.datasets import ItemCache, load_info_json, map_frames
from gennerf_tpu_torch.data.make_multigeo import make_multigeo
from gennerf_tpu_torch.data.synthetic import generate_scene
from gennerf_tpu_torch.predict import main as predict_main
from gennerf_tpu_torch.predict import reconstruct
from gennerf_tpu_torch.train.__main__ import main as train_main
from gennerf_tpu_torch.train.step import batch_to_device, gen_nerf_forward_loss
from gennerf_tpu_torch.tsdf.tsdf import TSDF
from gennerf_tpu_torch.utils.image import decode_png, encode_png, resize_bilinear, resize_nearest
from gennerf_tpu_torch.utils.mesh import Mesh
from test_torch_predict import _jax_draws, scene, task_pair  # noqa: F401
from test_torch_predict import CFG as PREDICT_CFG
from test_torch_train import CFG as TRAIN_CFG
from test_torch_train import _draws, _grad_state, _model, jax_params  # noqa: F401
from test_torch_train import batch  # noqa: F401

import _torch_threads  # noqa: F401  (sizes torch's threads per xdist worker)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRANSFORM_TOL, TIE_SHARE = 1e-5, 1e-3
DATA = dict(
    datasets_train=["train.txt"], datasets_val=["val.txt"], datasets_test=["val.txt"],
    batch_size=1, dataset_type="sequences", sequence_amount_train=2.0, sequence_amount_val=1.0,
    sequence_amount_test=1.0, sequence_length=3, sequence_locations="free",
    sequence_order="random", num_frames_train=2, num_frames_val=2, num_frames_test=2,
    frame_locations="evenly_spaced", frame_order="random", voxel_size=0.08,
    voxel_dim_train=[16, 16, 8], voxel_dim_val=[20, 20, 12], voxel_dim_test=[16, 16, 8],
    random_rotation_3d=True, random_translation_3d=True, pad_xy_3d=0.5, pad_z_3d=0.5,
    cache_items=True)


@pytest.fixture(autouse=True)
def _f32_highest():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with jax.default_matmul_precision("highest"):
        yield


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    """The JAX writer's mini dataset: 2 training scenes, 1 held out."""
    root = str(tmp_path_factory.mktemp("jax_data"))
    rng = np.random.default_rng(0)
    infos = [os.path.relpath(j_generate_scene(root, scene=f"scene_{i}", num_frames=5, H=24, W=32,
                                              voxel_sizes=(8,), seed=i,
                                              primitives=j_random_primitives(rng, fam)), root)
             for i, fam in enumerate(("spheres", "boxes", "spheres"))]
    with open(os.path.join(root, "train.txt"), "w") as f:
        f.write("\n".join(infos[:2]) + "\n")
    with open(os.path.join(root, "val.txt"), "w") as f:
        f.write(infos[2] + "\n")
    return root


def _filters(png: bytes) -> set:
    """The line filter types used in a PNG's image data."""
    header = png[16:29]
    W, H, depth, color = int.from_bytes(header[0:4], "big"), int.from_bytes(header[4:8], "big"), \
        header[8], header[9]
    pos, idat = 8, b""
    while pos < len(png):
        n = int.from_bytes(png[pos:pos + 4], "big")
        if png[pos + 4:pos + 8] == b"IDAT":
            idat += png[pos + 8:pos + 8 + n]
        pos += 12 + n
    stride = W * {0: 1, 2: 3, 6: 4}[color] * depth // 8
    raw = zlib.decompress(idat)
    return {raw[y * (stride + 1)] for y in range(H)}


def _encode_all_filters(arr: np.ndarray) -> bytes:
    """A PNG of `arr` whose line y uses filter type y % 5."""
    H, W = arr.shape[:2]
    C = 1 if arr.ndim == 2 else arr.shape[2]
    bpp = C * arr.dtype.itemsize
    rows = np.frombuffer(arr.astype(arr.dtype.newbyteorder(">")).tobytes(), np.uint8)
    rows = rows.reshape(H, W * bpp).astype(np.int64)
    out = b""
    for y in range(H):
        x = rows[y]
        up = rows[y - 1] if y else np.zeros_like(x)
        left = np.concatenate([np.zeros(bpp, np.int64), x[:-bpp]])
        upleft = np.concatenate([np.zeros(bpp, np.int64), up[:-bpp]])
        p = left + up - upleft
        pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - upleft)
        paeth = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, upleft))
        pred = [0 * x, left, up, (left + up) // 2, paeth][y % 5]
        out += bytes([y % 5]) + ((x - pred) % 256).astype(np.uint8).tobytes()
    png = encode_png(arr)
    n = int.from_bytes(png[33:37], "big")
    body = zlib.compress(out)
    idat = (len(body).to_bytes(4, "big") + b"IDAT" + body
            + zlib.crc32(b"IDAT" + body).to_bytes(4, "big"))
    return png[:33] + idat + png[45 + n:]


def test_read_png_matches_pil():
    """8-bit RGB and 16-bit gray written by PIL (adaptive line filters)
    and by the port's writer, and PNGs cycling through all five filter
    types: decoded as PIL decodes them, exactly."""
    rng = np.random.default_rng(0)
    smooth = np.cumsum(np.cumsum(rng.integers(0, 3, (40, 50, 3)), 0), 1).astype(np.uint8)
    noise = rng.integers(0, 256, (40, 50, 3)).astype(np.uint8)
    depth = (np.cumsum(rng.integers(0, 40, (40, 50)), 1) + 300).astype(np.uint16)
    seen = set()
    for arr in (smooth, noise, depth):
        buf = io.BytesIO()
        Image.fromarray(arr).save(buf, format="PNG")
        png = buf.getvalue()
        seen |= _filters(png)
        for data in (png, encode_png(arr), _encode_all_filters(arr)):
            ours = decode_png(data)
            assert ours.dtype == arr.dtype and ours.shape == arr.shape
            np.testing.assert_array_equal(ours, arr)
            np.testing.assert_array_equal(ours, np.asarray(Image.open(io.BytesIO(data))))
        assert _filters(_encode_all_filters(arr)) == {0, 1, 2, 3, 4}
    assert {1, 2, 4} <= seen  # PIL's own choice covers Sub, Up and Paeth
    # several IDAT chunks: split one stream across three
    png = encode_png(noise)
    n = int.from_bytes(png[33:37], "big")
    body = png[41:41 + n]
    parts = [body[:n // 3], body[n // 3:2 * n // 3], body[2 * n // 3:]]

    def chunk(data):
        return (len(data).to_bytes(4, "big") + b"IDAT" + data
                + zlib.crc32(b"IDAT" + data).to_bytes(4, "big"))

    split = png[:33] + b"".join(chunk(p) for p in parts) + png[45 + n:]
    np.testing.assert_array_equal(decode_png(split), noise)


@pytest.mark.parametrize("size", [(640, 480), (101, 77), (20, 15)])
def test_resizes_match_pil(size):
    """NEAREST on float depth (the depth path) and BILINEAR on uint8 RGB:
    both bit-exact, up- and downsampled."""
    rng = np.random.default_rng(1)
    depth = (rng.integers(0, 5000, (24, 32)) / 1000.0).astype(np.float32)
    rgb = np.cumsum(rng.integers(0, 9, (24, 32, 3)), 1).astype(np.uint8)
    np.testing.assert_array_equal(resize_nearest(depth, size),
                                  np.asarray(Image.fromarray(depth).resize(size, Image.NEAREST)))
    np.testing.assert_array_equal(resize_bilinear(rgb, size),
                                  np.asarray(Image.fromarray(rgb).resize(size, Image.BILINEAR)))


@pytest.mark.parametrize("channels", [1, 2, 4])
def test_bilinear_resize_other_channel_counts_match_pil(channels):
    """BILINEAR on uint8 images of 1, 2 and 4 channels (the host pass's
    compiled and generic channel loops) against PIL's 'L' resize of each
    channel alone, bit-exact, down- and upsampled."""
    rng = np.random.default_rng(channels)
    img = np.cumsum(rng.integers(0, 9, (37, 53, channels)), 1).astype(np.uint8)
    for size in [(20, 15), (101, 77)]:
        ref = np.stack([np.asarray(Image.fromarray(img[:, :, c]).resize(size, Image.BILINEAR))
                        for c in range(channels)], axis=-1)
        np.testing.assert_array_equal(resize_bilinear(img, size), ref)


def _assert_batches_equal(ref: dict, ours: dict):
    assert sorted(ref) == sorted(ours)
    for k, r in ref.items():
        o = ours[k]
        if not isinstance(r, np.ndarray):
            assert r == o, k
        elif k.startswith("vol_"):
            assert o.shape == r.shape and o.dtype == r.dtype, k
            ties = np.abs(o - r) > TRANSFORM_TOL
            assert ties.mean() <= TIE_SHARE, (k, int(ties.sum()))
        elif k in ("image", "depth"):
            np.testing.assert_array_equal(o, r, err_msg=k)
        else:
            np.testing.assert_allclose(o, r, rtol=0, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("workers", [0, 3])
def test_datamodule_batches_match_jax(dataset, workers):
    """Augmented, shuffled train batches and val batches over two epochs:
    the same frames, cameras and volumes as the JAX data module's, with
    `workers` loader threads on the port side (the JAX side runs 2), the
    port's item cache off at 0 workers and on at 3."""
    cfg = dict(DATA, data_dir=dataset, num_workers_train=workers, num_workers_val=workers)
    jmod = jdm.ScannetDataModule(dict(cfg, num_workers_train=2, num_workers_val=2), seed=4)
    tmod = tdm.ScannetDataModule(dict(cfg, cache_items=bool(workers)), seed=4)
    for make in ("train_dataloader", "val_dataloader"):
        jl, tl = getattr(jmod, make)(), getattr(tmod, make)()
        assert len(jl) == len(tl) > 0
        for _ in range(2):
            batches = list(zip(jl, tl))
            assert len(batches) == len(tl)
            for ref, ours in batches:
                _assert_batches_equal(ref, ours)
                assert ours["depth"].shape[-2:] == (480, 640)
    # augmentation moved the volume: the rotation and translation draws took place
    train = next(iter(tmod.train_dataloader()))["vol_08_tsdf"]
    val = next(iter(tmod.val_dataloader()))["vol_08_tsdf"]
    assert train.shape == (1, 1, 16, 16, 8) and val.shape == (1, 1, 20, 20, 12)


def test_item_cache_returns_copies(dataset):
    info = load_info_json(os.path.join(dataset, _split_infos(dataset, "train.txt")[0]))
    cache = ItemCache(frames=8)
    first = map_frames(info["frames"], [1, 2], ("depth",), False, cache)
    first[0]["depth"][:] = -1
    again = map_frames(info["frames"], [1, 2], ("depth",), False, cache)
    assert cache.frames.get(info["frames"][1]["file_name_depth"]) is not None
    assert (again[0]["depth"] >= 0).all()
    np.testing.assert_array_equal(again[1]["image"], map_frames(info["frames"], [2], (), False)[0]["image"])


def _split_infos(root, split):
    with open(os.path.join(root, split)) as f:
        return [line.strip() for line in f if line.strip()]


def _load_jax_writer():
    spec = importlib.util.spec_from_file_location(
        "make_multigeo_dataset", os.path.join(REPO, "scripts", "local", "make_multigeo_dataset.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_writer_matches_jax(tmp_path):
    """The port's make_multigeo and the JAX script on the same (small)
    settings: the same split files, scenes, cameras and decoded frames,
    the ground truth within 4e-6, and mesh_gt.ply with the JAX file's faces
    and vertices: a vertex lies at v_a / (v_a - v_b) along its edge, so the
    volumes' 4e-6 moves it by up to 4e-6 / |v_a - v_b| of a voxel; at most
    1% of the vertices move by more than 1e-5 voxel, none by more than
    1e-3 voxel; the colour volumes within 1e-3 of the 0-255 range on all
    but 0.1% of the voxels (a voxel on a pixel border may gather the
    neighbouring pixel's colour) and the vertex colours equal on all but
    1% of the vertices."""
    args = ["--train", "2", "--frames", "3", "--height", "12", "--width", "16", "--voxel-sizes", "8"]
    _load_jax_writer().main(["--out", str(tmp_path / "jax")] + args)
    make_multigeo(str(tmp_path / "port"), train=2, frames=3, height=12, width=16, voxel_sizes=(8,))
    for name in ("train.txt", "val.txt", "splits.json"):
        assert (tmp_path / "jax" / name).read_text() == (tmp_path / "port" / name).read_text()
    rels = json.loads((tmp_path / "port" / "splits.json").read_text())
    assert len(rels["train"]) == 2 and len(rels["val"]) == 2
    for rel in rels["train"] + rels["val"]:
        ji = load_info_json(str(tmp_path / "jax" / rel))
        ti = load_info_json(str(tmp_path / "port" / rel))
        assert set(ji) == set(ti)
        assert ji["scene"] == ti["scene"] and len(ji["frames"]) == len(ti["frames"]) == 3
        for jf, tf in zip(ji["frames"], ti["frames"]):
            assert jf["intrinsics"] == tf["intrinsics"] and jf["pose"] == tf["pose"]
            for key in ("file_name_image", "file_name_depth"):
                with open(jf[key], "rb") as a, open(tf[key], "rb") as b:
                    np.testing.assert_array_equal(decode_png(a.read()), decode_png(b.read()))
        jv, tv = TSDF.load(ji["file_name_vol_08"]), TSDF.load(ti["file_name_vol_08"])
        assert tv.voxel_size == jv.voxel_size and tv.tsdf_vol.shape == jv.tsdf_vol.shape
        np.testing.assert_array_equal(tv.origin.numpy(), jv.origin.numpy())
        np.testing.assert_allclose(tv.tsdf_vol.numpy(), jv.tsdf_vol.numpy(), rtol=0, atol=4e-6)
        far = np.abs(tv.attribute_vols["color"].numpy() - jv.attribute_vols["color"].numpy())
        assert (far > 1e-3 * 255).mean() <= 1e-3
        jm, tm = JMesh.load(ji["file_name_mesh_gt"]), Mesh.load(ti["file_name_mesh_gt"])
        assert len(tm.faces) > 0 and tm.vertex_colors is not None
        np.testing.assert_array_equal(tm.faces, jm.faces)
        assert (tm.vertex_colors != jm.vertex_colors).any(axis=1).mean() <= 1e-2
        moved = np.abs(tm.vertices - jm.vertices).max(axis=1) / 0.08
        assert (moved > 1e-5).mean() <= 1e-2 and moved.max() <= 1e-3, (int((moved > 1e-5).sum()),
                                                                       moved.max())


def test_tar_frames_read_as_files(tmp_path):
    """A scene written with tar archives reads the same frames."""
    prims = [{"type": "sphere", "center": (0.1, 0.0, 0.3), "radius": 0.3}]
    info = load_info_json(generate_scene(str(tmp_path), "s", num_frames=3, H=12, W=16,
                                         voxel_sizes=(8,), use_tar=True, primitives=prims))
    from_tar = map_frames(info["frames"], [0, 2], ("depth",), from_archive=True)
    from_files = map_frames(info["frames"], [0, 2], ("depth",), from_archive=False)
    for a, b in zip(from_tar, from_files):
        np.testing.assert_array_equal(a["image"], b["image"])
        np.testing.assert_array_equal(a["depth"], b["depth"])


def test_train_step_on_loader_batch_matches_jax(dataset, jax_params):
    """One augmented 480x640 loader batch through both steps, the JAX
    draws injected (the pixel scores over 480 x 640 pixels)."""
    cfg = dict(DATA, data_dir=dataset, num_workers_train=0)
    batch_np = next(iter(tdm.ScannetDataModule(cfg, seed=1).train_dataloader()))
    arrays = {k: v for k, v in batch_np.items() if isinstance(v, np.ndarray)}
    task = GenNerfTask(TRAIN_CFG)
    key = jax.random.PRNGKey(7)

    @jax.jit
    def jstep(params, b):
        def f(p):
            loss, metrics, _ = j_forward_loss(task.model, task.cfg, p, {}, b, key, (16, 16, 8), True)
            return loss, metrics
        return jax.value_and_grad(f, has_aux=True)(params)

    (loss_j, metrics_j), grads_j = jstep(jax.tree.map(jnp.asarray, jax_params),
                                         {k: jnp.asarray(v) for k, v in arrays.items()})
    model = _model(jax_params)
    loss, metrics = gen_nerf_forward_loss(model, batch_to_device(batch_np, "cpu"),
                                          draws=_draws(key, npix=480 * 640, BT=2))
    loss.backward()
    assert float(metrics["valid_coverage"].detach()) > 0
    np.testing.assert_allclose(float(loss.detach()), float(loss_j), rtol=1e-5, atol=0)
    ref = _grad_state(grads_j)
    for name, p in model.named_parameters():
        g, r = p.grad.numpy(), ref[name].numpy()
        np.testing.assert_allclose(g, r, rtol=0, atol=1e-4 * max(np.abs(r).max(), 1e-12),
                                   err_msg=name)


def test_held_out_offset_and_volume_match_jax(dataset, task_pair):
    """The predict loader's scene (ScenesDataset's inference path: origin
    offset, ground truth resampled in the shifted frame) against the JAX
    one, then `reconstruct` on it against GenNerfTask.reconstruct."""
    task, state, _, _, model = task_pair
    cfg = dict(DATA, data_dir=dataset, frame_order="sorted")
    ref = next(iter(jdm.ScannetDataModule(cfg, seed=0).predict_dataloader()))
    ours = next(iter(tdm.ScannetDataModule(cfg, seed=0).predict_dataloader()))
    _assert_batches_equal(ref, ours)
    info = load_info_json(os.path.join(dataset, _split_infos(dataset, "val.txt")[0]))
    gt_origin = np.asarray(TSDF.load(info["file_name_vol_08"]).origin).reshape(3)
    np.testing.assert_allclose(ours["offset"][0, 0], gt_origin - 6 * 0.08, rtol=0, atol=1e-6)
    with jax.default_matmul_precision("highest"):
        pred, trgt = task.reconstruct(state, {k: v for k, v in ref.items()
                                              if isinstance(v, np.ndarray)})
    np.testing.assert_array_equal(np.asarray(trgt.tsdf_vol), ref["vol_08_tsdf"][0, 0])
    sel, start = _jax_draws(2, 480 * 640, 64)
    vol = reconstruct(model, ours["projection"][0], ours["image"][0], ours["depth"][0],
                      sel=sel, start=start)
    assert tuple(vol.shape) == tuple(PREDICT_CFG["voxel_dim_test"])
    np.testing.assert_allclose(vol.numpy(), np.asarray(pred.tsdf_vol), atol=1e-4, rtol=0)


TINY = (
    "defaults:\n  - seqs_multigeo_4cm\n"
    "model:\n  encoder:\n    pointnet:\n      num_sparse_points: 32\n      fps_presample: 64\n"
    "      c_dim: 8\n      hidden_dim: 8\n      plane_resolution: 16\n      n_blocks: 2\n"
    "      unet_kwargs: {depth: 2, merge_mode: concat, start_filts: 8}\n"
    "  mlp: {d_out_geo: 8, d_out_sem: 1, n_blocks: 2, d_hidden: 32}\n"
    "  ray: {num_rays: 8, N: 4, M: 2}\n"
    "trainer: {log_every_n_steps: 1, check_val_every_n_epoch: 1}\n"
    "data:\n  voxel_size: 0.08\n  voxel_dim_train: [16, 16, 8]\n  voxel_dim_val: [20, 20, 12]\n"
    "  voxel_dim_test: [48, 48, 28]\n  num_frames_train: 2\n  num_frames_val: 2\n"
    "  num_frames_test: 2\n  sequence_length: 3\n  num_workers_train: 2\n  num_workers_val: 0\n")


@pytest.fixture(scope="module")
def tiny_config(tmp_path_factory):
    """A small child of seqs_multigeo_4cm (augmentation on) in a copy of
    the configs tree."""
    root = tmp_path_factory.mktemp("configs")
    shutil.copytree(os.path.join(REPO, "configs"), root / "configs")
    exp = root / "configs" / "experiment" / "tiny_multigeo.yaml"
    exp.write_text(TINY)
    return str(exp)


def test_train_cli_augmentation_needs_the_loaders(tiny_config, tmp_path):
    """The config asks for 3D augmentation, which only the loaders apply:
    both fixed batches raise."""
    for source in (["--synthetic"], ["--batch", str(tmp_path / "b.npz")]):
        with pytest.raises(NotImplementedError, match="random_rotation_3d"):
            train_main(["--config", tiny_config, "--out", str(tmp_path / "x"), "--epochs", "1",
                        "--device", "cpu"] + source)


def test_train_then_predict_on_dataset(tiny_config, dataset, tmp_path):
    """The train CLI on the dataset (2 scenes x 1 window, 2 epochs, the
    augmentation on; each step's loader wait and step time logged), then
    the predict CLI on the held-out split: one npz per scene, its origin
    at the scene's offset, and the masked L1 against the ground truth
    that eval_tsdf gives for the saved volume."""
    trainer = train_main(["--config", tiny_config, "--out", str(tmp_path / "run"),
                          "--data-dir", dataset, "--epochs", "2", "--device", "cpu"])
    assert trainer.global_step == 4 and len(trainer.timings) == 4
    assert {"train_combined", "val_combined", "data_wait_ms", "step_ms"} <= set(trainer.metrics)
    results = predict_main(["--config", tiny_config, "--params", str(tmp_path / "run" / "params.npz"),
                            "--data-dir", dataset, "--split", "val.txt",
                            "--out", str(tmp_path / "pred"), "--device", "cpu"])
    from gennerf_tpu_torch.eval.metrics import eval_tsdf

    (scene, result), = results.items()
    saved = TSDF.load(str(tmp_path / "pred" / f"{scene}.npz"))
    assert saved.tsdf_vol.shape == (48, 48, 28)
    np.testing.assert_allclose(saved.origin.numpy()[0], result["offset"], rtol=0, atol=0)
    info = load_info_json(os.path.join(dataset, _split_infos(dataset, "val.txt")[0]))
    assert result["l1"] == eval_tsdf(saved, TSDF.load(info["file_name_vol_08"]))["l1"]
    assert 0 < result["l1"] < 2
