"""The port's ScanNet preparation on the CPU against the JAX package: the
.sens container both ways, the exporters (plain and tarred), info.json and
the split files, the fused ground truth, prepare_scannet's sharding, the
four tools against their scripts/ originals, and a training batch of a
prepared ScanNet-sized JPEG scene against the JAX data module's.

The raw scenes are fabricated: rendered synthetic frames packed into .sens
containers by the JAX writer (PIL's JPEG at quality 95) or the port's.

Tolerances:
- the containers, the exported JPEGs, depth PNGs (decoded), poses,
  intrinsics, info.json and the split files: exact (the port's JPEG encoder
  writes PIL's bytes; tests/test_torch_jpeg.py);
- the fused ground truth: origin and vol_dim from the same quantiles of
  points both packages unproject in float32 (origin within 1e-5 m,
  vol_dim equal); the TSDF within 1e-5, five float32 ulps of a 5 m camera
  depth over the 0.24 m truncation (the packages round the world and
  camera coordinates differently, as tests/test_torch_data.py explains for
  the generator's grid; at the quantile origin, off whole voxels, the
  largest difference read was 6.0e-6 on 0.07% of the 8 cm voxels); the
  colour volume within 1e-3 of its 0-255 range on all but 0.1% of the
  voxels (a voxel on a pixel border may gather the neighbouring pixel's
  colour), the meshes with the same faces;
- the training batch: tests/test_torch_data.py's bounds (frames exact,
  cameras 1e-6, volumes within TSDF.transform's bound).
"""
import importlib.util
import json
import os
import shutil
import tarfile

import numpy as np
import pytest
import torch

from gennerf_tpu.data import datamodule as jdm
from gennerf_tpu.data.prepare import prepare_data as jprep
from gennerf_tpu.data.prepare import scannet as jscannet
from gennerf_tpu.data.prepare.sensor_data import SensorData as JSensorData
from gennerf_tpu.utils.mesh import Mesh as JMesh
from gennerf_tpu_torch.data import datamodule as tdm
from gennerf_tpu_torch.data.prepare import prepare_data as tprep
from gennerf_tpu_torch.data.prepare import scannet as tscannet
from gennerf_tpu_torch.data.prepare.sensor_data import SensorData
from gennerf_tpu_torch.data.synthetic import look_at_pose, random_primitives, render_scene
from gennerf_tpu_torch.tools import build_scannet, read_scannet, split_files, staging
from gennerf_tpu_torch.tsdf.tsdf import TSDF
from gennerf_tpu_torch.utils.image import decode_png
from gennerf_tpu_torch.utils.mesh import Mesh
from test_torch_data import _assert_batches_equal

import _torch_threads  # noqa: F401  (sizes torch's threads per xdist worker)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TSDF_TOL, COLOR_TOL, COLOR_SHARE = 1e-5, 1e-3 * 255, 1e-3
SCENES = ("scene0244_01", "scene0000_00")


def _render(H, W, K, n, seed, primitives=None, depth_hw=None, depth_K=None):
    """n ring frames: (depth mm uint16 (T, h, w), colour (T, H, W, 3), poses)."""
    rng = np.random.default_rng(seed)
    depths, colors, poses = [], [], []
    for i in range(n):
        a = 2 * np.pi * i / n + 0.05 * rng.standard_normal()
        if primitives is None:
            pose = look_at_pose([2.2 * np.cos(a), 2.2 * np.sin(a), 1.3], [0, 0, 0.5])
        else:
            pose = look_at_pose([0.6 * np.cos(a), 0.6 * np.sin(a), 1.1], [0.0, 0.0, 0.7])
        d, c = render_scene(H, W, K, pose, primitives=primitives)
        if depth_hw is not None:
            d, _ = render_scene(*depth_hw, depth_K, pose, primitives=primitives)
        depths.append((d * 1000).astype(np.uint16))
        colors.append(c)
        poses.append(pose)
    return np.stack(depths), np.stack(colors), np.stack(poses)


@pytest.fixture(scope="module")
def raw(tmp_path_factory):
    """A raw ScanNet root with two scenes of 6 frames of 48x64, written by
    the JAX writer; the arrays of the first scene."""
    root = str(tmp_path_factory.mktemp("raw"))
    H, W = 48, 64
    K = np.array([[0.6 * W, 0, W / 2], [0, 0.6 * W, H / 2], [0, 0, 1]], np.float32)
    arrays = {}
    for s, scene in enumerate(SCENES):
        d = os.path.join(root, "scans", scene)
        os.makedirs(d)
        depths, colors, poses = _render(H, W, K, 6, seed=s)
        JSensorData.write(os.path.join(d, scene + ".sens"), K, depths, colors, poses)
        arrays[scene] = (K, depths, colors, poses)
    return root, arrays


def _sens(root, scene):
    return os.path.join(root, "scans", scene, scene + ".sens")


def test_sens_both_ways(raw, tmp_path):
    """The port's writer gives the JAX writer's bytes, and each package's
    reader reads the other's file: header, poses, depths and colours."""
    root, arrays = raw
    K, depths, colors, poses = arrays[SCENES[0]]
    ours = str(tmp_path / "ours.sens")
    SensorData.write(ours, K, depths, colors, poses)
    with open(ours, "rb") as a, open(_sens(root, SCENES[0]), "rb") as b:
        assert a.read() == b.read()
    for reader, writer_file in ((SensorData, _sens(root, SCENES[0])), (JSensorData, ours)):
        sd = reader(writer_file)
        ref = JSensorData(_sens(root, SCENES[0]))
        for key in ("sensor_name", "color_compression_type", "depth_compression_type",
                    "color_width", "color_height", "depth_width", "depth_height", "depth_shift"):
            assert getattr(sd, key) == getattr(ref, key), key
        for key in ("intrinsic_color", "extrinsic_color", "intrinsic_depth", "extrinsic_depth"):
            np.testing.assert_array_equal(getattr(sd, key), getattr(ref, key))
        assert len(sd.frames) == 6
        for t, frame in enumerate(sd.frames):
            np.testing.assert_array_equal(frame.camera_to_world, poses[t])
            depth = np.frombuffer(frame.decompress_depth(sd.depth_compression_type), np.uint16)
            np.testing.assert_array_equal(depth.reshape(48, 64), depths[t])
            np.testing.assert_array_equal(frame.decompress_color(sd.color_compression_type),
                                          ref.frames[t].decompress_color("jpeg"))


def _tree(root):
    """{relative path: decoded content} of every file under root (tar
    members by their names; PNGs decoded, as the two PNG writers' bytes
    differ)."""
    out = {}
    for d, _, files in os.walk(root):
        for fn in files:
            p = os.path.join(d, fn)
            rel = os.path.relpath(p, root)
            if fn.endswith(".tar"):
                with tarfile.open(p) as tar:
                    for m in tar.getmembers():
                        data = tar.extractfile(m).read()
                        out[rel + ":" + m.name] = decode_png(data).tobytes() \
                            if m.name.endswith(".png") else data
            else:
                with open(p, "rb") as f:
                    data = f.read()
                out[rel] = decode_png(data).tobytes() if fn.endswith(".png") else data
    return out


@pytest.mark.parametrize("use_tar", [False, True])
def test_exporters_match_jax(raw, tmp_path, use_tar):
    """Colour JPEGs (byte for byte), 16-bit depth PNGs, poses and
    intrinsics of both packages' exporters, with frame_skip 2 and a nearest
    resize of the colour, plain or tarred."""
    root, _ = raw
    for name, cls in (("jax", JSensorData), ("port", SensorData)):
        sd = cls(_sens(root, SCENES[0]), archive_result=use_tar)
        out = tmp_path / name
        sd.export_color_images(str(out / "color"), image_size=(30, 40), frame_skip=2)
        sd.export_depth_images(str(out / "depth"))
        sd.export_poses(str(out / "poses"))
        sd.export_intrinsics(str(out / "intrinsics"))
    ours, ref = _tree(tmp_path / "port"), _tree(tmp_path / "jax")
    assert sorted(ours) == sorted(ref) and len(ours) == (3 + 6 + 6 + 4 if not use_tar else 19)
    for key in ref:
        assert ours[key] == ref[key], key


def _export(raw_root, out):
    """read_scannet (the port's tool) of every scene into out."""
    read_scannet.main(["--path", raw_root, "--output", out, "--workers", "1"])
    return out


def _rewrite_paths(tree: str, src: str, dst: str) -> str:
    return tree.replace(src, dst)


def test_scene_info_and_splits_match_jax(raw, tmp_path):
    """prepare_scannet_scene's info.json and prepare_scannet_splits' files
    equal the JAX ones (paths aside), with the repository's split lists and
    with a list found only beside the raw data."""
    root, _ = raw
    exported = _export(root, str(tmp_path / "exported"))
    with open(os.path.join(exported, "scannetv2_living_train.txt"), "w") as f:
        f.write("scene0244_01\n")
    empty = str(tmp_path / "no_lists")
    os.makedirs(empty)
    for scene in SCENES:
        a = tscannet.prepare_scannet_scene(f"scans/{scene}", exported, str(tmp_path / "t"), 0)
        b = jscannet.prepare_scannet_scene(f"scans/{scene}", exported, str(tmp_path / "j"), 0)
        with open(a) as fa, open(b) as fb:
            assert fa.read() == _rewrite_paths(fb.read(), str(tmp_path / "j"), str(tmp_path / "t"))
    for splits_dir in (None, empty):
        tscannet.prepare_scannet_splits(exported, str(tmp_path / "ts"), splits_dir)
        jscannet.prepare_scannet_splits(exported, str(tmp_path / "js"), splits_dir)
        names = sorted(os.listdir(tmp_path / "js"))
        assert sorted(os.listdir(tmp_path / "ts")) == names
        assert names == (["scannet_living_train.txt"] if splits_dir else
                         sorted(name for name, _, _ in tscannet.SPLITS))
        for name in names:
            ref = (tmp_path / "js" / name).read_text()
            assert (tmp_path / "ts" / name).read_text() == _rewrite_paths(
                ref, str(tmp_path / "js"), str(tmp_path / "ts"))
        shutil.rmtree(tmp_path / "ts")
        shutil.rmtree(tmp_path / "js")


def _assert_volumes_match(ours: TSDF, ref, voxel_size):
    np.testing.assert_allclose(ours.origin.numpy(), np.asarray(ref.origin), rtol=0, atol=1e-5)
    assert tuple(ours.tsdf_vol.shape) == tuple(ref.tsdf_vol.shape)
    assert ours.voxel_size == ref.voxel_size == voxel_size / 100
    np.testing.assert_allclose(ours.tsdf_vol.numpy(), np.asarray(ref.tsdf_vol), rtol=0,
                               atol=TSDF_TOL)
    far = np.abs(ours.attribute_vols["color"].numpy() - np.asarray(ref.attribute_vols["color"]))
    assert (far > COLOR_TOL).mean() <= COLOR_SHARE, float((far > COLOR_TOL).mean())
    assert float(ours.attribute_vols["color"].max()) > 0


def test_fuse_scene_matches_jax(raw, tmp_path):
    """fuse_scene at 16 and 8 cm (the port fuses both in one pass) on the
    exported scene: origin, vol_dim, TSDF, colour volume and the coloured
    mesh against the JAX fuse_scene at each size; info.json records both."""
    root, _ = raw
    exported = _export(root, str(tmp_path / "exported"))
    scene = f"scans/{SCENES[0]}"
    for side in ("t", "j"):
        shutil.copytree(exported, tmp_path / side)
        (tscannet if side == "t" else jscannet).prepare_scannet_scene(
            scene, str(tmp_path / side), str(tmp_path / side), 0)
    tprep.fuse_scene(str(tmp_path / "t"), scene, (16, 8), verbose=0, max_depth=5.0, device="cpu")
    for vs in (16, 8):
        jprep.fuse_scene(str(tmp_path / "j"), scene, vs, verbose=0, max_depth=5.0)
    ti = json.loads((tmp_path / "t" / scene / "info.json").read_text())
    ji = json.loads((tmp_path / "j" / scene / "info.json").read_text())
    assert set(ti) == set(ji)
    from gennerf_tpu.tsdf import TSDF as JTSDF

    for vs in (16, 8):
        ours = TSDF.load(ti["file_name_vol_%02d" % vs])
        _assert_volumes_match(ours, JTSDF.load(ji["file_name_vol_%02d" % vs]), vs)
        tm = Mesh.load(str(tmp_path / "t" / scene / ("mesh_%02d.ply" % vs)))
        jm = JMesh.load(str(tmp_path / "j" / scene / ("mesh_%02d.ply" % vs)))
        assert len(tm.faces) > 100 and tm.vertex_colors is not None
        np.testing.assert_array_equal(tm.faces, jm.faces)
        np.testing.assert_allclose(tm.vertices, jm.vertices, rtol=0, atol=1e-3 * vs / 100)
    # skip_existing: the volumes stay as they are and info.json keeps them
    before = os.path.getmtime(ti["file_name_vol_16"])
    tprep.fuse_scene(str(tmp_path / "t"), scene, (16,), verbose=0, skip_existing=True,
                     device="cpu")
    assert os.path.getmtime(ti["file_name_vol_16"]) == before


def test_prepare_scannet_shards_match_jax(raw, tmp_path):
    """prepare_scannet of shard 0 and 1 of 2 at 16 cm:
    each shard prepares its scene, shard 0 the split files, info.json
    cleaned; against the JAX prepare_scannet of the same shards."""
    root, _ = raw
    exported = _export(root, str(tmp_path / "exported"))
    for side in ("t", "j"):
        shutil.copytree(exported, tmp_path / side)
    for i in (0, 1):
        tprep.prepare_scannet(str(tmp_path / "t"), str(tmp_path / "t"), i, 2, max_depth=5.0,
                              verbose=0, voxel_sizes=(16,), device="cpu")
        jprep.prepare_scannet(str(tmp_path / "j"), str(tmp_path / "j"), i, 2, max_depth=5.0,
                              verbose=0, voxel_sizes=(16,))
    for scene in SCENES:
        ti = json.loads((tmp_path / "t" / "scans" / scene / "info.json").read_text())
        ji = json.loads((tmp_path / "j" / "scans" / scene / "info.json").read_text())
        assert json.dumps(ti) == _rewrite_paths(json.dumps(ji), str(tmp_path / "j"),
                                                str(tmp_path / "t"))
        assert "file_name_image_temp" not in ti["frames"][0]
    for name in os.listdir(tmp_path / "j"):
        if name.endswith(".txt"):
            assert (tmp_path / "t" / name).read_text() == _rewrite_paths(
                (tmp_path / "j" / name).read_text(), str(tmp_path / "j"), str(tmp_path / "t"))


def test_prepare_cli_shards(raw, tmp_path):
    """The CLI (`--i/--n`, `--device cpu`) prepares only its shard's scene;
    an out-of-range shard is refused."""
    root, _ = raw
    exported = _export(root, str(tmp_path / "d"))
    timings = tprep.main(["--path", exported, "--path_meta", exported, "--i", "1", "--n", "2",
                          "--max_depth", "5.0", "--verbose", "0", "--device", "cpu"])
    first, second = sorted(SCENES)
    assert list(timings) == [f"scans/{second}"]
    assert {"info_s", "bounds_s", "fuse_s", "write_s"} <= set(timings[f"scans/{second}"])
    for vs in (4, 8, 16):
        assert os.path.exists(os.path.join(exported, "scans", second, "tsdf_%02d.npz" % vs))
    assert not os.path.exists(os.path.join(exported, "scans", first, "info.json"))
    assert not os.path.exists(os.path.join(exported, "scannet_train.txt"))
    with pytest.raises(SystemExit):
        tprep.main(["--path", exported, "--path_meta", exported, "--i", "2", "--n", "2"])


def _script(name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, "scripts", name + ".py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_tools_match_scripts(raw, tmp_path):
    """read_scannet --tar, build_scannet, staging (--untar) and split_files
    of the port against scripts/: the same trees and files."""
    root, _ = raw
    for side, mods in (("t", (read_scannet, build_scannet, staging, split_files)),
                       ("j", tuple(_script(n) for n in ("read_scannet", "build_scannet",
                                                        "staging", "split_files")))):
        exp, built = str(tmp_path / side / "exp"), str(tmp_path / side / "built")
        mods[0].main(["--path", root, "--output", exp, "--workers", "1", "--tar"])
        mods[1].main(["--source", exp, "--target", built, "--workers", "1"])
        infos = [jscannet.prepare_scannet_scene(f"scans/{s}", built, built, 0) for s in SCENES]
        for i, info in enumerate(infos):
            with open(os.path.join(built, f"list{i}.txt"), "w") as f:
                f.write(info + "\n")
        mods[2].main(["--splits", os.path.join(built, "list0.txt"), "list1.txt", "--source", built,
                      "--target", str(tmp_path / side / "staged"), "--untar"])
        with open(os.path.join(built, "all.txt"), "w") as f:
            f.write("\n".join(f"line{i}" for i in range(7)) + "\n")
        mods[3].main(["--input", os.path.join(built, "all.txt"), "--n", "3"])
    for sub in ("exp", "built", "staged"):
        ours, ref = _tree(tmp_path / "t" / sub), _tree(tmp_path / "j" / sub)
        assert sorted(ours) == sorted(ref) and ours, sub
        for key in ref:
            want = ref[key]
            if key.endswith((".json", ".txt")):
                want = want.replace(str(tmp_path / "j").encode(), str(tmp_path / "t").encode())
            assert ours[key] == want, (sub, key)


# -- a ScanNet-sized JPEG scene through the training loaders -------------------

SCANNET_K = np.array([[1170.19, 0.0, 647.75], [0.0, 1170.19, 483.75], [0.0, 0.0, 1.0]],
                     np.float32)


def scannet_depth_intrinsics(K):
    """The colour camera seen at 640x480 after the 2-row pad: the depth
    intrinsics under which the loaders' resized frames line up."""
    Kd = K.astype(np.float64).copy()
    Kd[1, 2] += 2
    Kd[0] *= 640 / 1296
    Kd[1] *= 480 / 972
    return Kd.astype(np.float32)


@pytest.fixture(scope="module")
def scannet_scene(tmp_path_factory):
    """A 'rooms' scene of 4 frames at ScanNet's sizes (colour 1296x968,
    depth 640x480) written as a .sens by the port, exported with the port's
    tool and prepared at 16 cm; the data directory."""
    root = str(tmp_path_factory.mktemp("scannet"))
    raw = os.path.join(root, "raw", "scans", SCENES[0])
    os.makedirs(raw)
    prims = random_primitives(np.random.default_rng(3), "rooms")
    Kd = scannet_depth_intrinsics(SCANNET_K)
    depths, colors, poses = _render(968, 1296, SCANNET_K, 4, seed=5, primitives=prims,
                                    depth_hw=(480, 640), depth_K=Kd)
    SensorData.write(os.path.join(raw, SCENES[0] + ".sens"), SCANNET_K, depths, colors, poses,
                     intrinsic_depth=Kd)
    data = os.path.join(root, "data")
    read_scannet.main(["--path", os.path.join(root, "raw"), "--output", data, "--workers", "1"])
    tprep.prepare_scannet(data, data, max_depth=5.0, verbose=0, voxel_sizes=(16,), device="cpu")
    with open(os.path.join(data, "one.txt"), "w") as f:
        f.write(f"scans/{SCENES[0]}/info.json\n")
    return data


def test_jpeg_scene_batch_matches_jax(scannet_scene):
    """Train batches of the prepared scene: 1296x968 JPEG frames padded to
    1296x972 and reduced to 640x480, its 16 cm ground truth augmented, the
    same as the JAX data module's (which decodes through PIL)."""
    cfg = dict(datasets_train=["one.txt"], datasets_val=["one.txt"], datasets_test=["one.txt"],
               batch_size=1, dataset_type="sequences", sequence_amount_train=1.0,
               sequence_amount_val=1.0, sequence_amount_test=1.0, sequence_length=4,
               sequence_locations="free", sequence_order="random", num_frames_train=3,
               num_frames_val=3, num_frames_test=3, frame_locations="evenly_spaced",
               frame_order="random", voxel_size=0.16, voxel_dim_train=[12, 12, 8],
               voxel_dim_val=[12, 12, 8], voxel_dim_test=[12, 12, 8], random_rotation_3d=True,
               random_translation_3d=True, pad_xy_3d=0.5, pad_z_3d=0.5, cache_items=False,
               data_dir=scannet_scene, num_workers_train=0, num_workers_val=0)
    jmod = jdm.ScannetDataModule(cfg, seed=2)
    tmod = tdm.ScannetDataModule(cfg, seed=2)
    for _ in range(2):
        for ref, ours in zip(jmod.train_dataloader(), tmod.train_dataloader()):
            _assert_batches_equal(ref, ours)
            assert ours["image"].shape[-3:] == (3, 480, 640)
            assert ours["image"].std() > 10 and (ours["depth"] > 0).mean() > 0.9
