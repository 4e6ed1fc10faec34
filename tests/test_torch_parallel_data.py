"""The data-parallel plumbing of the port on the CPU: the rank-aware
loaders, batch placement, the host prefetch, the platform keys and the
x-slab-sharded grid decode (2 ranks over gloo where a process group is
needed).

- Each rank's loader decodes only its rows of every global batch, each
  item under its global serial's draws, so the ranks' batches put together
  equal the one-process batch bit for bit (two epochs, shuffled, with the
  random 3D transforms); a final batch the ranks do not divide is decoded
  whole on every rank.
- `prefetch_shard` yields the loader's batches in order, raises a
  loader's error on the consumer's side and leaves no thread behind an
  early break, having pulled at most consumed + size + 1 batches (a put
  that lands after the consumer's drain does not pull again).
- `select_platform` in a 2-rank group: devices must equal the ranks on
  the node, num_slices must split them evenly; a batch size the ranks do
  not divide raises in the data module; trainer.node_rank is the node's
  index, so 2 nodes of 2 ranks join as ranks 0-3 (4 gloo ranks), and a
  launcher's RANK off that node raises.
- `decode_grid_sharded` on 2 ranks equals the whole-grid decode bit for
  bit (the plain decode works slab by slab), raises NotImplementedError
  when the ranks do not divide nx, and, through the bf16-feed plain
  decode, holds against the JAX package's decode_grid_fused_sharded on
  the 8-device CPU mesh in interpret mode at the bounds of
  test_torch_grid_decode's kernel test (fewer than 0.1% of points more
  than 1e-4 apart, mean under 1e-5, largest under 5e-2).
"""
import queue
import threading
import types
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gennerf_tpu_torch.data import datamodule as tdm
from gennerf_tpu_torch.data.make_multigeo import make_multigeo
from gennerf_tpu_torch.models.gen_nerf import SceneRepr
from gennerf_tpu_torch.parallel import mesh
from gennerf_tpu_torch.predict import build_model
from gennerf_tpu_torch.train import predict as tpred
from gennerf_tpu_torch.utils.port_params import gen_nerf_params_from_flax

import _torch_threads  # noqa: F401  (sizes torch's threads per xdist worker)
from _torch_parallel import run_ranks, to_numpy_tree
import _torch_parallel_workers as workers

DATA = dict(
    datasets_train=["train.txt"], datasets_val=["val.txt"], datasets_test=["val.txt"],
    batch_size=4, dataset_type="sequences", sequence_amount_train=1.0, sequence_amount_val=2.0,
    sequence_amount_test=1.0, sequence_length=3, sequence_locations="free",
    sequence_order="random", num_frames_train=2, num_frames_val=2, num_frames_test=2,
    frame_locations="evenly_spaced", frame_order="random", voxel_size=0.08,
    voxel_dim_train=[16, 16, 8], voxel_dim_val=[16, 16, 8], voxel_dim_test=[16, 16, 8],
    random_rotation_3d=True, random_translation_3d=True, shuffle_train=True,
    num_workers_train=2, num_workers_val=2)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    """2 training scenes of 9 frames (6 windows an epoch) at 24x32."""
    root = str(tmp_path_factory.mktemp("multigeo"))
    make_multigeo(root, train=2, frames=9, height=24, width=32, voxel_sizes=(8,))
    return root


def _epochs(loader, n=2):
    return [b for _ in range(n) for b in loader]


@pytest.mark.parametrize("world", [2, 4])
def test_rank_loaders_make_the_one_process_batch(dataset, world):
    """Two epochs of the train loader (6 windows, batches of 4 and 2):
    rank r's rows are rows [r*k, (r+1)*k) of the one-process batch, bit
    for bit; at 4 ranks the batch of 2 is whole on every rank."""
    cfg = dict(DATA, data_dir=dataset)
    one = _epochs(tdm.ScannetDataModule(cfg, seed=3).train_dataloader())
    ranks = [_epochs(tdm.ScannetDataModule(cfg, num_devices=world, seed=3,
                                           rank=r).train_dataloader()) for r in range(world)]
    assert [len(b["image"]) for b in one] == [4, 2, 4, 2]
    for i, ref in enumerate(one):
        n = len(ref["image"])
        split = n % world == 0
        for r in range(world):
            got = ranks[r][i]
            assert got["shard"] == split
            rows = slice(r * n // world, (r + 1) * n // world) if split else slice(0, n)
            assert set(got) == set(ref) | {"shard"}
            for k, v in ref.items():
                if isinstance(v, np.ndarray):
                    np.testing.assert_array_equal(got[k], v[rows], err_msg=k)
                else:
                    assert got[k] == v[rows], k
    # the draws do differ between epochs and windows (shuffle, transforms)
    assert not np.array_equal(one[0]["pose"], one[2]["pose"])


def test_batch_size_must_divide_by_the_ranks():
    with pytest.raises(ValueError, match="not divisible"):
        tdm.ScannetDataModule(dict(DATA, batch_size=3), num_devices=2)


def test_shard_batch_rows_and_partial_batch():
    """Rows of every array and list; a partial batch stays whole with one
    warning."""
    batch = {"image": np.arange(8).reshape(4, 2), "scene": ["a", "b", "c", "d"], "k": 3}
    local, split = mesh.shard_batch(batch, 2, 1)
    assert split and local["scene"] == ["c", "d"] and local["k"] == 3
    np.testing.assert_array_equal(local["image"], batch["image"][2:])
    mesh._REPLICATE_WARNED[0] = False
    with pytest.warns(UserWarning, match="not divisible"):
        whole, split = mesh.shard_batch({"image": np.zeros((3, 1))}, 2, 0)
    assert not split and whole["image"].shape == (3, 1)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        mesh.shard_batch({"image": np.zeros((3, 1))}, 2, 0)
    assert mesh.shard_batch(batch, 1, 0) == (batch, False)


def _batches(n):
    return [{"image": np.full((2, 3), i, np.float32), "name": [str(i)] * 2} for i in range(n)]


@pytest.mark.parametrize("size", [0, 1, 3])
def test_prefetch_keeps_order(size):
    """The same batches in the same order, uploaded (float32 tensors)."""
    got = list(mesh.prefetch_shard(iter(_batches(7)), "cpu", size))
    assert [raw["name"][0] for raw, _ in got] == [str(i) for i in range(7)]
    for i, (raw, staged) in enumerate(got):
        assert set(staged) == {"image"} and staged["image"].dtype == torch.float32
        assert torch.equal(staged["image"], torch.full((2, 3), float(i)))


def test_prefetch_reraises_a_loader_error():
    def loader():
        yield from _batches(3)
        raise KeyError("broken item")

    seen = []
    with pytest.raises(KeyError, match="broken item"):
        for raw, _ in mesh.prefetch_shard(loader(), "cpu", 2):
            seen.append(raw["name"][0])
    assert seen == ["0", "1", "2"]


@pytest.mark.parametrize("size,consumed", [(1, 1), (2, 3), (3, 2)])
def test_prefetch_break_leaves_no_thread(monkeypatch, size, consumed):
    """An early break closes the generator: its thread stops, and the pass
    has taken at most consumed + size + 1 batches from the loader. The
    consumer breaks off while the thread, its queue full, is inside a put
    with the last batch the bound allows in hand (the test's queue waits
    for room without a timeout, so that put lands after the consumer's
    drain on every run); the thread must then stop without pulling again."""
    pulled, threads = [], set()
    in_hand = consumed + size + 1
    full_put = threading.Event()

    def loader():
        for b in _batches(100):
            threads.add(threading.current_thread())
            pulled.append(b)
            yield b

    class WaitingQueue(queue.Queue):
        def put(self, item, block=True, timeout=None):
            if self.full() and len(pulled) == in_hand:
                full_put.set()
            super().put(item, block, None)

    monkeypatch.setattr(mesh, "queue", types.SimpleNamespace(
        Queue=WaitingQueue, Full=queue.Full, Empty=queue.Empty))
    gen = mesh.prefetch_shard(loader(), "cpu", size)
    for i, _ in enumerate(gen):
        if i == consumed - 1:
            break
    assert full_put.wait(5)
    gen.close()
    (worker,) = threads
    worker.join(5)
    assert not worker.is_alive()
    assert len(pulled) <= in_hand, (len(pulled), in_hand)


def test_platform_keys_in_a_two_rank_group():
    """devices 2 / auto and num_nodes 1 take the group; devices 3 and
    num_slices 3 raise ValueError naming the key; num_slices 2 maps onto
    the 2 ranks."""
    cases = [{"devices": 2}, {"devices": "auto", "num_slices": 2}, {"devices": 3},
             {"num_slices": 3}, {"devices": 1, "num_nodes": 2}]
    for got in run_ranks(workers.platform_rank, 2, args=(cases,)):
        assert got[:2] == ["cpu", "cpu"] and got[4] == "cpu"
        assert got[2][0] == "ValueError" and "trainer.devices=3" in got[2][1]
        assert got[3][0] == "ValueError" and "num_slices=3" in got[3][1]


CFG = {
    "type": "GenNerf", "voxel_size": 0.08,
    "voxel_dim_train": [16, 16, 8], "voxel_dim_val": [16, 16, 8], "voxel_dim_test": [16, 16, 8],
    "encoder": {"use_spatial": False, "use_pointnet": True,
                "pointnet": {"num_sparse_points": 32, "c_dim": 8, "hidden_dim": 8,
                             "plane_resolution": 16, "n_blocks": 2, "unet": False}},
    "mlp": {"d_out_sem": 1, "d_out_geo": 8, "n_blocks": 2, "d_hidden": 32},
}
VOXEL_DIM = (16, 16, 64)
ORIGIN = np.array([0.05, -0.1, 0.02], np.float32)


@pytest.fixture(scope="module")
def decoder():
    """(JAX task, variables, port state) of one model, every residual
    block's fc_1 and the head drawn at random; random planes."""
    from gennerf_tpu.train.tasks import GenNerfTask

    rng = np.random.default_rng(0)
    task = GenNerfTask(CFG)
    B, T, H, W = 1, 2, 12, 16
    batch = {"projection": rng.standard_normal((B, T, 3, 4)).astype(np.float32),
             "image": rng.standard_normal((B, T, 3, H, W)).astype(np.float32),
             "depth": (rng.random((B, T, H, W)) + 0.5).astype(np.float32),
             "vol_08_tsdf": rng.uniform(-1, 1, (B, 1, 16, 16, 8)).astype(np.float32)}
    batch["projection"][:, :, 2, 2] = 1.0
    state = task.init_state(jax.random.PRNGKey(0), batch)
    tree = jax.tree.map(lambda a: np.array(a, np.float32), dict(state.params))
    for blk in tree["mlp"].values():
        if isinstance(blk, dict) and "Dense_1" in blk:
            blk["Dense_1"]["kernel"] = (0.2 * rng.standard_normal(
                blk["Dense_1"]["kernel"].shape)).astype(np.float32)
    planes = {k: (0.5 * rng.standard_normal((1, 8, 16, 16))).astype(np.float32)
              for k in ("xz", "xy", "yz")}
    return task, tree, to_numpy_tree(gen_nerf_params_from_flax(tree)), planes


@pytest.mark.parametrize("named", [True, False], ids=["rank-named", "node-rank"])
def test_node_rank_on_two_nodes_of_two_ranks(named):
    """trainer.node_rank is the node's index: on 2 "nodes" of 2 ranks each
    (4 gloo ranks), every rank joins at node_rank * 2 + LOCAL_RANK, with
    the launcher naming RANK too or not, and a sum over the group counts
    each rank once."""
    for r, got in enumerate(run_ranks(workers.node_rank_rank, 4, args=(named,), join=False)):
        assert got == {"rank": r, "world": 4, "device": "cpu", "sum": 6.0}


def test_node_rank_off_the_launchers_rank_raises(monkeypatch):
    """A rank the launcher names that does not lie on trainer.node_rank's
    node raises before joining."""
    from gennerf_tpu_torch.parallel.platform import select_platform

    for k, v in dict(WORLD_SIZE="4", RANK="3", LOCAL_RANK="1", LOCAL_WORLD_SIZE="2",
                     MASTER_ADDR="localhost", MASTER_PORT="1").items():
        monkeypatch.setenv(k, v)
    with pytest.raises(ValueError, match="node_rank=0"):
        select_platform({"devices": 2, "num_nodes": 2, "node_rank": 0}, "cpu")


def test_sharded_decode_equals_whole_grid(decoder):
    """2 ranks, each its x-slab through the plain decode, gathered: the
    whole-grid decode bit for bit, on both ranks; nx 15 raises."""
    _, _, state, planes = decoder
    model = build_model(CFG, "cpu", 0, "32-true")
    model.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    repr_ = SceneRepr({k: torch.from_numpy(v) for k, v in planes.items()})
    whole = tpred.predict_tsdf_volume(model, repr_, VOXEL_DIM, 0.08, torch.from_numpy(ORIGIN))
    assert torch.equal(whole, tpred.predict_tsdf_volume(
        model, repr_, VOXEL_DIM, 0.08, torch.from_numpy(ORIGIN), sharded=True))
    for got in run_ranks(workers.decode_rank, 2,
                         args=(CFG, state, planes, VOXEL_DIM, ORIGIN)):
        np.testing.assert_array_equal(got, whole.numpy())
    for got in run_ranks(workers.decode_rank, 2, args=(CFG, state, planes, (15, 16, 8), ORIGIN)):
        assert "nx=15 not divisible by 2 ranks" in got


def test_sharded_decode_matches_jax_sharded(decoder):
    """The 2-rank bf16-feed decode against decode_grid_fused_sharded on
    the 8-device CPU mesh (interpret mode)."""
    from jax.sharding import Mesh

    from gennerf_tpu.models.gen_nerf import SceneRepr as JRepr
    from gennerf_tpu.train.predict import decode_grid_fused_sharded

    task, tree, state, planes = decoder
    jmesh = Mesh(np.array(jax.devices()[:8]), ("data",))
    repr_j = JRepr(None, None, {k: jnp.asarray(v) for k, v in planes.items()})
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(decode_grid_fused_sharded(
            task.model, {"params": jax.tree.map(jnp.asarray, tree), "batch_stats": {}}, repr_j,
            VOXEL_DIM, 0.08, jnp.asarray(ORIGIN), jmesh, interpret=True))
    ours = run_ranks(workers.decode_rank, 2, args=(CFG, state, planes, VOXEL_DIM, ORIGIN),
                     kwargs={"bf16_feeds": True})
    np.testing.assert_array_equal(ours[0], ours[1])
    err = np.abs(ours[0] - ref)
    assert (err > 1e-4).mean() < 1e-3 and err.mean() < 1e-5 and err.max() < 5e-2, (
        (err > 1e-4).mean(), err.mean(), err.max())
