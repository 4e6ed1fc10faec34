"""A closed loop of reconstruct requests: one client sends its next request
when the last one's volume has reached the host. A request is one scene
through the program's `predict.reconstruct` at the configuration's
voxel_dim_test, with the fusion prior; its float32 volume is copied to the
host. Scenes come from a pool made on the card from the seed, each with its
encoder draws (presample indices and farthest-point starts) injected.

Mix keys: pool (scenes), warmup (requests in set-up), room (the scene
generator's room: portbench/core/scenes.py).

The volume is copied into one pinned host buffer, reused by every request
(a pageable copy stalls the card and spreads the tail). Correctness: one
finished request of each pool scene, its number among that scene's
requests drawn from the seed (the last one where the window ends first),
is kept and held against the reference's volume (band_logit_rel_rms_gap,
prior_mismatches, fps_bad_picks).
"""
from __future__ import annotations

import time

import torch

from ..core import port, scenes
from ..core.trace import Window, quarters


def prepare(ctx) -> dict:
    cfg, tr, dev = ctx.cfg, ctx.traffic, ctx.device
    model, weights = port.build(cfg["model"], cfg["precision"], dev, ctx.seed)
    ctx.mark("model built")
    gen = scenes.generator(ctx.seed, 1, dev)
    extent = [int(n) * cfg["voxel_size"] for n in cfg["voxel_dim_test"]]
    T, H, W = cfg["num_frames"], cfg["frame_height"], cfg["frame_width"]
    presample = cfg["model"]["encoder"]["pointnet"]["fps_presample"]
    pool = []
    for _ in range(tr["pool"]):
        s = scenes.make_scene(gen, extent, T, H, W, tr["room"], dev)
        s["sel"] = torch.randint(0, H * W, (T, presample), generator=gen, device=dev)
        s["start"] = torch.randint(0, presample, (T,), generator=gen, device=dev)
        pool.append(s)
    host = torch.empty(tuple(int(n) for n in cfg["voxel_dim_test"]), dtype=torch.float32,
                       pin_memory=dev.type == "cuda")
    # which of each scene's requests is kept for the comparison
    picks = torch.randint(0, tr["sample_within"], (tr["pool"],), generator=gen, device=dev)
    return {"model": model, "weights": weights, "pool": pool, "store": {}, "host": host,
            "keep": picks.tolist()}


def request(st: dict, i: int, keep: bool = True):
    """One request of pool scene i: (the volume on the host, the encoder's
    sparse points), the volume a copy of the host buffer where `keep`."""
    s = st["pool"][i]
    with torch.profiler.record_function("portbench.request"):
        vol = port.reconstruct(st["model"], s, s["sel"], s["start"])
        with torch.profiler.record_function("portbench.host_copy"):
            st["host"].copy_(vol)
    return (st["host"].clone() if keep else None), st["store"].get("points")


def first(ctx, st: dict) -> dict:
    """One request of each pool scene: {scene: (volume, points)}."""
    handle = port.capture_encoder_points(st["model"], st["store"])
    try:
        return {i: request(st, i) for i in range(len(st["pool"]))}
    finally:
        handle.remove()


def window(ctx, st: dict) -> dict:
    """Warm up, then the measured window. Returns the end-to-end readings,
    the sampled answers and what the per-layer readers need."""
    pool = len(st["pool"])
    handle = port.capture_encoder_points(st["model"], st["store"])
    for k in range(ctx.traffic["warmup"]):
        request(st, k % pool)
    if ctx.device.type == "cuda":
        torch.cuda.synchronize(ctx.device)
    setup_s = time.perf_counter() - ctx.t0
    ctx.mark("set-up done")
    seen, sample, lat, starts = [0] * pool, {}, [], []
    with Window(ctx.trace) as win:
        while time.perf_counter() - win.t0 < ctx.seconds:
            i = len(lat) % pool
            t = time.perf_counter()
            starts.append(t - win.t0)
            vol, points = request(st, i, keep=seen[i] == st["keep"][i])
            lat.append(time.perf_counter() - t)
            if vol is not None:
                sample[i] = (vol, points)
            seen[i] += 1
        win.stop()
    for i in range(pool):  # a window that ended before the drawn request: one more of it
        if i not in sample:
            sample[i] = request(st, i)
    handle.remove()
    lat_ms = sorted(x * 1e3 for x in lat)
    n = len(lat_ms)
    p95 = lat_ms[min(n - 1, max(0, int(round(0.95 * (n - 1)))))] if n else float("nan")
    return {"end_to_end": {"setup_s": setup_s, "infer_per_s": n / win.seconds,
                           "infer_p95_ms": p95},
            "attempted": n, "failed": 0, "answers": sample, "window": win,
            "work": {"requests": n, "steps": 0, "items": 0},
            "info": {"requests_per_quarter": quarters(starts, ctx.seconds)}}


def judge(ctx, st: dict, answers: dict) -> dict:
    """The worst readings over the sampled answers."""
    ref = ctx.reference
    worst = {"band_logit_rel_rms_gap": 0.0, "band_rel_rms_gap": 0.0, "prior_mismatches": 0.0,
             "fps_bad_picks": 0.0}
    info = {"ambiguous_share": 0.0, "band_share": 0.0, "band_saturated_share": 0.0}
    for i in sorted(answers):
        vol, points = answers[i]
        s = st["pool"][i]
        rvol, near, amb, bad = ref.reconstruct(ctx.cfg, st["weights"], s, s["sel"], s["start"],
                                               points)
        got = ref.compare_volume(vol, rvol, near, amb)
        for k in ("band_logit_rel_rms_gap", "band_rel_rms_gap"):
            worst[k] = max(worst[k], got[k])
        worst["prior_mismatches"] += got["prior_mismatches"]
        worst["fps_bad_picks"] += bad
        for k in info:
            info[k] = max(info[k], got[k])
    return {"checks": worst, "info": info}


def control(ctx, st: dict) -> dict:
    """The reference in fp8 in the program's place: its answers for every
    pool scene, with its own farthest points."""
    ref = ctx.reference
    out = {}
    for i, s in enumerate(st["pool"]):
        pts, _ = ref.sparse_points(ctx.cfg, s["depth"], s["projection"], s["sel"], s["start"], None)
        vol, _, _, _ = ref.reconstruct(ctx.cfg, st["weights"], s, s["sel"], s["start"], pts,
                                       precision="fp8")
        out[i] = (vol.cpu(), pts)
    return out


def release(st: dict) -> None:
    st.pop("model", None)
    st["store"].clear()


def work_counts(ctx) -> dict:
    """Per-request shapes the counts need."""
    pn = ctx.cfg["model"]["encoder"]["pointnet"]
    return {"fps_clouds": ctx.cfg["num_frames"], "fps_points": pn["fps_presample"],
            "fps_npoint": pn["num_sparse_points"], "grid": list(ctx.cfg["voxel_dim_test"])}
