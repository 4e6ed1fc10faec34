"""Training steps back to back: the program's `train.step.train_step` with
its Adam on the configuration's batch, cycling a pool of batches made on
the card from the seed, each with its step draws injected. Steps are
dispatched ahead with no host synchronization; the losses are read once
the window has closed.

Mix keys: pool (batches, at least `compared`), compared (the first steps,
in set-up, that the reference follows), warmup (further steps in set-up),
room (the scene generator's room: portbench/core/scenes.py).

Correctness (set-up's first steps, through the window's own call on rows
that all differ): each step's loss, the first gradient as Adam took it
(from its first moment after one step), each parameter's and BatchNorm
statistic's change after the first and after all compared steps, against
the reference, by the worst leaf and by the median leaf; the cell's
limits file names the readings compared.
"""
from __future__ import annotations

import time

import torch

from ..core import port, scenes
from ..core.trace import Window, quarters

BETA1 = 0.9
JUDGES_FIRST_STEPS = True  # set-up's first steps are what the reference follows


def prepare(ctx) -> dict:
    cfg, tr, dev = ctx.cfg, ctx.traffic, ctx.device
    model, weights = port.build(cfg["model"], cfg["precision"], dev, ctx.seed, train=True)
    opt = port.make_optimizer(model, cfg["model"])
    ctx.mark("model built")
    gen = scenes.generator(ctx.seed, 2, dev)
    B, T = cfg["batch_size"], cfg["num_frames"]
    H, W = cfg["frame_height"], cfg["frame_width"]
    m = cfg["model"]
    pool = []
    for _ in range(tr["pool"]):
        batch = scenes.training_batch(gen, B, T, H, W, cfg["voxel_dim_train"], cfg["voxel_size"],
                                      tr["room"], dev, cfg.get("ground_truth_cm", ()))
        draws = {}
        if m.get("type") == "GenNerf":
            presample = m["encoder"]["pointnet"]["fps_presample"]
            ray = m["ray"]
            draws = {
                "sel": torch.randint(0, H * W, (B * T, presample), generator=gen, device=dev),
                "start": torch.randint(0, presample, (B * T,), generator=gen, device=dev),
                "scores": torch.rand(B * T, H * W, generator=gen, device=dev),
                "noise": torch.randn(B * T, ray["num_rays"], ray["M"], generator=gen, device=dev),
            }
        pool.append((batch, draws))
    return {"model": model, "opt": opt, "weights": weights, "pool": pool, "store": {}}


def step(st: dict, k: int):
    batch, draws = st["pool"][k % len(st["pool"])]
    with torch.profiler.record_function("portbench.step"):
        return port.train_step(st["model"], st["opt"], batch, draws)


def first(ctx, st: dict) -> dict:
    """The compared steps: their losses, the encoder's picks of each, Adam's
    first gradient and the state after the last."""
    store = st["store"]
    handle = port.capture_encoder_points(st["model"], store) \
        if hasattr(st["model"], "pointnet") else None
    losses, picks, grad = [], [], None
    try:
        for k in range(ctx.traffic["compared"]):
            losses.append(port.step_loss(step(st, k)))
            picks.append(store.pop("points", None))
            if k == 0:
                grad = {n: g / (1 - BETA1) for n, g in
                        port.adam_first_moments(st["model"], st["opt"]).items()}
                after1 = port.state_copy(st["model"])
    finally:
        if handle is not None:
            handle.remove()
    return {"losses": [float(x) for x in losses], "picks": picks, "grad": grad,
            "after1": after1, "after": port.state_copy(st["model"])}


def window(ctx, st: dict) -> dict:
    tr = ctx.traffic
    for k in range(tr["warmup"]):
        step(st, tr["compared"] + k)
    sync = (lambda: torch.cuda.synchronize(ctx.device)) if ctx.device.type == "cuda" \
        else (lambda: None)
    sync()
    setup_s = time.perf_counter() - ctx.t0
    ctx.mark("set-up done")
    losses, starts = [], []
    k = tr["compared"] + tr["warmup"]
    with Window(ctx.trace) as win:
        while time.perf_counter() - win.t0 < ctx.seconds:
            starts.append(time.perf_counter() - win.t0)
            losses.append(port.step_loss(step(st, k)))
            k += 1
        sync()
        win.stop()
    n = len(losses)
    failed = int((~torch.isfinite(torch.stack(losses))).sum()) if n else 0
    items = n * ctx.cfg["batch_size"] * ctx.chips
    return {"end_to_end": {"setup_s": setup_s, "train_scenes_per_s": items / win.seconds},
            "attempted": n, "failed": failed, "window": win,
            "work": {"requests": 0, "steps": n, "items": items},
            "info": {"steps_per_quarter": quarters(starts, ctx.seconds)}}



def judge(ctx, st: dict, got: dict) -> dict:
    """Every reading of the compared steps; the cell's limits file names
    the ones compared. Leaf readings come by the worst leaf (`*_gap`) and by
    the median leaf (`*_median_gap`)."""
    ref = ctx.reference
    n = ctx.traffic["compared"]
    steps = [(st["pool"][k][0], st["pool"][k][1], got["picks"][k]) for k in range(n)]
    r_losses, r_grad, r_change, bad = ref.train_steps(ctx.cfg, st["weights"], steps)
    r_change1 = ref.train_steps(ctx.cfg, st["weights"], steps[:1])[2] if n > 1 else r_change
    w = st["weights"]
    zero = {k: torch.zeros_like(v) for k, v in r_grad.items()}
    p_grad = {**zero, **(got["grad"] or {})}
    gaps = [abs(a - b) / max(abs(b), 1e-30) for a, b in zip(got["losses"], r_losses)]
    checks = {"loss_rel_gap": max(gaps), "loss1_rel_gap": gaps[0], "fps_bad_picks": float(bad)}
    info = {"losses": got["losses"], "reference_losses": r_losses}
    g = ref.leaf_gaps(p_grad, r_grad, r_grad)
    checks.update(grad_norm_gap=g["worst"], grad_median_gap=g["median"])
    info.update(grad_worst_leaf=g["leaf"], leaves_left_out=g["left_out"])
    params = [k for k in r_change if k in r_grad]
    stats = [k for k in r_change if k not in r_grad]
    for name, after, change in (("change", got["after"], r_change),
                                ("change1", got["after1"], r_change1)):
        c = ref.leaf_gaps({k: after[k] - w[k] for k in params}, {k: change[k] for k in params},
                          r_grad)
        checks.update({f"{name}_norm_gap": c["worst"], f"{name}_median_gap": c["median"]})
        info[f"{name}_worst_leaf"] = c["leaf"]
        if stats:  # BatchNorm running statistics
            ones = {k: torch.ones(()) for k in stats}
            c = ref.leaf_gaps({k: after[k] - w[k] for k in stats},
                              {k: change[k] for k in stats}, ones)
            key = "stats" if name == "change" else "stats1"
            checks.update({f"{key}_change_gap": c["worst"], f"{key}_median_gap": c["median"]})
            info[f"{key}_worst_leaf"] = c["leaf"]
    return {"checks": checks, "info": info}


def control(ctx, st: dict) -> dict:
    """The reference in fp8 in the program's place, with its own farthest
    points: the same readings the program's compared steps give."""
    ref = ctx.reference
    steps, picks = [], []
    for k in range(ctx.traffic["compared"]):
        batch, draws = st["pool"][k]
        pts = None
        if "sel" in draws:
            B, T, H, W = batch["depth"].shape
            pts, _ = ref.sparse_points(ctx.cfg, batch["depth"].reshape(B * T, H, W),
                                       batch["projection"].reshape(B * T, 3, 4), draws["sel"],
                                       draws["start"], None)
        steps.append((batch, draws, pts))
        picks.append(pts)
    losses, grad, change, _ = ref.train_steps(ctx.cfg, st["weights"], steps, precision="fp8")
    change1 = ref.train_steps(ctx.cfg, st["weights"], steps[:1], precision="fp8")[2]
    w = st["weights"]
    return {"losses": losses, "picks": picks, "grad": grad,
            "after": {k: w[k].float() + v for k, v in change.items()},
            "after1": {k: w[k].float() + v for k, v in change1.items()}}


def release(st: dict) -> None:
    for k in ("model", "opt"):
        st.pop(k, None)


def work_counts(ctx) -> dict:
    c = ctx.cfg
    pn = c["model"].get("encoder", {}).get("pointnet", {})
    return {"fps_clouds": c["batch_size"] * c["num_frames"], "fps_points": pn.get("fps_presample"),
            "fps_npoint": pn.get("num_sparse_points")}
