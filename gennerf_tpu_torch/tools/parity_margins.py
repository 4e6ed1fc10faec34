"""Margins of the port's parity tests: a pytest plugin and its report.

A margin is the observed distance over the limit the assertion allows
(1.0 is the edge). The plugin records one for every call, in the tests it
runs, of

- `numpy.testing.assert_allclose`: max |a - b| / (atol + rtol |b|) over
  the elements (the `_close` helpers of the tests/test_torch_*.py files
  call it); a call with both tolerances 0 is an exact comparison and is
  recorded with margin 0 or inf;
- `pytest.approx` on a scalar (the public `pytest.approx`, wrapped):
  |a - b| / its tolerance;
- a test module's `_near` (bf16 against JAX's bf16, the gap to float32 as
  the limit): the larger of its mean and max ratios;
- a test module's `_close_to_kernel` (a decode against the kernel bounds):
  the largest of its three ratios;
- `_torch_referee.assert_nearer_float64`: the port's distance from the
  float64 referee over its limit (`factor` times JAX's, or `cap`);

with the test's node id and the line of the test file that called it.
Other assertions (a bare `assert d <= bound`) are not seen. Without
PARITY_MARGINS in the environment the plugin does nothing.

    PARITY_MARGINS=DIR python -m pytest -p gennerf_tpu_torch.tools.parity_margins \\
        tests/test_torch_*.py [-n 6 --dist loadfile]
    python -m gennerf_tpu_torch.tools.parity_margins DIR [--min 0.5]

The first writes DIR/margins-<worker>.jsonl; the second prints, for every
assertion site, its worst margin over the run, the test that read it and
the call count, worst first.
"""
from __future__ import annotations

import functools
import json
import math
import os
import sys
import traceback

import numpy as np

_OUT = os.environ.get("PARITY_MARGINS")
_WRAPPED = ("_near", "_close_to_kernel", "assert_nearer_float64")


def _site() -> str:
    """file:line in a tests/test_torch_* file: the innermost test function's
    frame (past the module's helpers), else the innermost frame there."""
    frames = [f for f in traceback.extract_stack()[:-2]
              if os.path.basename(f.filename).startswith("test_torch_")]
    for frame in reversed(frames):
        if frame.name.startswith("test"):
            return f"{os.path.basename(frame.filename)}:{frame.lineno}"
    return f"{os.path.basename(frames[-1].filename)}:{frames[-1].lineno}" if frames else "?"


def _record(kind: str, margin: float, **extra) -> None:
    if not _OUT:
        return
    test = os.environ.get("PYTEST_CURRENT_TEST", "?").rsplit(" (", 1)[0]
    worker = os.environ.get("PYTEST_XDIST_WORKER", "main")
    rec = {"test": test, "site": _site(), "kind": kind,
           "margin": margin if math.isfinite(margin) else "inf", **extra}
    with open(os.path.join(_OUT, f"margins-{worker}.jsonl"), "a") as f:
        f.write(json.dumps(rec) + "\n")


def allclose_margin(actual, desired, rtol: float, atol: float) -> float:
    """max |a - b| / (atol + rtol |b|); positions NaN on both sides skipped;
    an element off with a zero allowance gives inf."""
    a = np.asarray(actual, np.float64)
    b = np.broadcast_to(np.asarray(desired, np.float64), a.shape)
    keep = ~(np.isnan(a) & np.isnan(b))
    if not keep.any():
        return 0.0
    a, b = a[keep], b[keep]
    diff = np.abs(a - b)
    diff[a == b] = 0.0  # equal infinities
    allow = atol + rtol * np.abs(b)
    with np.errstate(divide="ignore", invalid="ignore"):
        ratio = np.where(diff == 0, 0.0, diff / allow)
    return float(np.nan_to_num(ratio, nan=np.inf).max())


def _wrap_allclose(orig):
    @functools.wraps(orig)
    def assert_allclose(actual, desired, rtol=1e-7, atol=0, *args, **kwargs):
        try:
            margin = allclose_margin(actual, desired, rtol, atol)
            _record("assert_allclose", margin, rtol=float(rtol), atol=float(atol),
                    exact=rtol == 0 and atol == 0)
        except (TypeError, ValueError):  # shapes or types numpy will report itself
            pass
        return orig(actual, desired, rtol, atol, *args, **kwargs)
    return assert_allclose


class _RecordedApprox:
    """A scalar `pytest.approx` that records its margin when compared."""

    def __init__(self, approx):
        self.approx = approx

    def __eq__(self, actual):
        try:
            tol = float(self.approx.tolerance)
            diff = abs(float(actual) - float(self.approx.expected))
            _record("approx", 0.0 if diff == 0 else (diff / tol if tol else math.inf))
        except (TypeError, ValueError, OverflowError):
            pass
        return self.approx == actual

    def __ne__(self, actual):
        return not self == actual

    def __repr__(self):
        return repr(self.approx)


def _wrap_approx(orig):
    @functools.wraps(orig)
    def approx(expected, *args, **kwargs):
        out = orig(expected, *args, **kwargs)
        return _RecordedApprox(out) if hasattr(out, "tolerance") else out
    return approx


def near_margin(ours, ref16, ref32, share: float, floor: float = 0.0) -> float:
    """The bf16 `_near` rule's margin: mean|o - a| over share * mean|a - b|,
    max|o - a| over max|a - b| (each limit + floor * max|b|, the floor at
    least 1e-6 where the gap is 0, as test_torch_options_bf16's rule)."""
    o, a, b = (np.asarray(x, np.float64) for x in (ours, ref16, ref32))
    gap, err = np.abs(a - b), np.abs(o - a)
    tol = max(floor, 1e-6 if gap.max() == 0 else 0.0) * np.abs(b).max()
    lim_mean, lim_max = share * gap.mean() + tol, gap.max() + tol
    return max(err.mean() / lim_mean if lim_mean else (0.0 if err.mean() == 0 else math.inf),
               err.max() / lim_max if lim_max else (0.0 if err.max() == 0 else math.inf))


def _numpy(x):
    if hasattr(x, "detach"):
        x = x.detach().float().cpu().numpy()
    return np.asarray(x, np.float64)


def _wrap_near(orig):
    @functools.wraps(orig)
    def _near(ours, ref16, ref32, share, floor=0.0, name=""):
        try:
            _record("_near", near_margin(_numpy(ours), _numpy(ref16), _numpy(ref32), share, floor),
                    name=name)
        except (TypeError, ValueError):
            pass
        return orig(ours, ref16, ref32, share, floor, name)
    return _near


def _wrap_kernel(orig):
    @functools.wraps(orig)
    def _close_to_kernel(ours, ref):
        err = np.abs(_numpy(ours) - _numpy(ref))
        _record("_close_to_kernel", max((err > 1e-4).mean() / 1e-2, err.mean() / 1e-5,
                                        err.max() / 5e-2))
        return orig(ours, ref)
    return _close_to_kernel


def _wrap_referee(orig):
    @functools.wraps(orig)
    def assert_nearer_float64(ours, jax32, ref64, name="", factor=None, cap=math.inf):
        import _torch_referee

        factor = _torch_referee.FACTOR if factor is None else factor
        d_ours, d_jax = (_torch_referee.distance(_numpy(x), _numpy(ref64)) for x in (ours, jax32))
        limit = min(factor * d_jax, cap)
        _record("assert_nearer_float64", d_ours / limit if limit else math.inf, name=name)
        return orig(ours, jax32, ref64, name, factor, cap)
    return assert_nearer_float64


def pytest_configure(config):
    if not _OUT:
        return
    os.makedirs(_OUT, exist_ok=True)
    import pytest

    np.testing.assert_allclose = _wrap_allclose(np.testing.assert_allclose)
    pytest.approx = _wrap_approx(pytest.approx)


def pytest_collection_modifyitems(session, config, items):
    if not _OUT:
        return
    wrappers = {"_near": _wrap_near, "_close_to_kernel": _wrap_kernel,
                "assert_nearer_float64": _wrap_referee}
    for mod in {item.module for item in items if getattr(item, "module", None)}:
        for name in _WRAPPED:
            if callable(getattr(mod, name, None)):
                setattr(mod, name, wrappers[name](getattr(mod, name)))


def report(out_dir: str, minimum: float = 0.0) -> list:
    """(site, worst margin, test, calls) rows, worst first."""
    worst = {}
    for fn in sorted(os.listdir(out_dir)):
        if not fn.startswith("margins-"):
            continue
        with open(os.path.join(out_dir, fn)) as f:
            for line in f:
                rec = json.loads(line)
                if rec.get("exact"):
                    continue
                m = math.inf if rec["margin"] == "inf" else rec["margin"]
                key = (rec["site"], rec["kind"])
                best = worst.get(key)
                if best is None or m > best[1]:
                    worst[key] = [rec["site"], m, rec["test"], (best or [0, 0, 0, 0])[3] + 1]
                else:
                    best[3] += 1
    rows = sorted(worst.values(), key=lambda r: -r[1])
    return [r for r in rows if r[1] >= minimum]


if __name__ == "__main__":
    args = sys.argv[1:]
    floor_ = float(args[args.index("--min") + 1]) if "--min" in args else 0.0
    for site, margin, test, calls in report(args[0], floor_):
        print(f"{margin:8.3f}  {site:40s} {calls:5d}  {test}")
