"""Nothing of the benchmark, nor what a run loads, has the top-level name
jax, jaxlib, flax or gennerf_tpu (compared whole: gennerf_tpu_torch is the
program); the references load nothing of gennerf_tpu_torch."""
import os
import subprocess
import sys

from portbench.core import spec

FORBIDDEN = {"jax", "jaxlib", "flax", "gennerf_tpu"}


def _modules():
    out = []
    for d, _, files in os.walk(spec.PKG):
        for f in files:
            if f.endswith(".py"):
                out.append(os.path.relpath(os.path.join(d, f), spec.ROOT))
    return sorted(out)


def _loaded_after(code: str) -> set:
    probe = code + "\nimport sys\nprint(' '.join(sorted({m.split('.', 1)[0] for m in sys.modules})))\n"
    out = subprocess.run([sys.executable, "-c", probe], cwd=spec.ROOT, capture_output=True,
                         text=True, timeout=600, env=dict(os.environ, PYTHONPATH=spec.ROOT))
    assert out.returncode == 0, out.stderr[-3000:]
    return set(out.stdout.split())


def test_no_module_of_the_benchmark_imports_jax():
    loads = []
    for p in _modules():
        if "/tests/" in p:
            continue
        dotted = p[:-3].replace("/", ".").removesuffix(".__init__")
        if os.path.basename(p)[:-3].isidentifier():
            loads.append(f"importlib.import_module({dotted!r})")
        else:
            loads.append(f"spec.load_file({p!r}, {('m_' + dotted.replace('.', '_'))!r})")
    loads = "import importlib\n" + "\n".join(loads)
    top = _loaded_after("from portbench.core import spec\n" + loads)
    assert not top & FORBIDDEN


def test_a_run_loads_no_jax():
    top = _loaded_after(
        "import time, torch\ntorch.set_num_threads(2)\nfrom portbench import run\n"
        "from portbench.tests.tiny import cpu_ctx\n"
        "run.run_cell(cpu_ctx('gennerf_living.recon', seconds=0.2, trace=True))\n"
        "run.run_cell(cpu_ctx('gennerf_living.train', seconds=0.2))\n")
    assert "gennerf_tpu_torch" in top and not top & FORBIDDEN


def test_references_load_nothing_of_the_program():
    for name in sorted(os.listdir(os.path.join(spec.PKG, "reference"))):
        if name.endswith(".py") and name != "__init__.py":
            top = _loaded_after(f"import portbench.reference.{name[:-3]}")
            assert not top & (FORBIDDEN | {"gennerf_tpu_torch"}), name
