"""Package install for gennerf_tpu (parity surface: reference setup.py).

The reference installs its `src` package with bare setuptools metadata; here
the package is `gennerf_tpu` plus the host-side native library
(native/gennerf_native.cpp — marching tetrahedra, KD-tree, rasterizer),
compiled on install when a C++ toolchain is present. The ctypes binding
(gennerf_tpu/native/__init__.py) falls back to scipy/numpy paths when the
library is absent, so a toolchain-less install still works.

    pip install -e . --no-build-isolation --no-deps
"""
import os
import subprocess
import sys

from setuptools import find_packages, setup
from setuptools.command.build_py import build_py


class BuildWithNative(build_py):
    """Best-effort native build: compile libgennerf_native.so next to the
    sources so the ctypes loader finds it; never fail the install over it."""

    def run(self):
        here = os.path.dirname(os.path.abspath(__file__))
        build_script = os.path.join(here, "native", "build.py")
        if os.path.exists(build_script):
            try:
                subprocess.run([sys.executable, build_script], check=True)
            except Exception as e:  # toolchain-less installs use the fallbacks
                print(f"warning: native library build skipped ({e})", file=sys.stderr)
        super().run()


setup(
    name="gennerf_tpu",
    version="0.1.0",
    description="TPU-native generalizable neural feature fields (JAX/XLA/Pallas)",
    long_description=(
        "Scene-level generalizable neural feature fields for 3D "
        "reconstruction from posed RGB-D observations, rebuilt TPU-first: "
        "jit'd functional training steps, Pallas decode kernels, "
        "jax.sharding device-mesh parallelism, and a host-side C++ runtime "
        "for meshing/eval. Capability parity with the gen-nerf reference."
    ),
    author="gennerf_tpu authors",
    packages=find_packages(include=["gennerf_tpu", "gennerf_tpu.*",
                                    "gennerf_tpu_torch", "gennerf_tpu_torch.*"]),
    python_requires=">=3.10",
    cmdclass={"build_py": BuildWithNative},
)
