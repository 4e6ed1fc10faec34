"""A float64 referee for the port's float32 parity tests against the JAX
package.

Two float32 evaluations of a deep network (~20 convolutions, BatchNorms)
in different summation orders each lie 1e-6 to 2e-5 of max-abs from the
same network in float64, so a bound of 1e-5 between them fires by chance
(tests/test_torch_weights.py::test_reader_voxel_net_against_jax_porters
did, at 1.09e-5). Such a test holds the port's float32 output to the
port's own float64 evaluation of the same weights and inputs instead: no
farther from it than FACTOR times the JAX package's float32 output of
the same network (48 draws of that test at 1 and 8 threads read ratios
0.50-2.13; FACTOR is chip_smoke.EIKONAL_NOISE_FACTOR's 5). A test may
hold the port nearer (`factor` below FACTOR) and cap its distance from
the referee (`cap`, an absolute max-abs). The JAX output's own agreement with the
referee (the weights mapped alike) is checked apart, by each test.
"""
import math

import numpy as np

FACTOR = 5.0


def distance(a, ref) -> float:
    """max |a - ref| (float64)."""
    return float(np.abs(np.asarray(a, np.float64) - np.asarray(ref, np.float64)).max())


def assert_nearer_float64(ours, jax32, ref64, name="", factor: float = FACTOR,
                          cap: float = math.inf) -> float:
    """|ours - ref64| <= factor * |jax32 - ref64| and <= cap (max-abs);
    returns the ratio of the two distances."""
    d_ours, d_jax = distance(ours, ref64), distance(jax32, ref64)
    assert d_ours <= min(factor * d_jax, cap), (name, d_ours, d_jax, cap)
    return d_ours / max(d_jax, 1e-300)
