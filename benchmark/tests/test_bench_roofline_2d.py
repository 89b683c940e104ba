"""The 2-D stencils' byte counts (``roofline_2d.py``) by hand at one
shape per mode and instance, the launch counter's names read back, and
the shares over a planted trace: a number where the program counts its
launches, None where it does not (a program without the counter)."""

import pytest

from benchmark import roofline_2d, spans
from benchmark.harness import Run
from benchmark.roofline import PEAK_BYTES_PER_S
from benchmark.roofline_2d import (bound_ms_per_step, launch_key, momentum2d_bytes,
                                   poisson2d_bytes)
from benchmark.trace import Trace

SHAPE = (64, 32)  # 2,048 cells; the coefficient arrays 4 x (64 + 32) values


@pytest.mark.parametrize("mode,dtype,nbytes", [
    # fields x 2,048 cells x itemsize + 384 coefficients x max(4, itemsize)
    ("apply", "float32", 2 * 2048 * 4 + 384 * 4),
    ("residual", "float32", 3 * 2048 * 4 + 384 * 4),
    ("smooth", "float32", 4 * 2048 * 4 + 384 * 4),
    ("apply", "float64", 2 * 2048 * 8 + 384 * 8),
    ("residual", "float64", 3 * 2048 * 8 + 384 * 8),
    ("smooth", "float64", 4 * 2048 * 8 + 384 * 8),
    ("apply", "bfloat16", 2 * 2048 * 2 + 384 * 4),
    ("residual", "bfloat16", 3 * 2048 * 2 + 384 * 4),
    ("smooth", "bfloat16", 4 * 2048 * 2 + 384 * 4),
])
def test_poisson2d_bytes(mode, dtype, nbytes):
    assert poisson2d_bytes(mode, SHAPE, dtype) == nbytes


@pytest.mark.parametrize("dtype,nbytes", [
    # W's 26 planes, u, v, A u, A v
    ("float32", 30 * 2048 * 4), ("float64", 30 * 2048 * 8), ("bfloat16", 30 * 2048 * 2)])
def test_momentum2d_bytes(dtype, nbytes):
    assert momentum2d_bytes(SHAPE, dtype) == nbytes


def test_the_4096_squared_bounds_of_the_kernel_table():
    """PERF.md's bounds at 4096^2: poisson2d f32 apply 0.0401 ms,
    momentum2d f32 / bf16 0.6010 / 0.3005 ms."""
    ms = lambda b: b / PEAK_BYTES_PER_S * 1e3  # noqa: E731
    assert ms(poisson2d_bytes("apply", (4096, 4096), "float32")) == pytest.approx(0.0401, abs=5e-5)
    assert ms(momentum2d_bytes((4096, 4096), "float32")) == pytest.approx(0.6010, abs=5e-5)
    assert ms(momentum2d_bytes((4096, 4096), "bfloat16")) == pytest.approx(0.3005, abs=5e-5)


def test_launch_keys_read_back():
    assert launch_key("launches.poisson2d.smooth.4096x2048.f32") == (
        "poisson2d", "smooth", (4096, 2048), "float32")
    assert launch_key("launches.momentum2d.-.64x32.bf16") == (
        "momentum2d", None, (64, 32), "bfloat16")
    for other in ("host_reads", "host_reads.cg.rnorm", "iters.schur",
                  "launches.poisson2d.smooth.64x32.f16",
                  "launches.poisson2d_halo.apply.64x32_32x16_2x2.f32"):
        assert launch_key(other) is None


def test_bound_ms_per_step_sums_the_kernels_launches():
    counters = {"launches.poisson2d.apply.64x32.f32": 3.0,
                "launches.poisson2d.smooth.32x16.f32": 2.0,
                "launches.momentum2d.-.64x32.f32": 5.0,
                "launches.poisson3d.apply.8x8x8.f32": 7.0, "host_reads": 1.0}
    want = (3 * poisson2d_bytes("apply", (64, 32), "float32")
            + 2 * poisson2d_bytes("smooth", (32, 16), "float32")) / PEAK_BYTES_PER_S * 1e3
    assert bound_ms_per_step(counters, "poisson2d") == pytest.approx(want, rel=1e-12)
    assert bound_ms_per_step(counters, "momentum2d") == pytest.approx(
        5 * momentum2d_bytes((64, 32), "float32") / PEAK_BYTES_PER_S * 1e3, rel=1e-12)
    assert bound_ms_per_step({"host_reads": 1.0}, "poisson2d") is None


def planted_run(counters):
    """A traced run of two steps whose poisson2d kernels took 10 µs a
    step and its momentum2d kernels 20 µs, with the passes' record
    planted."""
    kernels = [("void poisson2d_kernel<float, 2>(Args)", 0.0, 4.0),
               ("void poisson2d_kernel<float, 0>(Args)", 5.0, 21.0),
               ("void momentum2d_kernel<float>(Args)", 30.0, 70.0),
               ("void at::native::vectorized_elementwise_kernel<4>", 80.0, 90.0)]
    run = Run(cell=None)
    run.trace = Trace(steps=2, span=(0.0, 100.0), device=kernels, kernels=kernels, host=[],
                      port_kernels=frozenset({"poisson2d_kernel", "momentum2d_kernel"}))
    setattr(run, spans.PASSES_ATTR, {"values": {}, "record": {"counters_per_step": counters}})
    return run


def test_the_shares_over_a_planted_trace():
    counters = {"launches.poisson2d.smooth.4096x2048.f32": 1.0,
                "launches.momentum2d.-.64x32.f32": 2.0}
    run = planted_run(counters)
    p = poisson2d_bytes("smooth", (4096, 2048), "float32") / PEAK_BYTES_PER_S
    m = 2 * momentum2d_bytes((64, 32), "float32") / PEAK_BYTES_PER_S
    assert roofline_2d.roofline_pct_poisson2d(run) == pytest.approx(100 * p / 10e-6)
    assert roofline_2d.roofline_pct_momentum2d(run) == pytest.approx(100 * m / 20e-6)


def test_no_share_without_the_counter_or_the_kernels():
    run = planted_run({"host_reads": 1.0, "iters.schur": 8.0})
    assert roofline_2d.roofline_pct_poisson2d(run) is None
    assert roofline_2d.roofline_pct_momentum2d(run) is None
    setattr(run, spans.PASSES_ATTR, None)
    assert roofline_2d.roofline_pct_poisson2d(run) is None
    run.trace = None
    assert roofline_2d.roofline_pct_momentum2d(run) is None
