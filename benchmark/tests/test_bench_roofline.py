"""The roofline counts against the bounds of PERF.md's table of
kernels: 512x256x256 and 128^3 channels (periodic x and z), poisson3d in
its three modes and momentum3d, float32 and bf16."""

import pytest

from benchmark.roofline import bound_seconds, momentum3d_bytes, poisson3d_bytes

C512, C128 = (512, 256, 256), (128, 128, 128)
PER = (True, False, True)


@pytest.mark.parametrize("shape,dtype,mode,ms", [
    (C512, "float32", "apply", 0.0801), (C512, "float32", "residual", 0.1202),
    (C512, "float32", "smooth", 0.1603),
    (C512, "bfloat16", "apply", 0.0401), (C512, "bfloat16", "residual", 0.0601),
    (C512, "bfloat16", "smooth", 0.0801),
    (C128, "float32", "apply", 0.0050), (C128, "float32", "residual", 0.0075),
    (C128, "float32", "smooth", 0.0100),
    (C128, "bfloat16", "apply", 0.00250), (C128, "bfloat16", "residual", 0.00376),
    (C128, "bfloat16", "smooth", 0.00501),
    (C512, "float64", "apply", 0.1603), (C128, "float64", "smooth", 0.0200),
])
def test_poisson3d_bound(shape, dtype, mode, ms):
    got = bound_seconds(poisson3d_bytes(mode, shape, dtype)) * 1e3
    assert got == pytest.approx(ms, abs=0.5 * 10 ** -(len(str(ms).split(".")[1])))


@pytest.mark.parametrize("shape,dtype,ms", [
    (C512, "float32", 0.72183), (C512, "bfloat16", 0.36093),
    (C128, "float32", 0.04516), (C128, "bfloat16", 0.02259),
    (C512, "float64", 1.4437), (C128, "float64", 0.0903),
])
def test_momentum3d_bound(shape, dtype, ms):
    got = bound_seconds(momentum3d_bytes(shape, PER, dtype)) * 1e3
    assert got == pytest.approx(ms, abs=0.5 * 10 ** -(len(str(ms).split(".")[1])))
