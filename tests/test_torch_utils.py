"""fluca_tpu_torch's host utilities against fluca_tpu's: the options
database, the registry, the dtype switch, the span log's table and the
viewer spec parser."""

import pytest
import torch

from fluca_tpu.io.viewer import parse_viewer_spec as j_parse
from fluca_tpu.utils.options import Options as JOptions
from fluca_tpu_torch.io.viewer import create_viewer_from_options
from fluca_tpu_torch.io.viewer import parse_viewer_spec as t_parse
from fluca_tpu_torch.utils import config
from fluca_tpu_torch.utils.options import Options as TOptions
from fluca_tpu_torch.utils import profiling
from fluca_tpu_torch.utils.registry import Registry

from torch_threads import one_thread_per_worker  # noqa: F401 (autouse fixture)

ARGV = ["-cart_grid_x", "64", "-ns_monitor", "-ns_density", "-1.5e2",
        "-flag", "-ns_viscosity", "1", "stray", "-last"]


def test_options_parse_like_reference():
    j, t = JOptions.from_argv(ARGV), TOptions.from_argv(ARGV)
    assert dict(t.items()) == dict(j.items())
    for name in ("cart_grid_x", "ns_density", "flag", "missing"):
        assert t.has(name) == j.has(name)
    assert t.sub("ns_").get_real("density") == j.sub("ns_").get_real("density")
    assert t.sub("cart_").get_int("grid_x") == 64
    assert t.get_bool("ns_monitor") and not t.get_bool("nope")


def test_registry():
    r = Registry("thing")
    r.register("a", lambda x: x + 1)
    assert r.create("a", 1) == 2 and "a" in r and r.names() == ["a"]
    with pytest.raises(KeyError, match="registered"):
        r.get("b")


def test_default_dtype_switch():
    assert config.default_dtype() == torch.float32
    assert config.resolve_dtype(None) == torch.float32
    assert config.resolve_dtype("f64") == torch.float64
    try:
        config.set_default_dtype("float64")
        assert config.resolve_dtype(None) == torch.float64
    finally:
        config.set_default_dtype(torch.float32)
    with pytest.raises(TypeError):
        config.resolve_dtype(3)


def test_event_log():
    """The -log_view table: a row per span name (count, ms, self ms, ms
    per call) and per counter."""
    with profiling.tracing() as log:
        for _ in range(3):
            with profiling.span("NS_Step"):
                with profiling.span("step.outer"):
                    profiling.count("iters.outer", 2)
    lines = log.view().splitlines()
    assert lines[0].split() == ["Span", "Count", "Time", "(ms)", "Self", "(ms)", "Avg", "(ms)"]
    rows = {line.split()[0]: line.split()[1:] for line in lines[1:]}
    assert rows["NS_Step"][0] == "3" and rows["step.outer"][0] == "3"
    assert float(rows["NS_Step"][1]) >= float(rows["NS_Step"][2])
    assert rows["Counter"] == ["Count"] and rows["iters.outer"] == ["6"]


@pytest.mark.parametrize("spec", ["", "ascii", "ascii:out.txt",
                                  "cgns:f.cgns:ascii_info", "::default:append"])
def test_viewer_spec_like_reference(spec):
    assert t_parse(spec) == j_parse(spec)


def test_viewer_spec_errors():
    with pytest.raises(ValueError):
        t_parse("ascii:f:nosuchformat")
    opts = TOptions.from_argv(["-v", "cgns:f.cgns"])
    with pytest.raises(ValueError, match="mesh"):  # a CGNS viewer needs the mesh
        create_viewer_from_options(opts, "v")
    assert create_viewer_from_options(opts, "absent") is None
