"""fluca_tpu_torch's tracing (``utils/profiling.py``): spans nest with
their parents, step index and self time; off, a span is the shared no-op
and a step leaves nothing in a ``torch.profiler`` trace; the host reads of
a step under a fixed budget and under the tolerance rule; the launch
counts by ledger key; the ``-log_view`` table of the app."""

import math
import types

import pytest
import torch

from fluca_tpu_torch import app
from fluca_tpu_torch.models.channel import setup_channel_3d
from fluca_tpu_torch.ns.cnlinear import CNLinearConfig
from fluca_tpu_torch.ops import cuda_stencil
from fluca_tpu_torch.utils import profiling

from torch_threads import one_thread_per_worker  # noqa: F401 (autouse fixture)

F64 = torch.float64
# the spans of a 3-D step under the default (tolerance) config
STEP_SPANS = ("NS_Step", "step.rhs", "step.coeffs", "step.outer", "outer.apply", "abf",
              "abf.momentum", "abf.pre", "abf.schur", "mg.vcycle", "mg.coarse", "abf.post",
              "step.project", "host_read")


def channel(cfg, N=(8, 8, 8)):
    ns = setup_channel_3d(N=N, dt=2e-3, max_steps=10**9, dtype=F64, device="cpu")
    ns.impl.cfg = cfg
    return ns


def test_spans_nest_with_parents_steps_and_self_time():
    with profiling.tracing() as log:
        with profiling.span("NS_SetUp"):
            pass
        for _ in range(2):
            with profiling.span(profiling.ROOT):
                with profiling.span("a"):
                    with profiling.span("b"):
                        sum(range(1000))
                    with profiling.span("b"):
                        pass
                with profiling.span("c"):
                    pass
        profiling.count("n", 3)
        profiling.count("n")
    assert profiling.current() is None
    names = [r[0] for r in log.records]
    assert names == ["NS_SetUp"] + ["NS_Step", "a", "b", "b", "c"] * 2
    parents = [r[1] for r in log.records]
    assert parents == [-1, -1, 1, 2, 2, 1, -1, 6, 7, 7, 6]
    assert [r[2] for r in log.records] == [-1] + [0] * 5 + [1] * 5
    assert log.steps == 2 and log.counters == {"n": 4}
    assert all(r[3] <= r[4] for r in log.records)
    # children lie inside their parent
    for r in log.records:
        if r[1] >= 0:
            p = log.records[r[1]]
            assert p[3] <= r[3] and r[4] <= p[4]
    s = log.summary()
    assert list(s) == ["NS_SetUp", "NS_Step", "a", "b", "c"]
    assert [s[n]["count"] for n in s] == [1, 2, 2, 4, 2]

    def ms(idx):
        return sum(log.records[i][4] - log.records[i][3] for i in idx) * 1e-6

    assert s["a"]["ms"] == pytest.approx(ms([2, 7]), rel=1e-12)
    assert s["a"]["self_ms"] == pytest.approx(ms([2, 7]) - ms([3, 4, 8, 9]), rel=1e-9)
    assert s["NS_Step"]["self_ms"] == pytest.approx(
        ms([1, 6]) - ms([2, 5, 7, 10]), rel=1e-9)
    assert s["b"]["self_ms"] == s["b"]["ms"]
    with pytest.raises(RuntimeError, match="off"):
        profiling.stop()
    with profiling.tracing():
        with pytest.raises(RuntimeError, match="already"):
            profiling.start()


def test_off_is_a_shared_noop_that_leaves_no_range_in_a_trace():
    assert profiling.current() is None
    a, b = profiling.span("step.outer"), profiling.span("NS_Step")
    assert a is b
    with a as got:
        assert got is None
    profiling.count("host_reads")
    x = torch.tensor(2.5)
    assert profiling.read(x, "site") == 2.5
    assert profiling.read(torch.tensor([1.0, 2.0]), "s", torch.Tensor.tolist) == [1.0, 2.0]
    assert profiling.current() is None
    ns = channel(CNLinearConfig.production(2, 2, 2))
    ns.step()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        ns.step()
    names = {e.name for e in prof.events()}
    assert any(n.startswith("aten::") for n in names)
    assert not names & set(STEP_SPANS)


def test_host_reads_under_a_fixed_budget_are_the_converged_check():
    ns = channel(CNLinearConfig.production(2, 6, 8))
    ns.step()
    with profiling.tracing() as log:
        for _ in range(3):
            ns.step()
    assert log.steps == 3
    # the counters besides the stencil launches (test_launch_counter_*)
    assert {k: v for k, v in log.counters.items() if k not in launches(log.counters)} == {
        "host_reads": 3, "host_reads.converged": 3,
        "iters.outer": 6, "iters.momentum": 6 * 6, "iters.schur": 6 * 8}
    s = log.summary()
    assert s["host_read"]["count"] == 3 and s["NS_Step"]["count"] == 3
    # every read sits directly under the step; the solves read nothing
    assert {log.records[r[1]][0] for r in log.records if r[0] == "host_read"} == {"NS_Step"}


def expected_reads(c, its, restart):
    """The host reads of steps of ``its`` outer iterations each under the
    tolerance rule, from the iteration counters ``c``: per step the
    converged check, FGMRES's tolerance, its first residual, one per cycle
    and one per iteration; per inner solve (a BiCGStab and a CG in each
    outer iteration) its tolerance, one per iteration and the check that
    stopped it short of its budget."""
    outer = sum(its)
    cycles = sum(math.ceil(k / restart) for k in its)
    return 3 * len(its) + cycles + outer + 4 * outer + c["iters.momentum"] + c["iters.schur"]


def test_host_reads_under_the_tolerance_rule_follow_the_iterations():
    cfg = CNLinearConfig(restart=4, maxiter=12)
    ns = channel(cfg)
    ns.step()
    with profiling.tracing() as log:
        its = []
        for _ in range(2):
            ns.step()
            its.append(ns.last_diag["ksp_iters"])
    c = log.counters
    assert c["iters.outer"] == sum(its) and all(1 <= k <= 4 for k in its)
    assert c["host_reads"] == expected_reads(c, its, 4)
    outer = c["iters.outer"]
    assert c["host_reads.converged"] == 2
    assert c["host_reads.fgmres.tol"] == c["host_reads.fgmres.rnorm"] == 2
    assert c["host_reads.fgmres.hcol"] == outer
    assert c["host_reads.bicgstab.tol"] == c["host_reads.cg.tol"] == outer
    assert c["host_reads.bicgstab.rnorm"] == c["iters.momentum"] + outer
    assert c["host_reads.cg.rnorm"] == c["iters.schur"] + outer
    assert c["host_reads"] == log.summary()["host_read"]["count"]
    assert set(STEP_SPANS) <= set(log.summary())


def test_launches_by_key_sum_to_launches_by_dtype():
    k = cuda_stencil.Poisson3DKernel()
    for sfx in ("f32", "f64", "bf16"):
        k._fns[sfx] = lambda *args: 0
    a, b = ((16, 8, 8), (True, False, True)), ((8, 4, 4), (True, False, True))
    for dtype, key, n in ((torch.float32, a, 3), (torch.float32, b, 2),
                          (torch.bfloat16, a, 4), (torch.float64, b, 1)):
        for _ in range(n):
            k._launch(dtype, key)
    go = types.SimpleNamespace(entry=lambda *args: 0, sfx="f64",
                               ledger_key=((4, 4, 4), "f64", ((1, 1, 1), (False,) * 3)))
    for _ in range(5):
        k._launch_entry(go)
    assert k.launches_by_key == {
        ((16, 8, 8), "f32", a[1]): 3, ((8, 4, 4), "f32", b[1]): 2,
        ((16, 8, 8), "bf16", a[1]): 4, ((8, 4, 4), "f64", b[1]): 1, go.ledger_key: 5}
    assert k.launches_by_dtype == {"f32": 5, "f64": 6, "bf16": 4} and k.launches == 15
    assert cuda_stencil.launch_counts([k]) == {"poisson3d_f32": 5, "poisson3d_f64": 6,
                                               "poisson3d_bf16": 4}
    by_key = cuda_stencil.launches_by_key([k])
    assert by_key[("poisson3d", (16, 8, 8), "bf16", a[1])] == 4
    assert sum(by_key.values()) == k.launches
    assert k.launched == set(k.launches_by_key)
    k.reset()
    assert k.launches == 0 and k.launches_by_dtype == {"f32": 0, "f64": 0, "bf16": 0}
    assert len(k.launched) == 5


def test_log_view_prints_every_span_and_counter(capsys):
    rc = app.main(["-device", "cpu", "-cart_dim", "3", "-cart_grid_x", "8", "-cart_grid_y",
                   "8", "-cart_grid_z", "8", "-ns_max_steps", "2", "-log_view"])
    out = capsys.readouterr().out
    assert rc == 0 and profiling.current() is None
    table = out[out.index("Span"):]
    rows = {line.split()[0]: line.split()[1:] for line in table.splitlines()[1:]}
    for name in ("NS_SetUp",) + STEP_SPANS:
        assert len(rows[name]) == 4, name
    assert rows["NS_Step"][0] == "2"
    for name in ("host_reads", "host_reads.converged", "host_reads.fgmres.hcol",
                 "host_reads.bicgstab.rnorm", "host_reads.cg.rnorm", "iters.outer",
                 "iters.momentum", "iters.schur"):
        assert len(rows[name]) == 1 and int(rows[name][0]) > 0, name
    assert int(rows["host_reads"][0]) == int(rows["host_read"][0])


def launches(counters):
    return {k: v for k, v in counters.items() if k.startswith(profiling.LAUNCHES + ".")}


# the wrapper methods a step calls, with the mode (None: the kernel has
# none), the ledger shape and the dtype of a call's arguments
WRAPPERS = (
    (cuda_stencil.Poisson2DKernel, "__call__", lambda a: a[0], lambda a: tuple(a[1].shape),
     lambda a: a[1].dtype),
    (cuda_stencil.Momentum2DKernel, "__call__", lambda a: None, lambda a: tuple(a[1].shape),
     lambda a: a[1].dtype),
    (cuda_stencil.Poisson3DKernel, "__call__", lambda a: a[0], lambda a: tuple(a[1].shape),
     lambda a: a[1].dtype),
    (cuda_stencil.Momentum3DKernel, "__call__", lambda a: None, lambda a: a[0].shape,
     lambda a: a[0].b[0].dtype),
    (cuda_stencil.Chain3DKernel, "__call__", lambda a: None, lambda a: a[0].shape,
     lambda a: a[0].b[0].dtype),
    (cuda_stencil._PoissonHaloKernel, "run", lambda a: a[0].mode,
     lambda a: a[0].layout.key[0], lambda a: a[1].dtype),
    (cuda_stencil.Momentum2DHaloKernel, "__call__", lambda a: None, lambda a: a[3].key[0],
     lambda a: a[1].dtype),
)


@pytest.fixture
def card_launches(monkeypatch):
    """Each wrapper call also takes its launch branch, as on the card, with
    a C entry point that does nothing (the fields stay on the CPU), then
    returns its plain version's result; returns the list of (wrapper,
    mode, shape, dtype suffix) of the calls."""
    calls, forced = [], [False]
    target = cuda_stencil._launch_target
    monkeypatch.setattr(cuda_stencil, "_launch_target",
                        lambda name, x: "cuda" if forced[0] else target(name, x))
    monkeypatch.setattr(cuda_stencil, "_stream_ptr", lambda x: 0)
    monkeypatch.setattr(cuda_stencil._Kernel, "_entry", lambda self, sfx: lambda *a: 0)
    monkeypatch.setattr(cuda_stencil.HaloLaunch, "entry", lambda *a: 0, raising=False)

    def wrap(orig, mode_of, shape_of, dtype_of):
        def call(obj, *a, **k):
            calls.append((obj.name, mode_of(a), shape_of(a),
                          cuda_stencil._DTYPE_SUFFIX[dtype_of(a)]))
            forced[0] = True
            try:
                orig(obj, *a, **k)
            finally:
                forced[0] = False
            return orig(obj, *a, **k)
        return call

    for cls, method, *of in WRAPPERS:
        monkeypatch.setattr(cls, method, wrap(getattr(cls, method), *of))
    return calls


def counted(calls):
    out = {}
    for call in calls:
        name = profiling.launch_counter(*call)
        out[name] = out.get(name, 0) + 1
    return out


def by_ledger_key(counters):
    """The launch counters summed over the modes, by (kernel, shape,
    instance): what ``launches_by_key`` holds, without its band sets."""
    out = {}
    for name, n in launches(counters).items():
        _, kernel, _, shape, sfx = name.split(".")
        out[(kernel, shape, sfx)] = out.get((kernel, shape, sfx), 0) + n
    return out


def ledger_counts():
    out = {}
    for (kernel, shape, sfx, _), n in cuda_stencil.launches_by_key().items():
        key = (kernel, profiling.launch_counter("", None, shape, sfx).split(".")[3], sfx)
        out[key] = out.get(key, 0) + n
    return out


def test_launch_counter_counts_each_2d_call_by_mode(card_launches):
    from fluca_tpu_torch.models.cylinder import setup_cylinder_2d

    ns, _ = setup_cylinder_2d(N=(64, 32), domain=(4.0, 2.0), center=(1.0, 1.0),
                              diameter=0.5, max_steps=10**9, dtype=F64, device="cpu")
    ns.impl.cfg = CNLinearConfig.production(3, 8, 8)
    ns.step()
    card_launches.clear()
    cuda_stencil.reset_launch_counts()
    with profiling.tracing() as log:
        ns.step()
        ns.step()
    got = launches(log.counters)
    assert got == counted(card_launches)
    assert by_ledger_key(got) == ledger_counts()
    assert {k.split(".")[2] for k in got if ".poisson2d." in k} == {"apply", "residual", "smooth"}
    assert got["launches.momentum2d.-.64x32.f64"] == 2 * 51
    # off: the launches happen and nothing is counted anywhere
    card_launches.clear()
    cuda_stencil.reset_launch_counts()
    ns.step()
    assert card_launches and any(cuda_stencil.launch_counts().values())
    assert profiling.current() is None
    with profiling.tracing() as log:
        pass
    assert dict(log.counters) == {}


def test_launch_counter_counts_each_3d_call_by_mode(card_launches):
    ns = channel(CNLinearConfig.production(2, 6, 8), N=(16, 16, 8))
    ns.step()
    card_launches.clear()
    cuda_stencil.reset_launch_counts()
    with profiling.tracing() as log:
        ns.step()
    got = launches(log.counters)
    assert got == counted(card_launches)
    assert by_ledger_key(got) == ledger_counts()
    for stage in ("coupled", "pre", "post"):
        assert got[f"launches.chain3d_{stage}.-.16x16x8.f64"] == 2
    assert {k.split(".")[2] for k in got if ".poisson3d." in k} >= {"apply", "smooth"}
    assert {k.split(".")[3] for k in got if ".poisson3d." in k} == {"16x16x8"}


def test_launch_counter_counts_nothing_on_the_plain_path():
    ns = channel(CNLinearConfig.production(2, 6, 8))
    ns.step()
    cuda_stencil.reset_launch_counts()
    with profiling.tracing() as log:
        ns.step()
    assert not launches(log.counters) and not any(cuda_stencil.launch_counts().values())
    assert log.counters["host_reads"] == 1


def test_launch_counter_names_and_shard_launches(card_launches):
    from fluca_tpu_torch.models.cavity import setup_cavity_2d

    assert profiling.launch_counter("poisson2d", "smooth", (4096, 2048), "f32") == (
        "launches.poisson2d.smooth.4096x2048.f32")
    assert profiling.launch_counter("momentum3d", None, (8, 4, 4), "bf16") == (
        "launches.momentum3d.-.8x4x4.bf16")
    assert profiling.launch_counter("poisson2d_halo", "apply", ((16, 8), (8, 4), (2, 2)),
                                    "f64") == "launches.poisson2d_halo.apply.16x8_8x4_2x2.f64"
    profiling.count_launches("poisson3d", "apply", (4, 4, 4), "f32")
    assert profiling.current() is None
    # a halo call launches once per shard, each counted at the ledger key
    ns = setup_cavity_2d(N=16, Re=100.0, dt=0.01, dtype=F64, device="cpu")
    ns.shard(shape=(2, 2))
    ns.step()
    card_launches.clear()
    cuda_stencil.reset_launch_counts()
    with profiling.tracing() as log:
        ns.step()
    got = launches(log.counters)
    halo = {k: v for k, v in got.items() if ".poisson2d_halo." in k}
    calls = [c for c in card_launches if c[0] == "poisson2d_halo"]
    assert calls and sum(halo.values()) == 4 * len(calls)
    assert {k.split(".")[3] for k in halo} == {"16x16_8x8_2x2"}
    assert by_ledger_key(got) == ledger_counts()
