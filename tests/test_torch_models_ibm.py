"""The IBM models of the port (cylinder, sphere) and the backward-facing
step against fluca_tpu's, in float64 on the CPU: forced steps from the
same state, the drag and lift, the committed checkpoints' forces, and
the setups' state (distinct buffers, device, dtype).

Tolerance: ||port - ref|| <= 1e-10 * ||ref|| per field and on C_D, C_L,
as tests/test_torch_slice.py holds the unforced steps: the same algorithm
in float64, in another summation order (the spread's sorted sum, the
stencils' forms), which measures ~1e-12 after 3 steps. A wrong force,
boundary band or marker weight shows at 1e-6 or more. The 3-D grid is
16x12x12: jaxlib's CPU backend corrupts its heap on an (8, 8, 4) pad.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fluca_tpu.io.checkpoint import load_checkpoint as j_load
from fluca_tpu.models.bfs import reattachment_length as j_reattach
from fluca_tpu.models.bfs import setup_bfs_2d as j_bfs
from fluca_tpu.models.cylinder import drag_lift_coefficients as j_dl
from fluca_tpu.models.cylinder import setup_cylinder_2d as j_cyl
from fluca_tpu.models.sphere import setup_sphere_3d as j_sph
from fluca_tpu.ns.cnlinear import CNLinearConfig as JConfig
from fluca_tpu_torch.interop import state_from_numpy
from fluca_tpu_torch.io.checkpoint import load_checkpoint as t_load
from fluca_tpu_torch.models.bfs import reattachment_length as t_reattach
from fluca_tpu_torch.models.bfs import setup_bfs_2d as t_bfs
from fluca_tpu_torch.models.cylinder import drag_lift_coefficients as t_dl
from fluca_tpu_torch.models.cylinder import setup_cylinder_2d as t_cyl
from fluca_tpu_torch.models.sphere import drag_coefficient as t_cd
from fluca_tpu_torch.models.sphere import setup_sphere_3d as t_sph
from fluca_tpu_torch.ns.cnlinear import CNLinearConfig as TConfig

from torch_threads import one_thread_per_worker  # noqa: F401 (autouse fixture)

RTOL = 1e-10
F64 = torch.float64
DATA = os.path.join(os.path.dirname(__file__), "data")


def rel(got, ref) -> float:
    got = np.asarray(got.numpy() if torch.is_tensor(got) else got, np.float64)
    ref = np.asarray(ref, np.float64)
    return float(np.linalg.norm(got - ref) / np.linalg.norm(ref))


def assert_states(t_ns, j_ns):
    for key in ("v", "U"):
        for a, b in zip(t_ns.state[key], j_ns.state[key]):
            assert rel(a, b) <= RTOL, key
    assert rel(t_ns.state["p"], j_ns.state["p"]) <= RTOL
    assert rel(t_ns.state["phalf"], j_ns.state["phalf"]) <= RTOL


def kicked(j_ns, t_ns):
    """An asymmetric kick on v (examples/cylinder_strouhal.py's), set in
    both solvers, so the lift is not zero."""
    dim = j_ns.mesh.dim
    xs = np.meshgrid(*(j_ns.mesh.centers(d) for d in range(dim)), indexing="ij")
    kick = 0.1 * np.exp(-sum((x - 0.3 * (d + 1)) ** 2 for d, x in enumerate(xs)) / 0.01)
    v = tuple(np.asarray(a) for a in j_ns.state["v"])
    v = (v[0], v[1] + kick, *v[2:])
    j_ns.set_solution(v=tuple(jnp.asarray(a) for a in v))
    t_ns.set_solution(v=tuple(torch.tensor(a) for a in v))


CYL = dict(N=(32, 16), domain=(2.2, 1.1), center=(0.55, 0.55), diameter=0.2,
           Re=100.0, dt=5e-3)
SPH = dict(N=(16, 12, 12), domain=(2.0, 1.5, 1.5), center=(0.6, 0.75, 0.75),
           diameter=0.5, Re=100.0, dt=0.02)


def test_torch_cylinder_forced_steps():
    j_ns, j_ibm = j_cyl(**CYL, dtype=jnp.float64)
    t_ns, t_ibm = t_cyl(**CYL, dtype=F64, device="cpu")
    for ns, C in ((j_ns, JConfig), (t_ns, TConfig)):
        ns.impl.cfg = C.production(outer=3, mom=8, schur=8)
    kicked(j_ns, t_ns)
    j_ns.advance(3)
    t_ns.advance(3)
    assert t_ns.step_index == j_ns.step_index == 3
    assert_states(t_ns, j_ns)
    got, ref = t_dl(t_ns, t_ibm, diameter=0.2), j_dl(j_ns, j_ibm, diameter=0.2)
    assert abs(ref[1]) > 1e-3  # the kick gives a lift
    for a, b in zip(got, ref):
        assert abs(a - b) <= RTOL * abs(b)


def test_torch_sphere_forced_steps():
    j_ns, j_ibm = j_sph(**SPH, dtype=jnp.float64, retract=0.5)
    t_ns, t_ibm = t_sph(**SPH, dtype=F64, retract=0.5, device="cpu")
    for ns, C in ((j_ns, JConfig), (t_ns, TConfig)):
        ns.impl.cfg = C.production(outer=3, mom=8, schur=8)
    kicked(j_ns, t_ns)
    j_ns.advance(2)
    t_ns.advance(2)
    assert_states(t_ns, j_ns)
    ref = np.asarray(j_ibm.hydrodynamic_force(j_ns.state, j_ns.t, j_ns.rho))
    got = t_ibm.hydrodynamic_force(t_ns.state, t_ns.t, t_ns.rho)
    assert rel(got, ref) <= RTOL
    qA = 0.5 * np.pi * 0.5**2 / 4.0
    assert abs(t_cd(t_ns, t_ibm, diameter=0.5) - ref[0] / qA) <= RTOL * abs(ref[0] / qA)


def test_torch_bfs_steps():
    kw = dict(N=(32, 8), L=4.0, Re=100.0, dt=0.02, max_steps=10)
    j_ns = j_bfs(**kw, dtype=jnp.float64)
    t_ns = t_bfs(**kw, dtype=F64, device="cpu")
    j_ns.advance(3)
    t_ns.advance(3)
    assert_states(t_ns, j_ns)
    assert abs(t_reattach(t_ns) - j_reattach(j_ns)) <= 1e-9
    # the reattachment search on a state whose near-wall u changes sign
    u = np.asarray(j_ns.state["v"][0]).copy()
    u[:, 0] = np.where(np.arange(32) < 11, -0.1, 0.2)
    j_ns.set_solution(v=(jnp.asarray(u), j_ns.state["v"][1]))
    t_ns.set_solution(v=(torch.tensor(u), t_ns.state["v"][1]))
    assert t_reattach(t_ns) == j_reattach(j_ns) > 0.0


@pytest.mark.parametrize("case", ["cylinder", "sphere"])
def test_torch_committed_checkpoint_forces(case):
    """The committed regression checkpoints (tests/data), loaded by each
    package into its model at the regression's settings: the same state
    and the same drag and lift, before any step."""
    if case == "cylinder":
        kw = dict(N=(176, 88), domain=(2.2, 1.1), center=(0.55, 0.55), diameter=0.1,
                  Re=100.0, dt=5e-3, max_steps=10**9)
        (j_ns, j_ibm), (t_ns, t_ibm) = j_cyl(**kw), t_cyl(**kw, dtype=F64, device="cpu")
        path = os.path.join(DATA, "cylinder_saturated_t30")
    else:
        kw = dict(N=(48, 32, 32), domain=(3.0, 2.0, 2.0), center=(1.0, 1.0, 1.0),
                  diameter=0.5, Re=100.0, dt=0.02, max_steps=10**9)
        (j_ns, j_ibm), (t_ns, t_ibm) = j_sph(**kw), t_sph(**kw, dtype=F64, device="cpu")
        path = os.path.join(DATA, "sphere_steady_t25")
    j_load(path, j_ns)
    t_load(path, t_ns)
    assert (t_ns.step_index, t_ns.t) == (j_ns.step_index, j_ns.t)
    for key in ("v", "U"):
        for a, b in zip(t_ns.state[key], j_ns.state[key]):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    ref = np.asarray(j_ibm.hydrodynamic_force(j_ns.state, j_ns.t, j_ns.rho))
    got = t_ibm.hydrodynamic_force(t_ns.state, t_ns.t, t_ns.rho)
    assert rel(got, ref) <= 1e-12


@pytest.mark.parametrize("case", ["cylinder", "sphere", "bfs"])
def test_torch_ibm_setup_state(case):
    """Every state leaf is its own buffer on the named device, in the
    solver dtype; the forcing is hooked into the solver."""
    if case == "cylinder":
        ns, ibm = t_cyl(**CYL, device="cpu")
    elif case == "sphere":
        ns, ibm = t_sph(**SPH, device="cpu")
    else:
        ns, ibm = t_bfs(N=(16, 8), device="cpu"), None
    leaves = [*ns.state["v"], *ns.state["U"], ns.state["p"], ns.state["phalf"]]
    assert len({t.data_ptr() for t in leaves}) == len(leaves)
    assert all(t.dtype == torch.float32 and t.device.type == "cpu" for t in leaves)
    if ibm is not None:
        assert ns.impl.body_force == ibm.body_force
        assert ibm.markers.X.dtype == torch.float32
        assert float(ns.state["v"][0].min()) == 1.0 == float(ns.state["U"][0].max())
    with pytest.raises(TypeError):
        (t_cyl if case == "cylinder" else t_sph if case == "sphere" else t_bfs)()


def test_torch_cylinder_from_reference_state():
    """A forced step of the port continued from fluca_tpu's state after 2
    steps, carried over by interop.state_from_numpy."""
    j_ns, _ = j_cyl(**CYL, dtype=jnp.float64)
    t_ns, _ = t_cyl(**CYL, dtype=F64, device="cpu")
    for ns, C in ((j_ns, JConfig), (t_ns, TConfig)):
        ns.impl.cfg = C.production(outer=3, mom=8, schur=8)
    j_ns.advance(2)
    st = {k: (tuple(np.asarray(a) for a in v) if isinstance(v, tuple) else np.asarray(v))
          for k, v in j_ns.state.items()}
    t_ns.set_solution(**state_from_numpy(st, "cpu", F64))
    t_ns.step_index, t_ns.t = j_ns.step_index, j_ns.t
    j_ns.advance(1)
    t_ns.advance(1)
    assert_states(t_ns, j_ns)


@pytest.mark.parametrize("name", ["cylinder_strouhal", "sphere_drag", "sphere_ci_checkpoint",
                                  "backward_step"])
def test_torch_ibm_examples_on_cpu(name, tmp_path, capsys, monkeypatch):
    """Each example runs end to end on the CPU at a tiny size (the sphere
    examples' fixed grid and run length shrunk through their module
    constants) and prints one JSON line naming its device; output files go
    only under the directory given."""
    import json

    from fluca_tpu_torch.examples import (
        backward_step, cylinder_strouhal, sphere_ci_checkpoint, sphere_drag,
    )

    out = tmp_path / "out"
    argv = {
        "cylinder_strouhal": ["--from-checkpoint", os.path.join(DATA, "cylinder_saturated_t30"),
                              "--t-end", "30.02", "--out-dir", str(out)],
        "sphere_drag": ["--L", "2", "--out-dir", str(out)],
        "sphere_ci_checkpoint": ["--out-dir", str(out)],
        "backward_step": ["--nx", "32", "--ny", "8", "--length", "4", "--tmax", "0.2",
                          "--dt", "0.02"],
    }[name]
    module = {"cylinder_strouhal": cylinder_strouhal, "sphere_drag": sphere_drag,
              "sphere_ci_checkpoint": sphere_ci_checkpoint, "backward_step": backward_step}[name]
    for attr, value in {"sphere_drag": {"N": 8, "T_MAX": 0.05, "CHUNK": 3},
                        "sphere_ci_checkpoint": {"T_END": 0.02}}.get(name, {}).items():
        monkeypatch.setattr(module, attr, value)
    rc = module.main(argv + ["--device", "cpu"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["device"]["platform"] == "cpu"
    if name == "cylinder_strouhal":
        assert rc == 0 and line["steps"] == 5 and np.isfinite(line["cd_mean"])
        assert sorted(os.listdir(out)) == ["checkpoint", "series.npy"]
    elif name == "sphere_drag":
        # far from settled at this size: out of the band
        assert rc == 1 and not line["in_band"] and line["markers"] == 16
        assert np.isfinite(line["cd"]) and np.isfinite(line["checkpoint_restart_cd"])
        assert line["cgns_restart_cd"] is not None  # h5py is installed here
        assert sorted(os.listdir(out)) == ["sphere8.cgns", "sphere8_checkpoint"]
    elif name == "sphere_ci_checkpoint":
        assert rc == 0 and line["step"] == 1
        assert os.path.exists(out / "meta.json")
    else:
        assert rc == 1 and np.isfinite(line["x_r_over_S"])  # not yet reattached
