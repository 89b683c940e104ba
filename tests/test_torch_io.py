"""The port's checkpoint and CGNS I/O (fluca_tpu_torch.io) against
fluca_tpu.io, and the app's restart and output options, in float64 on
the CPU; with the small gaps that came with them (CartMesh, NS,
utils.debug, the profiler trace).

Checkpoints are compared bit for bit: each package writes, the other
reads, in both formats, and every field must come back with the same
bits; the port's restart continues a run at max abs difference 0. CGNS
files are compared node for node (attributes, dtypes, shapes, values)
with fluca_tpu's file of the same state, and read both ways exactly.
"""

import json
import os
import subprocess
import sys
import zlib
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fluca_tpu.native
from fluca_tpu.io import cgns as j_cgns
from fluca_tpu.io.checkpoint import load_checkpoint as j_load
from fluca_tpu.io.checkpoint import _save_checkpoint_sharded as j_save_sharded
from fluca_tpu.io.checkpoint import save_checkpoint as j_save
from fluca_tpu.mesh.cart import CartMesh as JMesh
from fluca_tpu.models.cavity import setup_cavity_2d as j_cavity
from fluca_tpu.models.tgv import setup_taylor_green_2d as j_tgv
from fluca_tpu.utils import debug as j_debug
from fluca_tpu_torch import app
from fluca_tpu_torch.io import cgns as t_cgns
from fluca_tpu_torch.io.checkpoint import load_checkpoint as t_load
from fluca_tpu_torch.io.checkpoint import read_array, save_checkpoint as t_save
from fluca_tpu_torch.mesh.cart import CartMesh as TMesh
from fluca_tpu_torch.models.cavity import setup_cavity_3d as t_cavity3d
from fluca_tpu_torch.models.tgv import setup_taylor_green_2d as t_tgv
from fluca_tpu_torch.utils import debug as t_debug
from fluca_tpu_torch.utils import profiling

from torch_threads import one_thread_per_worker  # noqa: F401 (autouse fixture)

F64 = torch.float64
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "tests", "data")
NAMES = ("p", "phalf", "v0", "v1", "U0", "U1")


def fields(state):
    """name -> float64-or-native numpy copy of every field of a state."""
    out = {"p": state["p"], "phalf": state["phalf"]}
    for c, a in enumerate(state["v"]):
        out[f"v{c}"] = a
    for d, a in enumerate(state["U"]):
        out[f"U{d}"] = a
    return {k: (v.numpy() if torch.is_tensor(v) else np.asarray(v)) for k, v in out.items()}


def assert_same_bits(a, b):
    fa, fb = fields(a), fields(b)
    assert fa.keys() == fb.keys()
    for k in fa:
        assert fa[k].dtype == fb[k].dtype and fa[k].shape == fb[k].shape, k
        assert fa[k].tobytes() == fb[k].tobytes(), k


def read_meta(ck):
    return json.loads((ck / "meta.json").read_text())


def tgv_pair(steps=2, N=8):
    """fluca_tpu's and the port's TGV after ``steps`` steps."""
    j = j_tgv(N=N, nsteps=4, t_final=0.2)
    t = t_tgv(N=N, nsteps=4, t_final=0.2, dtype=F64, device="cpu")
    j.advance(steps)
    t.advance(steps)
    return j, t


# ----------------------------------------------------------------------
# checkpoints
# ----------------------------------------------------------------------

@pytest.mark.parametrize("fmt", ["native", "npz"])
def test_torch_checkpoint_port_writes_reference_reads(tmp_path, fmt):
    _, t = tgv_pair()
    t_save(str(tmp_path / "ck"), t, fmt=fmt)
    meta = read_meta(tmp_path / "ck")
    assert meta["format"] == fmt and meta["step"] == 2
    j = j_tgv(N=8, nsteps=4, t_final=0.2)
    j_load(str(tmp_path / "ck"), j)
    assert (j.step_index, j.t) == (t.step_index, t.t)
    assert_same_bits(t.state, j.state)


@pytest.mark.parametrize("fmt", ["native", "npz"])
def test_torch_checkpoint_reference_writes_port_reads(tmp_path, fmt, monkeypatch):
    j, _ = tgv_pair()
    if fmt == "npz":  # the reference writes npz where its native writer fails
        monkeypatch.setattr(fluca_tpu.native, "write_array", lambda path, a: False)
    j_save(str(tmp_path / "ck"), j)
    assert read_meta(tmp_path / "ck")["format"] == fmt
    t = t_tgv(N=8, nsteps=4, t_final=0.2, dtype=F64, device="cpu")
    t_load(str(tmp_path / "ck"), t)
    assert (t.step_index, t.t) == (j.step_index, j.t)
    assert_same_bits(t.state, j.state)


@pytest.mark.parametrize("name", ["cylinder_saturated_t30", "sphere_steady_t25"])
def test_torch_committed_checkpoints_read_plainly(name):
    """The committed checkpoints read by the port equal a plain numpy read
    of each .bin payload, whose zlib CRC-32 is the header's."""
    path = os.path.join(DATA, name)
    meta = read_meta(Path(path))
    for fname, am in meta["arrays"].items():
        raw = Path(path, f"{fname}.bin").read_bytes()
        magic, nbytes, crc = np.frombuffer(raw[:24], "<u8")
        plain = np.frombuffer(raw[24:], am["dtype"]).reshape(am["shape"])
        assert magic == 0x464C5543414E4154 and nbytes == plain.nbytes
        assert zlib.crc32(raw[24:]) == crc
        got = read_array(os.path.join(path, f"{fname}.bin"), am["shape"], am["dtype"])
        assert got.tobytes() == plain.tobytes()


def test_torch_checkpoint_restart_continues_bitwise(tmp_path):
    """4 steps equal 2 steps, save, load into a fresh solver, 2 steps, at
    max abs difference 0 (tests/test_io.py's invariant, on the port)."""
    full = t_tgv(N=8, nsteps=4, t_final=0.2, dtype=F64, device="cpu")
    full.solve()
    a = t_tgv(N=8, nsteps=4, t_final=0.2, dtype=F64, device="cpu")
    a.max_steps = 2
    a.solve()
    t_save(str(tmp_path / "ck"), a)
    b = t_tgv(N=8, nsteps=4, t_final=0.2, dtype=F64, device="cpu")
    t_load(str(tmp_path / "ck"), b)
    assert b.step_index == 2
    b.solve()
    assert b.step_index == full.step_index == 4
    assert_same_bits(b.state, full.state)


def test_torch_checkpoint_refusals(tmp_path):
    _, t = tgv_pair(steps=1)
    t_save(str(tmp_path / "ck"), t)
    other = t_tgv(N=16, nsteps=1, t_final=0.1, dtype=F64, device="cpu")
    with pytest.raises(ValueError, match="grid size mismatch"):
        t_load(str(tmp_path / "ck"), other)
    with pytest.raises(ValueError, match="format"):
        t_save(str(tmp_path / "x"), t, fmt="hdf5")
    # one payload byte flipped: the CRC catches it
    path = tmp_path / "ck" / "p.bin"
    raw = bytearray(path.read_bytes())
    raw[24 + 5] ^= 0x01
    path.write_bytes(bytes(raw))
    fresh = t_tgv(N=8, nsteps=4, t_final=0.2, dtype=F64, device="cpu")
    with pytest.raises(IOError, match="CRC"):
        t_load(str(tmp_path / "ck"), fresh)
    # a wrong magic, a short payload
    raw[24 + 5] ^= 0x01
    path.write_bytes(b"\0" + bytes(raw[1:]))
    with pytest.raises(IOError, match="magic"):
        t_load(str(tmp_path / "ck"), fresh)
    path.write_bytes(bytes(raw[:-8]))
    with pytest.raises(IOError, match="bytes"):
        t_load(str(tmp_path / "ck"), fresh)
    # the per-shard format: one process refuses to write it, and loads
    # fluca_tpu's per-shard files of the same state bit for bit
    with pytest.raises(ValueError, match="rank-held grid"):
        t_save(str(tmp_path / "x"), t, fmt="sharded")
    j, _ = tgv_pair(steps=1)
    j_save_sharded(str(tmp_path / "sh"), j)
    assert read_meta(tmp_path / "sh")["format"] == "sharded"
    assert t_load(str(tmp_path / "sh"), fresh) is None
    assert (fresh.step_index, fresh.t) == (j.step_index, j.t)
    assert_same_bits(fresh.state, j.state)


def test_torch_checkpoint_casts_to_solver_dtype(tmp_path):
    """The float64 checkpoint restarts a float32 run: each field is the
    float64 one rounded to nearest, as the reference casts on load."""
    _, t = tgv_pair()
    t_save(str(tmp_path / "ck"), t)
    t32 = t_tgv(N=8, nsteps=4, t_final=0.2, dtype=torch.float32, device="cpu")
    t_load(str(tmp_path / "ck"), t32)
    j32 = j_tgv(N=8, nsteps=4, t_final=0.2, dtype=jnp.float32)
    j_load(str(tmp_path / "ck"), j32)
    f64, f32 = fields(t.state), fields(t32.state)
    for k in f64:
        assert f32[k].dtype == np.float32
        assert f32[k].tobytes() == f64[k].astype(np.float32).tobytes(), k
    assert_same_bits(t32.state, j32.state)


def test_torch_checkpoint_sharded_ns(tmp_path):
    """A sharded NS (shards on the one device) writes the same files as
    the unsharded one, and loads them."""
    _, t = tgv_pair()
    s = t_tgv(N=8, nsteps=4, t_final=0.2, dtype=F64, device="cpu")
    s.shard(shape=(2, 2))
    s.advance(2)
    assert s.device_grid.size == 4
    t_save(str(tmp_path / "a"), t)
    t_save(str(tmp_path / "b"), s)
    for name in NAMES:
        assert (tmp_path / "a" / f"{name}.bin").read_bytes() == \
            (tmp_path / "b" / f"{name}.bin").read_bytes(), name
    s2 = t_tgv(N=8, nsteps=4, t_final=0.2, dtype=F64, device="cpu")
    s2.shard(shape=(2, 2))
    t_load(str(tmp_path / "a"), s2)
    assert_same_bits(s2.state, t.state)
    s2.advance(1)
    t.advance(1)
    assert_same_bits(s2.state, t.state)


# ----------------------------------------------------------------------
# CGNS
# ----------------------------------------------------------------------

def walk(path):
    """Every group and dataset of an HDF5 file: name -> (attributes with
    their stored dtypes, or a dataset's dtype, shape and bytes)."""
    import h5py

    out = {}

    def visit(name, obj):
        attrs = {k: (obj.attrs.get_id(k).dtype.str, np.asarray(obj.attrs[k]).tobytes())
                 for k in obj.attrs}
        if isinstance(obj, h5py.Dataset):
            out[name] = ("dataset", obj.dtype.str, obj.shape, np.asarray(obj).tobytes(), attrs)
        else:
            out[name] = ("group", attrs)

    with h5py.File(path, "r") as f:
        visit("/", f)
        f.visititems(visit)
    return out


def test_torch_cgns_same_file_as_reference(tmp_path):
    """The port's file of a state is fluca_tpu's node for node: the same
    SIDS/HDF5 schema (33-byte name/label, 3-byte type attributes, typed
    `` data`` datasets in Fortran order, the root bookkeeping, the zone,
    coordinates, solutions, CellInfo and the time series), the same
    values. Both written with two solutions (steps 0 and 2)."""
    j = j_tgv(N=8, nsteps=2, t_final=0.1)
    t = t_tgv(N=8, nsteps=2, t_final=0.1, dtype=F64, device="cpu")
    with j_cgns.CGNSWriter(str(tmp_path / "j.cgns"), j.mesh) as jw, \
            t_cgns.CGNSWriter(str(tmp_path / "t.cgns"), t.mesh) as tw:
        jw.write_solution(j)
        tw.write_solution(t)
        j.solve()
        t.solve()
        jw.write_solution(j)
        tw.write_solution(t)
    jt, tt = walk(tmp_path / "j.cgns"), walk(tmp_path / "t.cgns")
    assert tt.keys() == jt.keys()
    for name in jt:
        solved = ("FlowSolution2/" in name or "CenteredSolution2/" in name) \
            and jt[name][0] == "dataset" and jt[name][1] == "<f8"
        if solved:  # the two solvers' fields after 2 steps agree to rounding
            assert tt[name][1:3] == jt[name][1:3] and tt[name][4] == jt[name][4], name
            np.testing.assert_allclose(np.frombuffer(tt[name][3]), np.frombuffer(jt[name][3]),
                                       rtol=1e-12, atol=1e-14)
        else:
            assert tt[name] == jt[name], name
    # the schema's own rules, as the SIDS-to-HDF5 mapping states them
    TYPED = {"MT": None, "I4": "<i4", "I8": "<i8", "R4": "<f4", "R8": "<f8", "C1": "|i1"}
    for name, node in tt.items():
        if node[0] == "group" and name != "/":
            attrs = node[1]
            assert attrs["name"][0] == "|S33" and attrs["label"][0] == "|S33", name
            assert attrs["type"][0] == "|S3", name
            typ = attrs["type"][1].rstrip(b"\0").decode()
            data = tt.get(f"{name}/ data")
            assert (data is None) == (typ == "MT"), name
            if data is not None:
                assert data[1] == TYPED[typ], name
    import h5py

    with h5py.File(tmp_path / "t.cgns", "r") as f:
        cx = np.asarray(f["Base/Zone/GridCoordinates/CoordinateX/ data"])
        assert cx.shape == (9, 9) and np.allclose(cx[0], t.mesh.faces[0])  # Fortran order


def test_torch_cgns_read_both_ways(tmp_path):
    j, t = tgv_pair()
    with t_cgns.CGNSWriter(str(tmp_path / "t.cgns"), t.mesh) as w:
        w.write_solution(t)
    with j_cgns.CGNSWriter(str(tmp_path / "j.cgns"), j.mesh) as w:
        w.write_solution(j)
    for ns, path in ((t, "t.cgns"), (j, "j.cgns")):
        for reader in (t_cgns.read_cgns, j_cgns.read_cgns):
            data = reader(str(tmp_path / path))
            sol = data["solutions"][2]
            f = fields(ns.state)
            assert sol["VelocityX"].tobytes() == f["v0"].tobytes()
            assert sol["VelocityY"].tobytes() == f["v1"].tobytes()
            assert sol["Pressure"].tobytes() == f["p"].tobytes()
            assert sol["PressureHalfStep"].tobytes() == f["phalf"].tobytes()
            assert data["U"][2][1].tobytes() == f["U1"].tobytes()
            np.testing.assert_array_equal(data["faces"][0], ns.mesh.faces[0])
            np.testing.assert_array_equal(data["times"], [ns.t])
    # the port restores fluca_tpu's file, fluca_tpu the port's
    t2 = t_tgv(N=8, nsteps=4, t_final=0.2, dtype=F64, device="cpu")
    t_cgns.load_solution_cgns(str(tmp_path / "j.cgns"), t2)
    j2 = j_tgv(N=8, nsteps=4, t_final=0.2)
    j_cgns.load_solution_cgns(str(tmp_path / "t.cgns"), j2)
    for ns, src in ((t2, j), (j2, t)):
        assert (ns.step_index, ns.t) == (2, src.t)
        assert_same_bits(ns.state, src.state)


def test_torch_cgns_float32_solution(tmp_path):
    """A float32 run writes float64 nodes (R8), as the reference does,
    and restores to the same float32 bits."""
    t = t_tgv(N=8, nsteps=4, t_final=0.2, dtype=torch.float32, device="cpu")
    t.advance(1)
    with t_cgns.CGNSWriter(str(tmp_path / "t.cgns"), t.mesh) as w:
        w.write_solution(t)
    assert t_cgns.read_cgns(str(tmp_path / "t.cgns"))["solutions"][1]["Pressure"].dtype \
        == np.float64
    t2 = t_tgv(N=8, nsteps=4, t_final=0.2, dtype=torch.float32, device="cpu")
    t_cgns.load_solution_cgns(str(tmp_path / "t.cgns"), t2)
    assert_same_bits(t2.state, t.state)


def test_torch_cgns_batch_rollover_and_template(tmp_path):
    t = t_tgv(N=8, nsteps=3, t_final=0.15, dtype=F64, device="cpu")
    with t_cgns.CGNSWriter(str(tmp_path / "out_%d.cgns"), t.mesh, batch_size=2) as w:
        for _ in range(3):
            w.write_solution(t)
            t.max_steps = t.step_index + 1
            t.solve()
    for k, steps in ((0, {0, 1}), (1, {2})):
        for reader in (t_cgns.read_cgns, j_cgns.read_cgns):
            assert set(reader(str(tmp_path / f"out_{k}.cgns"))["solutions"]) == steps
    with pytest.raises(ValueError, match="%d"):
        t_cgns.CGNSWriter(str(tmp_path / "x.cgns"), t.mesh, batch_size=2)


def test_torch_cgns_mesh_and_restart(tmp_path):
    """mesh_from_cgns rebuilds the (stretched) grid; load_solution_cgns
    restores a chosen step and refuses another grid."""
    m = TMesh.create((6, 5))
    m.set_coordinates(np.linspace(0, 1, 7) ** 1.5, np.linspace(-1, 2, 6))
    t = t_tgv(N=8, nsteps=4, t_final=0.2, dtype=F64, device="cpu")
    w = t_cgns.CGNSWriter(str(tmp_path / "s.cgns"), t.mesh)
    w.write_solution(t)
    first = fields(t.state)
    t.advance(2)
    w.write_solution(t)
    w.close()
    w = t_cgns.CGNSWriter(str(tmp_path / "m.cgns"), m)  # the mesh alone
    w._open()
    w.close()
    got = t_cgns.mesh_from_cgns(str(tmp_path / "m.cgns"))
    ref = j_cgns.mesh_from_cgns(str(tmp_path / "m.cgns"))
    assert got.N == ref.N == (6, 5) and got.periodic == ref.periodic
    for a, b in zip(got.faces, ref.faces):
        np.testing.assert_array_equal(a, b)
    t2 = t_tgv(N=8, nsteps=4, t_final=0.2, dtype=F64, device="cpu")
    t_cgns.load_solution_cgns(str(tmp_path / "s.cgns"), t2, step=0)
    assert t2.step_index == 0 and t2.t == 0.0
    assert fields(t2.state)["p"].tobytes() == first["p"].tobytes()
    other = t_tgv(N=16, nsteps=1, t_final=0.1, dtype=F64, device="cpu")
    with pytest.raises(ValueError, match="mismatch"):
        t_cgns.load_solution_cgns(str(tmp_path / "s.cgns"), other)


def test_torch_cgns_h5py_is_lazy():
    """Importing the I/O modules does not import h5py, and without h5py a
    CGNS call raises ImportError."""
    code = (
        "import sys\n"
        "import fluca_tpu_torch.io, fluca_tpu_torch.io.cgns, fluca_tpu_torch.io.viewer\n"
        "import fluca_tpu_torch.io.checkpoint, fluca_tpu_torch.app\n"
        "assert 'h5py' not in sys.modules, 'h5py imported'\n"
        "sys.modules['h5py'] = None\n"
        "from fluca_tpu_torch.io.cgns import CGNSWriter, read_cgns\n"
        "from fluca_tpu_torch.mesh.cart import CartMesh\n"
        "for call in (lambda: CGNSWriter('x.cgns', CartMesh.create((4, 4))),\n"
        "             lambda: read_cgns('x.cgns')):\n"
        "    try:\n"
        "        call()\n"
        "    except ImportError as e:\n"
        "        assert 'h5py' in str(e)\n"
        "    else:\n"
        "        raise SystemExit('no ImportError')\n"
        "assert 'jax' not in sys.modules and 'fluca_tpu' not in sys.modules\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stderr


# ----------------------------------------------------------------------
# the app
# ----------------------------------------------------------------------

APP = ["-device", "cpu", "-cart_grid_x", "8", "-cart_grid_y", "8"]


def run_app(argv, capsys):
    rc = app.main(APP + argv)
    out = capsys.readouterr().out
    assert rc == 0, out
    return out


def test_torch_app_checkpoint_continues(tmp_path, capsys):
    """-checkpoint after 2 steps, then -load_checkpoint and 2 more, equals
    4 steps in one run at max abs 0."""
    run_app(["-ns_max_steps", "4", "-checkpoint", str(tmp_path / "full")], capsys)
    run_app(["-ns_max_steps", "2", "-checkpoint", str(tmp_path / "half")], capsys)
    out = run_app(["-ns_max_steps", "4", "-load_checkpoint", str(tmp_path / "half"),
                   "-checkpoint", str(tmp_path / "cont")], capsys)
    assert "done: CONVERGED_ITS at step 4" in out
    for name in NAMES:
        assert (tmp_path / "full" / f"{name}.bin").read_bytes() == \
            (tmp_path / "cont" / f"{name}.bin").read_bytes(), name


def test_torch_app_cgns_restart(tmp_path, capsys):
    """-ns_view_solution writes the final state; -mesh_cart_create_from_file
    and -ns_load_solution_from_file restart from it; a cgns monitor
    viewer writes every step with the batch size given."""
    out = str(tmp_path / "sol.cgns")
    run_app(["-ns_max_steps", "2", "-ns_view_solution", out, "-checkpoint",
             str(tmp_path / "ck2")], capsys)
    run_app(["-ns_max_steps", "3", "-checkpoint", str(tmp_path / "ck3")], capsys)
    text = run_app(["-mesh_cart_create_from_file", out,
                    "-ns_load_solution_from_file", out, "-ns_max_steps", "3",
                    "-checkpoint", str(tmp_path / "re3"),
                    "-ns_monitor_solution", "-ns_monitor_solution_viewer",
                    "cgns:" + str(tmp_path / "mon_%d.cgns"),
                    "-viewer_cgns_batch_size", "1"], capsys)
    assert "done: CONVERGED_ITS at step 3" in text
    for name in NAMES:
        assert (tmp_path / "ck3" / f"{name}.bin").read_bytes() == \
            (tmp_path / "re3" / f"{name}.bin").read_bytes(), name
    assert set(t_cgns.read_cgns(str(tmp_path / "mon_0.cgns"))["solutions"]) == {2}
    assert set(j_cgns.read_cgns(str(tmp_path / "mon_1.cgns"))["solutions"]) == {3}


def test_torch_app_loads_sharded_checkpoint(tmp_path, capsys):
    """-load_checkpoint of fluca_tpu's per-shard files (the app's 1-step
    state, sharded over (2, 2) virtual devices and written shard by shard)
    and 1 more step equals 2 steps in one run at max abs 0."""
    run_app(["-ns_max_steps", "2", "-checkpoint", str(tmp_path / "full")], capsys)
    run_app(["-ns_max_steps", "1", "-checkpoint", str(tmp_path / "half")], capsys)
    j = j_cavity(N=8, dtype=jnp.float64)
    j_load(str(tmp_path / "half"), j)
    j.shard(shape=(2, 2))
    j_save_sharded(str(tmp_path / "sh"), j)
    assert read_meta(tmp_path / "sh")["format"] == "sharded"
    out = run_app(["-ns_max_steps", "2", "-load_checkpoint", str(tmp_path / "sh"),
                   "-checkpoint", str(tmp_path / "cont")], capsys)
    assert "done: CONVERGED_ITS at step 2" in out
    for name in NAMES:
        assert (tmp_path / "full" / f"{name}.bin").read_bytes() == \
            (tmp_path / "cont" / f"{name}.bin").read_bytes(), name


# ----------------------------------------------------------------------
# the small gaps
# ----------------------------------------------------------------------

def test_torch_mesh_gaps_like_reference():
    for N, per in (((5, 4), (False, True)), ((3, 4, 5), (True, False, False))):
        jm, tm = JMesh.create(N, per), TMesh.create(N, per)
        assert not tm.is_set_up and not jm.is_set_up
        bounds = [0.0, 1.0, -1.0, 2.0, 0.5, 3.0][: 2 * len(N)]
        jm.set_uniform_coordinates(*bounds)
        tm.set_uniform_coordinates(*bounds)
        assert tm.is_set_up and jm.is_set_up
        for d in range(len(N)):
            for w in (1, 2):
                np.testing.assert_array_equal(tm.centers_ext(d, w), jm.centers_ext(d, w))
        tfv = tm.zeros_face_vector("cpu", F64)
        jfv = jm.zeros_face_vector(jnp.float64)
        assert [[t.shape for t in row] for row in tfv] == \
            [[tuple(a.shape) for a in row] for row in jfv]
        ptrs = [t.data_ptr() for row in tfv for t in row]
        assert len(set(ptrs)) == len(ptrs) and all(t.dtype == F64 for row in tfv for t in row)
        for loc in ("left", "RIGHT", "down", "up", 3):
            assert tm.boundary_index(loc) == jm.boundary_index(loc)


def test_torch_ns_solution_access():
    j, t = tgv_pair(steps=1)
    assert t.solution is t.state
    for name in ("v", "U", "p", "phalf"):
        assert t.get_solution_sub(name) is t.state[name]
    np.testing.assert_allclose(t.get_solution_sub("p").numpy(),
                               np.asarray(j.get_solution_sub("p")), rtol=1e-10, atol=1e-13)


def test_torch_debug_like_reference():
    j, t = tgv_pair(steps=1)
    assert t_debug.state_finite(t.state) and j_debug.state_finite(j.state)
    np.testing.assert_allclose(t_debug.continuity_residual(t),
                               j_debug.continuity_residual(j), rtol=1e-6, atol=1e-13)
    t_debug.check_state_finite(t.state)
    t_debug.monitor_check_finite(t)
    bad = dict(t.state)
    bad["U"] = (t.state["U"][0], t.state["U"][1].clone())
    bad["U"][1][0, 0] = float("nan")
    assert not t_debug.state_finite(bad)
    with pytest.raises(FloatingPointError, match=r"U\[1\].*at here"):
        t_debug.check_state_finite(bad, where="here")
    t.state = bad
    with pytest.raises(FloatingPointError, match="step 1"):
        t_debug.monitor_check_finite(t)
    try:
        t_debug.enable_nan_checks(True)
        assert torch.is_anomaly_enabled()
    finally:
        t_debug.enable_nan_checks(False)
    assert not torch.is_anomaly_enabled()


def test_torch_trace_writes(tmp_path):
    """With tracing on, a torch.profiler trace of a step holds the
    program's spans as ranges on the profiler's clock: nested as the log
    has them, each around the torch operations it ran."""
    ns = t_cavity3d(N=(8, 8, 8), dtype=F64, device="cpu")
    ns.step()
    with profiling.tracing() as log:
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            ns.step()
    names = set(log.summary())
    ranges = {}
    for e in prof.events():
        if e.name in names:
            ranges.setdefault(e.name, []).append((e.time_range.start, e.time_range.end))
    assert set(ranges) == names
    assert {k: len(v) for k, v in ranges.items()} == {
        k: s["count"] for k, s in log.summary().items()}
    (step,) = ranges["NS_Step"]
    for lo, hi in ranges["step.outer"] + ranges["mg.vcycle"]:
        assert step[0] <= lo <= hi <= step[1]
    (outer,) = ranges["step.outer"]
    inside = [e for e in prof.events() if e.name.startswith("aten::")
              and outer[0] <= e.time_range.start and e.time_range.end <= outer[1]]
    assert inside
    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    trace = json.loads((tmp_path / "trace.json").read_text())
    spans = {e["name"] for e in trace["traceEvents"] if e.get("cat") == "user_annotation"}
    assert names <= spans
