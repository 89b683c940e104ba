"""The port's per-rank I/O and entry points on the CPU: the "sharded"
checkpoint written by the ranks of a rank-held grid and read shard-locally
(fluca_tpu_torch.io.checkpoint), the hyperslab CGNS writer and reader
(fluca_tpu_torch.io.cgns), the app under a process group, and the
examples bench_scaling and ici_bytes. Gloo ranks as in
tests/test_torch_distributed.py (``run_ranks``: processes of
``tests/torch_multiproc_worker.py`` joined through a ``file://`` store in
``tmp_path``, one thread each, a timeout, killed in a ``finally``).

Tolerances:
- what the ranks wrote, read back by either package, against the gathered
  state the ranks held: max abs 0 (the files hold the fields' own bits;
  CGNS stores float64);
- a shard-local load's bytes read: exactly the rank's block's bytes;
- a restart from the ranks' checkpoint against the uninterrupted rank
  run: max abs 0;
- the ranks' state, loaded by fluca_tpu, against fluca_tpu's one-process
  run of the same steps: max |a - b| <= 1e-13 max(1, max |b|), the
  reference's atol for its two-process cavity (tests/test_multiprocess.py:
  127-180, O(1) fields), scaled where the channel's u and p are O(100);
- the app's viewer maxima over the ranks against the one-process app run:
  1e-13 relative (the two runs differ in the order of the sums only).
"""

import contextlib
import io
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fluca_tpu.io.cgns import load_solution_cgns as j_load_cgns
from fluca_tpu.io.checkpoint import _save_checkpoint_sharded as j_save_sharded
from fluca_tpu.io.checkpoint import load_checkpoint as j_load
from fluca_tpu.io.checkpoint import save_checkpoint as j_save
from fluca_tpu.models.cavity import setup_cavity_2d as j_cavity
from fluca_tpu.models.channel import setup_channel_3d as j_channel
from fluca_tpu.ns.cnlinear import CNLinearConfig as JConfig
from fluca_tpu_torch import app
from fluca_tpu_torch.examples import bench_scaling
from fluca_tpu_torch.io.cgns import load_solution_cgns, read_cgns
from fluca_tpu_torch.io.checkpoint import ShardedReader, load_checkpoint
from fluca_tpu_torch.io.viewer import AsciiViewer
from fluca_tpu_torch.parallel.mesh import Block
from fluca_tpu_torch.utils import config

from test_multiprocess import _validate_sids_schema
from test_torch_distributed import FIELDS, STEPS, flat, references, run_ranks
from torch_multiproc_worker import APP_ARGV, make_model
from torch_threads import one_thread_per_worker  # noqa: F401 (autouse fixture)


def jflat(jns):
    st = jns.state
    out = {f"v{c}": np.asarray(a) for c, a in enumerate(st["v"])}
    out.update({f"U{d}": np.asarray(a) for d, a in enumerate(st["U"])})
    out.update(p=np.asarray(st["p"]), phalf=np.asarray(st["phalf"]))
    return out


def j_model(model):
    if model == "cavity":
        jns = j_cavity(N=16, Re=100.0, dt=0.01, dtype=jnp.float64)
    else:
        jns = j_channel(N=(16, 16, 16), dt=2e-3, dtype=jnp.float64)
    jns.impl.cfg = JConfig.production()
    return jns


def block_of(mesh, shape, coords):
    n = tuple(N // s for N, s in zip(mesh.N, shape))
    return Block(mesh.N, mesh.periodic, tuple(c * m for c, m in zip(coords, n)), n,
                 tuple(s > 1 for s in shape))


def assert_equal_fields(got, want, names):
    for name in names:
        assert got[name].shape == want[name].shape, name
        assert np.array_equal(got[name], want[name]), (name, np.abs(got[name] - want[name]).max())


@pytest.mark.parametrize("model,shape", [
    ("cavity", (2, 1)),
    # a periodic split axis (x) and wall faces (U1's face N) in one case
    ("channel", (2, 1, 1)),
])
def test_rank_checkpoint_and_cgns_round_trip(tmp_path, model, shape):
    """float64 production(), 3 steps on 2 ranks, then the ranks write a
    "sharded" checkpoint and a hyperslab CGNS file. fluca_tpu reads both
    (the checkpoint within 1e-13 of its one-process run, the CGNS file at
    max abs 0 against the gathered state, and the file passes its SIDS
    check); the port's one-process loads equal the gathered state at max
    abs 0; each rank's shard-local load reads exactly its block's bytes,
    and its restart continues equal to the uninterrupted run. A CGNS time
    series written by the ranks with a batch of one step rolls over to one
    file per step."""
    outs = run_ranks(tmp_path, 2, f"io:{model}:{'x'.join(map(str, shape))}")
    names = FIELDS[model]
    gathered = {name: outs[0][f"g_{name}"] for name in names}
    for r, out in enumerate(outs):
        assert int(out["nbytes_read"][0]) == int(out["block_bytes"][0]) > 0, r
        assert float(out["loaded_vs_saved"][0]) == 0.0, r
        assert float(out["restart_vs_uninterrupted"][0]) == 0.0, r
        assert float(out["cgns_vs_saved"][0]) == 0.0, r
        assert out["step_t"][0] == out["cgns_step_t"][0] == STEPS
    ck, sol = str(tmp_path / "ck"), str(tmp_path / "sol.cgns")
    meta = json.loads((tmp_path / "ck" / "meta.json").read_text())
    assert meta["format"] == "sharded" and meta["nprocs"] == 2
    # the port, one process
    ns, _, ref = references(model)
    one = make_model(model)
    assert load_checkpoint(ck, one) is None
    assert one.step_index == STEPS
    assert_equal_fields(flat(one.state), gathered, names)
    one = make_model(model)
    load_solution_cgns(sol, one)
    assert one.step_index == STEPS and one.t == pytest.approx(ns.t, abs=1e-15)
    assert_equal_fields(flat(one.state), gathered, names)
    # fluca_tpu reads the ranks' files
    jns = j_model(model)
    j_load(ck, jns)
    assert jns.step_index == STEPS
    got = jflat(jns)
    for name in names:
        d = np.abs(got[name] - ref[name]).max()
        assert d <= 1e-13 * max(1.0, np.abs(ref[name]).max()), (name, d)
    jns = j_model(model)
    j_load_cgns(sol, jns)
    assert jns.step_index == STEPS
    assert_equal_fields(jflat(jns), gathered, names)
    _validate_sids_schema(sol)
    # the ranks' batch rollover: one file per step, each with its time
    for k, step in enumerate((2 * STEPS, 2 * STEPS + 1)):
        data = read_cgns(str(tmp_path / f"mon_{k}.cgns"))
        assert set(data["solutions"]) == {step}
        assert data["times"][0] == pytest.approx(step * ns.dt, rel=1e-12)
        _validate_sids_schema(str(tmp_path / f"mon_{k}.cgns"))


def reference_sharded_checkpoint(path):
    """fluca_tpu's cavity (16^2, float64, 2 steps) on (4, 2) virtual
    devices, written by its per-shard writer; returns its state."""
    jns = j_model("cavity")
    jns.shard(shape=(4, 2))
    jns.advance(2)
    j_save_sharded(str(path), jns)
    return jflat(jns), jns


def test_port_reads_reference_sharded_checkpoint(tmp_path):
    """fluca_tpu's per-shard files (face arrays whole along their own axis,
    cut otherwise than the port's blocks) load into the port at max abs 0:
    in one process, and over 2 ranks shard-locally, each rank reading
    exactly its block's bytes; the ranks' load of fluca_tpu's native files
    of the same state (read whole, cut to the block) equals it. With the
    records of a second process that overlap the first's (a manifest
    listed twice), the reader reads each byte once."""
    want, jns = reference_sharded_checkpoint(tmp_path / "refck")
    j_save(str(tmp_path / "refnative"), jns)
    names = FIELDS["cavity"]
    one = make_model("cavity")
    load_checkpoint(str(tmp_path / "refck"), one)
    assert (one.step_index, one.t) == (jns.step_index, jns.t)
    assert_equal_fields(flat(one.state), want, names)
    outs = run_ranks(tmp_path, 2, "refio:2x1")
    for out in outs:
        assert int(out["nbytes_read"][0]) == int(out["block_bytes"][0]) > 0
        blk = block_of(one.mesh, (2, 1), tuple(int(c) for c in out["coords"]))
        cut = {name: blk.cut(want[name], int(name[1]) if name[0] == "U" else None)
               for name in names}
        assert_equal_fields(out, cut, names)
        assert out["step_t"][0] == 2
        assert float(out["native_vs_sharded"][0]) == 0.0
    # overlapping records: process 1's manifest repeats process 0's
    ck = tmp_path / "refck"
    meta = json.loads((ck / "meta.json").read_text())
    (ck / "manifest.p1.json").write_text((ck / "manifest.p0.json").read_text())
    meta["nprocs"] = 2
    reader = ShardedReader(str(ck), meta)
    for name in names:
        assert np.array_equal(reader.read_full(name), want[name]), name
    assert reader.nbytes_read == sum(want[name].nbytes for name in names)


def test_sharded_reader_refuses_gaps_and_stale_manifests(tmp_path):
    """A record removed from a manifest raises IOError; a missing manifest
    raises IOError; a stale manifest past ``nprocs`` is never read."""
    want, _ = reference_sharded_checkpoint(tmp_path / "refck")
    ck = tmp_path / "refck"
    meta = json.loads((ck / "meta.json").read_text())
    # a stale manifest of an earlier save over more processes: not read
    (ck / "manifest.p1.json").write_text(json.dumps({"p": [{"file": "nowhere.npy",
                                                           "start": [0, 0],
                                                           "stop": [16, 16]}]}))
    assert np.array_equal(ShardedReader(str(ck), meta).read_full("p"), want["p"])
    records = json.loads((ck / "manifest.p0.json").read_text())
    records["p"] = records["p"][1:]
    (ck / "manifest.p0.json").write_text(json.dumps(records))
    with pytest.raises(IOError, match="do not cover"):
        ShardedReader(str(ck), meta).read_full("p")
    ns = make_model("cavity")
    with pytest.raises(IOError, match="do not cover"):
        load_checkpoint(str(ck), ns)
    meta["nprocs"] = 3
    with pytest.raises(IOError, match="no manifest of process 2"):
        ShardedReader(str(ck), meta)


def run_app_one_process(argv):
    """The one-process app in float64: its output and its NS's state."""
    config.set_default_dtype(torch.float64)
    try:
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert app.main(argv) == 0
        ns = app.build(argv[:6] + ["-load_checkpoint", argv[-1]])
    finally:
        config.set_default_dtype(torch.float32)
    return buf.getvalue(), ns


def test_app_over_ranks(tmp_path):
    """The app under a process group of 2 ranks (float64, 3 steps,
    -parallel_grid 2x1 -parallel_backend gloo): one done: line and one
    parallel: line (rank 0's), rank 0's monitor and viewer lines as the
    one-process run's, the viewer's maxima over the ranks within 1e-13 of
    the one-process run's, and its per-rank checkpoint within 1e-13 of the
    one-process run's state; without -parallel_backend or -parallel_grid it
    raises."""
    outs = run_ranks(tmp_path, 2, "app:2x1")
    texts = [str(out["text"][0]) for out in outs]
    assert all(int(out["rc"][0]) == 0 for out in outs)
    assert sum(t.count("done:") for t in texts) == 1 and "done:" in texts[0]
    assert sum(t.count("parallel:") for t in texts) == 1
    assert "parallel: 2 ranks (gloo), grid {'gx': 2, 'gy': 1}" in texts[0]
    assert texts[1] == ""
    text, ns = run_app_one_process(APP_ARGV + ["-checkpoint", str(tmp_path / "one")])
    lines = [ln for ln in texts[0].splitlines() if not ln.startswith("parallel:")]
    assert lines == text.splitlines()
    want = AsciiViewer.maxima(ns)
    for out in outs:
        assert int(out["step"][0]) == 3
        for a, b in zip(out["maxima"], want):
            assert abs(a - b) <= 1e-13 * abs(b), (a, b)
    ranks = make_model("cavity")
    load_checkpoint(str(tmp_path / "appck"), ranks)
    for name, a in flat(ranks.state).items():
        b = flat(ns.state)[name]
        assert np.abs(a - b).max() <= 1e-13 * max(1.0, np.abs(b).max()), name


def test_bench_scaling_and_ici_bytes(tmp_path, capsys):
    """bench_scaling in one process (2 shards) and over 2 ranks, and
    ici_bytes over 2 ranks, at tiny sizes on the CPU: records with the
    reference's keys; the ranks' traffic has exchanges, sums and gathers,
    and no rank sends more than the per-kind maxima."""
    keys = {"metric", "devices", "grid", "value", "efficiency_vs_1dev", "platform",
            "virtual"}
    assert bench_scaling.main(["--shards", "2", "--base", "8", "--steps", "1",
                               "--device", "cpu"]) == 0
    recs = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert [r["devices"] for r in recs] == [1, 2] and [r["grid"] for r in recs] == [[8, 8],
                                                                                   [16, 8]]
    for r in recs:
        assert keys <= r.keys() and r["virtual"] and r["platform"] == "cpu" and r["value"] > 0
    assert recs[0]["efficiency_vs_1dev"] == 1.0
    outs = run_ranks(tmp_path, 2, "tools:2x1")
    got = json.loads(str(outs[0]["text"][0]))
    assert json.loads(str(outs[1]["text"][0])) == {"bench_scaling": None, "ici_bytes": None}
    rec = got["bench_scaling"]
    assert keys <= rec.keys() and not rec["virtual"] and rec["devices"] == 2
    assert rec["grid"] == [16, 8] and rec["value"] > 0 and rec["efficiency_vs_1dev"] > 0
    traffic = got["ici_bytes"]
    assert traffic["ranks"] == 2 and traffic["grid_shape"] == [2, 1]
    for kind in ("exchange", "sum", "gather"):
        assert traffic["by_kind"][kind]["count"] > 0 and traffic["by_kind"][kind]["bytes"] > 0
        assert all(r[kind]["bytes"] <= traffic["by_kind"][kind]["bytes"]
                   for r in traffic["by_rank"])
    assert traffic["per_rank_bytes_per_step"] == max(
        sum(r[k]["bytes"] for k in r) for r in traffic["by_rank"])
    assert traffic["reference"]["per_device_bytes_per_step"] == 4018652
