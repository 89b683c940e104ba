"""CGNS-compatible output (HDF5 flavor) and reader (counterpart of
fluca_tpu.io.cgns).

The reference's ``flucacgns`` viewer (fluca/src/viewer/impl/flucacgns/
flucacgns.c) and the Cartesian mesh CGNS write/load
(fluca/src/mesh/impl/cart/cartcgns.c): a structured zone with vertex
coordinates, cell-centered ``FlowSolution<step>`` nodes, time-series
metadata (BaseIterativeData/TimeValues + ZoneIterativeData/
FlowSolutionPointers, flucacgns.c:29-60), and batch rollover to
``%d``-templated filenames after ``batch_size`` steps
(flucacgns.c:104-115). The files are the same node for node as
fluca_tpu's, so each package reads the other's.

Files follow the CGNS/SIDS-to-HDF5 mapping: every CGNS node is an HDF5
group with 33-byte ``name``/``label`` attributes, a ``type`` attribute
('MT','I4','R4','R8','C1') and a `` data`` dataset holding the node value
(Fortran-ordered for arrays). Face-centered fields are UserDefinedData_t
nodes (cartcgns.c:355-379).

Every solution is written hyperslab by hyperslab, as the reference's
multi-process writer (fluca_tpu/io/cgns.py:220-236, 296-403) and its
collective cgp_field_write_data (flucacgns.c:241-242): rank 0 creates
the nodes with full-shape float64 datasets and no data, then each rank
in turn, in rank order with a barrier after each, opens the file and
writes its block's box of every field (plain h5py has no MPI-IO, so the
writes are serialised); rank 0 writes the time series at ``close``. On a
rank-held NS (one block per ``torch.distributed`` rank) no rank holds a
field of the whole grid; one process writes the one block of the whole
grid, with no barriers. ``load_solution_cgns`` on a rank-held NS reads
only the block's box of each dataset.

All of it runs on the host, with numpy and h5py. h5py is imported only
when a CGNS file is opened, so importing this module does not need it;
without it every CGNS call raises ImportError.
"""

from __future__ import annotations

import numpy as np
import torch

from fluca_tpu_torch.parallel.mesh import Block


def _require_h5py():
    """The h5py module; ImportError where it is not installed."""
    try:
        import h5py
    except ImportError as e:
        raise ImportError("h5py is required for CGNS I/O") from e
    return h5py


def _host(t) -> np.ndarray:
    """A field on the host in float64 (one device-to-host copy)."""
    return t.detach().to("cpu", torch.float64).numpy()


def _set_node_attrs(g, name: str, label: str, dtype_code: str):
    # fixed-size string attributes (33/3 bytes, null-padded) as the
    # ADF-to-HDF5 mapping specifies; np.bytes_ alone strips trailing NULs
    # and would shrink the attribute type
    g.attrs.create("name", np.bytes_(name[:32]), dtype="S33")
    g.attrs.create("label", np.bytes_(label[:32]), dtype="S33")
    g.attrs.create("type", np.bytes_(dtype_code[:2]), dtype="S3")
    g.attrs.create("flags", np.array([1], dtype=np.int32))


def _node(parent, name, label, data=None, dtype_code=None):
    g = parent.create_group(name)
    if data is None:
        _set_node_attrs(g, name, label, "MT")
    else:
        data = np.asarray(data)
        if dtype_code is None:
            dtype_code = {
                np.dtype(np.int32): "I4",
                np.dtype(np.int64): "I8",
                np.dtype(np.float32): "R4",
                np.dtype(np.float64): "R8",
            }.get(data.dtype, "C1")
        _set_node_attrs(g, name, label, dtype_code)
        # CGNS/HDF5 stores Fortran order: transpose so the data reads
        # back with CGNS axis conventions
        g.create_dataset(" data", data=data.T if data.ndim > 1 else data)
    return g


def _string_node(parent, name, label, s: str):
    data = np.frombuffer(s.encode(), dtype=np.uint8).astype(np.int8)
    g = parent.create_group(name)
    _set_node_attrs(g, name, label, "C1")
    g.create_dataset(" data", data=data)
    return g


def _empty_field_node(parent, name, label, global_shape):
    """An R8 DataArray node with a full-shape dataset and no data: the
    create step of the hyperslab write, before any rank writes (the
    reference's cgp_field_write, flucacgns.c:241). The dataset is in
    Fortran (reversed) order, as ``_node`` stores ``data.T``."""
    g = parent.create_group(name)
    _set_node_attrs(g, name, label, "R8")
    g.create_dataset(" data", shape=tuple(reversed(global_shape)), dtype=np.float64)
    return g


_COMP = ("X", "Y", "Z")
_FACE_NAMES = ("IFaceCenteredSolution", "JFaceCenteredSolution",
               "KFaceCenteredSolution")


class CGNSWriter:
    """Time-series CGNS writer with batch rollover.

    ``filename`` may contain ``%d``, and must when ``batch_size`` is set:
    then a new file is started every ``batch_size`` output steps
    (PetscViewerFlucaCGNSOpen semantics, flucacgns.c:230-241)."""

    def __init__(self, filename: str, mesh, batch_size: int | None = None):
        self._h5py = _require_h5py()
        if batch_size is not None and "%d" not in filename:
            raise ValueError(
                "batch_size requires a %d-templated filename "
                "(flucacgns.c:142-152)"
            )
        self.filename = filename
        self.mesh = mesh
        self.batch_size = batch_size
        self._file = None
        self._batch_index = 0
        self._steps: list[int] = []
        self._times: list[float] = []
        self._n_in_batch = 0
        # the RankGrid of the rank-held NS this writer writes hyperslabs
        # of, None on one process (set by each write; the file is closed
        # between writes)
        self._ranks = None

    # -- file lifecycle ------------------------------------------------
    def _current_name(self) -> str:
        if "%d" in self.filename:
            return self.filename % self._batch_index
        return self.filename

    def _open(self):
        f = self._h5py.File(self._current_name(), "w")
        # root metadata (CGNS-HDF5 required nodes)
        f.attrs.create("name", np.bytes_("HDF5 MotherNode"), dtype="S33")
        f.attrs.create("label", np.bytes_("Root Node of HDF5 File"), dtype="S33")
        f.attrs.create("type", np.bytes_("MT"), dtype="S3")
        f.create_dataset(
            " format",
            data=np.frombuffer(b"IEEE_LITTLE_32", dtype=np.uint8).astype(np.int8),
        )
        f.create_dataset(
            " hdf5version",
            data=np.frombuffer(b"HDF5 Version 1.10".ljust(33, b"\x00"),
                               dtype=np.uint8).astype(np.int8),
        )
        _node(f, "CGNSLibraryVersion", "CGNSLibraryVersion_t",
              np.array([3.3], dtype=np.float32))
        mesh = self.mesh
        dim = mesh.dim
        base = _node(f, "Base", "CGNSBase_t", np.array([dim, dim], dtype=np.int32))
        nverts = [mesh.N[d] + 1 for d in range(dim)]
        ncells = [mesh.N[d] for d in range(dim)]
        zsize = np.array([nverts, ncells, [0] * dim], dtype=np.int32)
        zone = _node(base, "Zone", "Zone_t", zsize.T)
        _string_node(zone, "ZoneType", "ZoneType_t", "Structured")
        gc = _node(zone, "GridCoordinates", "GridCoordinates_t")
        names = ["CoordinateX", "CoordinateY", "CoordinateZ"]
        for d in range(dim):
            # vertex coordinates: outer product broadcast per axis
            arr = np.ones([mesh.N[a] + 1 for a in range(dim)])
            idx = [None] * dim
            idx[d] = slice(None)
            arr = arr * mesh.faces[d][tuple(idx)]
            _node(gc, names[d], "DataArray_t", arr)
        self._file = f
        self._zone = zone
        self._base = base
        self._steps = []
        self._times = []
        self._n_in_batch = 0

    def _write_cellinfo(self, grid) -> None:
        """Per-cell owner map, written once per file with the mesh
        (MeshView_Cart_CGNS "CellInfo" node with an Integer "Rank" field,
        cartcgns.c:113-114): the shard index of each cell's block in the
        device grid; 0 everywhere for an unsharded run."""
        if "CellInfo" in self._zone:
            return
        shape = self.mesh.cell_shape
        if grid is None:
            rank = np.zeros(shape, np.int32)
        else:
            ext = list(grid.shape)
            dev_lin = np.arange(int(np.prod(ext)), dtype=np.int32).reshape(ext)
            coords = []
            for a, n in enumerate(shape):
                e = ext[a] if a < grid.dim else 1
                blk = -(-n // e)
                coords.append(np.minimum(np.arange(n) // blk, e - 1))
            rank = dev_lin[np.ix_(*coords[: grid.dim])]
        sol = _node(self._zone, "CellInfo", "FlowSolution_t")
        _string_node(sol, "GridLocation", "GridLocation_t", "CellCenter")
        _node(sol, "Rank", "DataArray_t", rank.astype(np.int32))

    def _finalize_time_series(self):
        """BaseIterativeData + ZoneIterativeData (flucacgns.c:29-60)."""
        if self._file is None or not self._steps:
            return
        bid = _node(self._base, "BaseIterativeData", "BaseIterativeData_t",
                    np.array([len(self._steps)], dtype=np.int32))
        _node(bid, "TimeValues", "DataArray_t", np.array(self._times, dtype=np.float64))
        zid = _node(self._zone, "ZoneIterativeData", "ZoneIterativeData_t")
        ptrs = np.zeros((len(self._steps), 32), dtype=np.int8)
        for i, s in enumerate(self._steps):
            name = f"FlowSolution{s}".ljust(32)
            ptrs[i] = np.frombuffer(name.encode(), dtype=np.uint8).astype(np.int8)
        g = zid.create_group("FlowSolutionPointers")
        _set_node_attrs(g, "FlowSolutionPointers", "DataArray_t", "C1")
        g.create_dataset(" data", data=ptrs.T)

    def _reopen(self):
        """Open the current file for appending nodes."""
        self._file = self._h5py.File(self._current_name(), "r+")
        self._base = self._file["Base"]
        self._zone = self._base["Zone"]

    def _barrier(self) -> None:
        """Wait for every rank of a rank-held writer (nothing on one
        process)."""
        if self._ranks is not None:
            self._ranks.transport.barrier()

    def close(self):
        """Write the time series and close the file. A rank-held writer's
        ranks must all call it: rank 0 writes, then a barrier."""
        if self._steps and (self._ranks is None or self._ranks.rank == 0):
            self._reopen()
            self._finalize_time_series()
            self._file.close()
            self._file = None
        self._barrier()
        self._ranks = None
        self._steps, self._times = [], []

    # -- solution write ------------------------------------------------
    def _fields(self, ns):
        """(path under the zone, face axis or None, tensor) of every field
        of one output step (``_solution_fields``, fluca_tpu/io/cgns.py:296)."""
        step, state, dim = ns.step_index, ns.state, self.mesh.dim
        out = [(f"FlowSolution{step}/Velocity{_COMP[c]}", None, state["v"][c])
               for c in range(dim)]
        out.append((f"FlowSolution{step}/Pressure", None, state["p"]))
        out.append((f"FlowSolution{step}/PressureHalfStep", None, state["phalf"]))
        out += [(f"{_FACE_NAMES[d]}{step}/FaceNormalVelocity", d, state["U"][d])
                for d in range(dim)]
        return out

    def _create_nodes(self, ns):
        """The nodes of one output step: FlowSolution<step> with its
        GridLocation, the face UserDefinedData nodes, and every field's
        DataArray as an empty full-shape float64 dataset, for the blocks
        to fill."""
        step, whole = ns.step_index, Block.whole(self.mesh.N, self.mesh.periodic)
        sol = _node(self._zone, f"FlowSolution{step}", "FlowSolution_t")
        _string_node(sol, "GridLocation", "GridLocation_t", "CellCenter")
        for d in range(self.mesh.dim):
            _node(self._zone, f"{_FACE_NAMES[d]}{step}", "UserDefinedData_t")
        for path, face, _ in self._fields(ns):
            parent, leaf = path.rsplit("/", 1)
            _empty_field_node(self._zone[parent], leaf, "DataArray_t", whole.shape(face))

    def write_solution(self, ns) -> None:
        """One FlowSolution<step> with the cell fields, and the
        face-normal velocity as UserDefinedData (cartcgns.c:293-401),
        written hyperslab by hyperslab (``_write_solution_multiproc``,
        fluca_tpu/io/cgns.py:322-403): rank 0 creates the step's nodes
        with empty full-shape datasets (and the file, with the mesh and
        the CellInfo map, at the first write of a batch) and closes it;
        then each rank in rank order opens it and writes its block's box
        of every field as float64, a barrier after each. On a rank-held NS
        every rank must call it; one process writes the one block of the
        whole grid."""
        impl = getattr(ns, "impl", None)
        ranks = impl.grid if impl is not None and impl.rank_held else None
        if self._steps and ranks is not self._ranks:
            raise ValueError("a CGNS writer writes the blocks of one grid")
        self._ranks = ranks
        if self._steps and self.batch_size is not None and self._n_in_batch >= self.batch_size:
            self.close()
            self._ranks = ranks
            self._batch_index += 1
        new_file = not self._steps
        if new_file:
            self._n_in_batch = 0
        m = self.mesh
        if ranks is None or ranks.rank == 0:
            if new_file:
                self._open()
            else:
                self._reopen()
            self._write_cellinfo(getattr(impl, "grid", None))
            self._create_nodes(ns)
            self._file.close()
            self._file = None
        self._steps.append(ns.step_index)
        self._times.append(ns.t)
        self._n_in_batch += 1
        self._barrier()
        blk = Block.whole(m.N, m.periodic) if ranks is None else ranks.block(m.N, m.periodic)
        fields = self._fields(ns)
        for r in range(1 if ranks is None else ranks.size):
            if ranks is None or r == ranks.rank:
                with self._h5py.File(self._current_name(), "r+") as f:
                    zone = f["Base"]["Zone"]
                    for path, face, t in fields:
                        idx = blk.index(face)
                        zone[path][" data"][tuple(reversed(idx))] = _host(t).T
            self._barrier()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


# ----------------------------------------------------------------------
# reader (round trip and restart; MeshLoad_Cart_CGNS / VecLoad_Cart_CGNS,
# cartcgns.c:120-158, 644-758)
# ----------------------------------------------------------------------


def mesh_from_cgns(filename: str):
    """A CartMesh from a CGNS file's vertex coordinates
    (MeshLoad_Cart_CGNS, cartcgns.c:120-158; the app's
    -mesh_cart_create_from_file, app/main.c:35-48). A structured zone
    does not store periodicity: the mesh is non-periodic."""
    from fluca_tpu_torch.mesh.cart import CartMesh

    faces = read_cgns(filename)["faces"]
    mesh = CartMesh.create(tuple(len(f) - 1 for f in faces))
    mesh.set_coordinates(*faces)
    return mesh


def load_solution_cgns(filename: str, ns, step: int | None = None):
    """Restore the fields, step and time of ``step`` (the last one if
    None) into ``ns`` (NSLoadSolution -> VecLoad_Cart_CGNS,
    nssol.c:174-204, cartcgns.c:644-758), cast to the solver's dtype on
    its device. On a rank-held NS every rank reads only its block's box of
    each dataset (the reference's per-rank hyperslab VecLoad)."""
    h5py = _require_h5py()
    ns.setup()
    m = ns.mesh
    grid = ns.impl.grid if ns.impl.rank_held else None
    blk = Block.whole(m.N, m.periodic) if grid is None else grid.block(m.N, m.periodic)
    with h5py.File(filename, "r") as f:
        base = f["Base"]
        zone = base["Zone"]
        steps = sorted(int(k[len("FlowSolution"):]) for k in zone
                       if k.startswith("FlowSolution") and k != "FlowSolutionPointers")
        if not steps:
            raise ValueError(f"no FlowSolution nodes in {filename}")
        if step is None:
            step = steps[-1]
        sol = zone[f"FlowSolution{step}"]
        for d in range(m.dim):
            shape = sol[f"Velocity{_COMP[d]}"][" data"].shape[::-1]
            if shape != m.cell_shape:
                raise ValueError(
                    f"grid size mismatch on CGNS load: {shape} vs {m.cell_shape}")

        def dev(node, face=None):
            # the dataset is Fortran-ordered: its box is the reversed index,
            # transposed back; the kernels take C-contiguous fields
            a = node[" data"][tuple(reversed(blk.index(face)))].T
            return torch.tensor(np.ascontiguousarray(a), dtype=ns.dtype, device=ns.device)

        state = dict(
            v=tuple(dev(sol[f"Velocity{_COMP[d]}"]) for d in range(m.dim)),
            U=tuple(dev(zone[f"{_FACE_NAMES[d]}{step}"]["FaceNormalVelocity"], d)
                    for d in range(m.dim)),
            p=dev(sol["Pressure"]),
            phalf=dev(sol["PressureHalfStep"]),
        )
        times = (np.asarray(base["BaseIterativeData"]["TimeValues"][" data"])
                 if "BaseIterativeData" in base else None)
    ns.set_solution(**state)
    ns.step_index = int(step)
    if times is not None:
        ns.t = float(times[steps.index(step)])
    return ns


def read_cgns(filename: str) -> dict:
    """The mesh and every solution of one CGNS-HDF5 file: {"faces": per
    axis vertex coordinates, "solutions": {step: {name: array}}, "U":
    {step: {axis: face field}}, "times": TimeValues where present}."""
    h5py = _require_h5py()
    out: dict = {"solutions": {}, "faces": [], "U": {}}
    with h5py.File(filename, "r") as f:
        base = f["Base"]
        celldim = int(base[" data"][0])
        zone = base["Zone"]
        gc = zone["GridCoordinates"]
        names = ["CoordinateX", "CoordinateY", "CoordinateZ"]
        for d in range(celldim):
            arr = np.asarray(gc[names[d]][" data"])
            arr = arr.T if arr.ndim > 1 else arr
            idx = [0] * celldim
            idx[d] = slice(None)
            out["faces"].append(np.asarray(arr[tuple(idx)]))
        for key in zone:
            if key.startswith("FlowSolution") and key != "FlowSolutionPointers":
                step = int(key[len("FlowSolution"):])
                sol = {}
                for fname in zone[key]:
                    if fname == "GridLocation":
                        continue
                    data = np.asarray(zone[key][fname][" data"])
                    sol[fname] = data.T if data.ndim > 1 else data
                out["solutions"][step] = sol
            for d, pfx in enumerate(_FACE_NAMES):
                if key.startswith(pfx):
                    step = int(key[len(pfx):])
                    data = np.asarray(zone[key]["FaceNormalVelocity"][" data"])
                    out["U"].setdefault(step, {})[d] = data.T if data.ndim > 1 else data
        if "BaseIterativeData" in base:
            out["times"] = np.asarray(base["BaseIterativeData"]["TimeValues"][" data"])
    return out
