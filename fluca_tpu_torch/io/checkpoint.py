"""Checkpoint / restart (counterpart of fluca_tpu.io.checkpoint).

A checkpoint is a directory: ``meta.json`` (step, time, grid and the
shape and dtype of every field) plus the fields, in one of three formats:
- "native": one ``<name>.bin`` per field;
- "npz": one ``fields.npz``;
- "sharded": one ``<name>.shard_<start>.npy`` per field and block, and a
  ``manifest.p<rank>.json`` per process giving each file's global index
  range ``{file, start, stop}`` (fluca_tpu/io/checkpoint.py:93-140).
The fields are the solution and the pressure-extrapolation state
``phalf``, so a restarted run continues bit for bit (reference:
nssol.c:130-204, cnlinear.c:146-162).

A ``.bin`` file is the layout of fluca_tpu's native writer
(fluca_tpu/native/fastio.cpp): a little-endian header of three u64,
[magic "FLUCANAT" 0x464c5543414e4154][payload bytes][CRC-32 of the
payload], then the payload, the field in C order. The CRC is zlib's, so
numpy and ``zlib`` read and write it: each package reads the other's
checkpoints, in every format.

The format is chosen as the reference chooses it (:56-63): "sharded" on
a rank-held NS (one block per ``torch.distributed`` rank), "native"
otherwise; a caller may name "native" or "npz" on one process. Nothing
falls back from one format to another: a rank-held NS refuses "native"
and "npz" (``NS.gather_state`` gives the whole state on rank 0), and one
process refuses "sharded".

In the "sharded" format each rank writes its block of every field: the
cells of v, p and phalf, the faces of U[d] lo + hilast (the last rank
along a wall axis owns face N; a periodic axis has none), from the host
copy of its block; rank 0 writes ``meta.json`` with ``"nprocs"``; a
barrier ends the save, so the checkpoint is complete when any rank
returns. ``ShardedReader`` reads a box of a field from the records that
overlap it, and only from them, through ``np.load(mmap_mode="r")``. A
rank-held NS loads its block's box of every field, so no field of the
whole grid is allocated, on the card or on the host; from "native" or
"npz" each rank reads the whole file on the host (the CRC covers the
whole payload, and npz stores whole arrays), cuts its block
(``Block.cut``) and moves only the block to its device. One
process assembles a "sharded" checkpoint whole. A sharded NS on one card
keeps global tensors on its one device (``NS.shard``), so it saves and
loads as one process does.
"""

from __future__ import annotations

import json
import os
import struct
import zlib

import numpy as np
import torch

from fluca_tpu_torch.parallel.mesh import Block

MAGIC = 0x464C5543414E4154  # "FLUCANAT"
_HEADER = struct.Struct("<QQQ")
FORMATS = ("native", "npz", "sharded")


def _rank_grid(ns):
    """The RankGrid of a rank-held NS, else None."""
    return ns.impl.grid if ns.impl is not None and ns.impl.rank_held else None


def _face_axis(name: str):
    """The face axis of a field name (``U<d>``), None for a cell field."""
    return int(name[1:]) if name.startswith("U") else None


def _named_fields(state) -> dict:
    out = {"p": state["p"], "phalf": state["phalf"]}
    for c, a in enumerate(state["v"]):
        out[f"v{c}"] = a
    for d, a in enumerate(state["U"]):
        out[f"U{d}"] = a
    return out


def _grid_meta(ns) -> dict:
    return {
        "step": ns.step_index,
        "time": ns.t,
        "dt": ns.dt,
        "rho": ns.rho,
        "mu": ns.mu,
        "dim": ns.mesh.dim,
        "N": list(ns.mesh.N),
        "periodic": list(ns.mesh.periodic),
        "faces": [f.tolist() for f in ns.mesh.faces],
    }


def write_array(path: str, arr: np.ndarray) -> None:
    """Write ``arr`` as a native ``.bin`` file (header, then payload)."""
    arr = np.ascontiguousarray(arr)
    crc = zlib.crc32(arr.data) if arr.nbytes else 0
    with open(path, "wb") as fh:
        fh.write(_HEADER.pack(MAGIC, arr.nbytes, crc))
        fh.write(arr.data)


def read_array(path: str, shape, dtype) -> np.ndarray:
    """Read a native ``.bin`` file into a new array of ``shape`` and
    ``dtype``; raises IOError on a wrong magic, size or CRC."""
    out = np.empty(tuple(shape), np.dtype(dtype))
    with open(path, "rb") as fh:
        head = fh.read(_HEADER.size)
        if len(head) != _HEADER.size:
            raise IOError(f"{path}: truncated header")
        magic, nbytes, crc = _HEADER.unpack(head)
        if magic != MAGIC:
            raise IOError(f"{path}: bad magic {magic:#x}")
        if nbytes != out.nbytes:
            raise IOError(f"{path}: payload of {nbytes} bytes, expected {out.nbytes}")
        if fh.readinto(memoryview(out).cast("B")) != nbytes or fh.read(1):
            raise IOError(f"{path}: payload is not {nbytes} bytes")
    got = zlib.crc32(out.data) if out.nbytes else 0
    if got != crc:
        raise IOError(f"{path}: CRC mismatch ({got:#010x} != {crc:#010x})")
    return out


def save_checkpoint(path: str, ns, fmt: str | None = None) -> None:
    """Write the state and its metadata into the directory ``path`` in
    format ``fmt``: "sharded" (the default on a rank-held NS, and there
    the only one: every rank must call it), "native" (the default
    otherwise) or "npz"."""
    grid = _rank_grid(ns)
    if fmt is None:
        fmt = "sharded" if grid is not None else "native"
    if fmt not in FORMATS:
        raise ValueError(f"unknown checkpoint format {fmt!r}; one of {FORMATS}")
    if grid is not None and fmt != "sharded":
        raise ValueError(
            f"save_checkpoint: this rank holds one block of a rank-held grid, which "
            f"writes the 'sharded' format; {fmt!r} holds whole fields (NS.gather_state "
            f"gives the whole state on rank 0)")
    if grid is None and fmt == "sharded":
        raise ValueError("save_checkpoint: the 'sharded' format is written by the ranks "
                         "of a rank-held grid (NS(grid=) under a process group)")
    os.makedirs(path, exist_ok=True)
    arrays = {name: t.detach().cpu().numpy()
              for name, t in _named_fields(ns.state).items()}
    if fmt == "sharded":
        _save_sharded(path, ns, grid, arrays)
        return
    if fmt == "native":
        for name, a in arrays.items():
            write_array(os.path.join(path, f"{name}.bin"), a)
    else:
        np.savez(os.path.join(path, "fields.npz"), **arrays)
    meta = {
        "format": fmt,
        "arrays": {name: {"shape": list(a.shape), "dtype": str(a.dtype)}
                   for name, a in arrays.items()},
        **_grid_meta(ns),
    }
    with open(os.path.join(path, "meta.json"), "w") as fh:
        json.dump(meta, fh)


def _save_sharded(path: str, ns, grid, arrays) -> None:
    """This rank's block of every field (``arrays``, on the host) and its
    manifest; rank 0 also writes ``meta.json``; then a barrier."""
    m = ns.mesh
    blk, whole = grid.block(m.N, m.periodic), Block.whole(m.N, m.periodic)
    records, array_meta = {}, {}
    for name, a in arrays.items():
        face = _face_axis(name)
        start = [s.start for s in blk.index(face)]
        stop = [s.stop for s in blk.index(face)]
        fname = f"{name}.shard_" + "_".join(map(str, start)) + ".npy"
        np.save(os.path.join(path, fname), a)
        records[name] = [{"file": fname, "start": start, "stop": stop}]
        array_meta[name] = {"shape": list(whole.shape(face)), "dtype": str(a.dtype)}
    with open(os.path.join(path, f"manifest.p{grid.rank}.json"), "w") as fh:
        json.dump(records, fh)
    if grid.rank == 0:
        meta = {"format": "sharded", "nprocs": grid.size, "arrays": array_meta,
                **_grid_meta(ns)}
        with open(os.path.join(path, "meta.json"), "w") as fh:
            json.dump(meta, fh)
    grid.transport.barrier()


class ShardedReader:
    """Boxes of the fields of a "sharded" checkpoint (``_ShardedReader``,
    fluca_tpu/io/checkpoint.py:143-201): ``read(name, idx)`` returns the
    global index box ``idx`` (a tuple of slices) of field ``name`` from
    the records that overlap it, each read through ``np.load(mmap_mode=
    "r")`` so that only the overlapping bytes are copied. The records are
    those of the manifests ``p0 .. p<nprocs - 1>`` that ``meta.json``
    names, never a glob, so a stale manifest of an earlier save over more
    ranks is never read. Records may overlap (fluca_tpu's writer can
    store a face array whole along its own axis on every process); a part
    of the box already read is not read again. ``nbytes_read`` counts the
    bytes copied. Raises IOError where a manifest is missing, a record's
    file does not match its range, or the records do not cover the box."""

    def __init__(self, path: str, meta: dict):
        self.path = path
        self.meta = meta
        self.records: dict = {}
        nprocs = int(meta["nprocs"])
        for p in range(nprocs):
            mpath = os.path.join(path, f"manifest.p{p}.json")
            if not os.path.exists(mpath):
                raise IOError(f"{path}: no manifest of process {p} of {nprocs}")
            with open(mpath) as fh:
                for name, recs in json.load(fh).items():
                    self.records.setdefault(name, []).extend(recs)
        self.nbytes_read = 0

    def read(self, name: str, idx) -> np.ndarray:
        am = self.meta["arrays"][name]
        dtype = np.dtype(am["dtype"])
        if len(idx) != len(am["shape"]) or not all(
                0 <= s.start <= s.stop <= n for s, n in zip(idx, am["shape"])):
            raise ValueError(f"{self.path}: box {idx} outside {name!r} of shape {am['shape']}")
        shape = tuple(s.stop - s.start for s in idx)
        out = np.empty(shape, dtype)
        filled = np.zeros(shape, bool)
        for rec in self.records.get(name, ()):
            lo = [max(s.start, a) for s, a in zip(idx, rec["start"])]
            hi = [min(s.stop, b) for s, b in zip(idx, rec["stop"])]
            if any(a >= b for a, b in zip(lo, hi)):
                continue
            dst = tuple(slice(a - s.start, b - s.start) for a, b, s in zip(lo, hi, idx))
            if filled[dst].all():
                continue
            src = np.load(os.path.join(self.path, rec["file"]), mmap_mode="r")
            if src.shape != tuple(b - a for a, b in zip(rec["start"], rec["stop"])):
                raise IOError(f"{self.path}: {rec['file']} holds {src.shape}, its record "
                              f"{rec['start']}..{rec['stop']}")
            out[dst] = src[tuple(slice(a - r, b - r) for a, b, r in zip(lo, hi, rec["start"]))]
            filled[dst] = True
            self.nbytes_read += int(np.prod([b - a for a, b in zip(lo, hi)])) * dtype.itemsize
        if not filled.all():
            raise IOError(f"{self.path}: the records of {name!r} do not cover "
                          f"{[(s.start, s.stop) for s in idx]}")
        return out

    def read_full(self, name: str) -> np.ndarray:
        return self.read(name, tuple(slice(0, n) for n in self.meta["arrays"][name]["shape"]))


def _read_fields(path: str, meta: dict) -> dict:
    """Every field of a checkpoint, whole, on the host."""
    fmt = meta.get("format")
    if fmt == "native":
        return {name: read_array(os.path.join(path, f"{name}.bin"), am["shape"], am["dtype"])
                for name, am in meta["arrays"].items()}
    if fmt == "npz":
        with np.load(os.path.join(path, "fields.npz")) as z:
            return {name: z[name] for name in z.files}
    if fmt == "sharded":
        reader = ShardedReader(path, meta)
        return {name: reader.read_full(name) for name in meta["arrays"]}
    raise ValueError(f"{path}: unknown checkpoint format {fmt!r}")


def load_checkpoint(path: str, ns):
    """Restore the state, step and time into ``ns`` (set up here if it is
    not yet). Refuses a checkpoint of another grid (as the reference does,
    cartcgns.c:644-758), and casts each field to the solver's dtype: a
    checkpoint written at one precision restarts at another, and where the
    dtypes match the round trip is bit for bit. On a rank-held NS every
    rank must call it and restores its block; from a "sharded" checkpoint
    it reads only its block's box of each field. Returns the
    ShardedReader of such a load (its ``nbytes_read``), else None."""
    with open(os.path.join(path, "meta.json")) as fh:
        meta = json.load(fh)
    if list(ns.mesh.N) != meta["N"]:
        raise ValueError(f"grid size mismatch: {ns.mesh.N} vs {meta['N']}")
    if list(ns.mesh.periodic) != meta["periodic"]:
        raise ValueError(
            f"periodicity mismatch: {ns.mesh.periodic} vs {meta['periodic']}"
        )
    ns.setup()
    grid = _rank_grid(ns)
    reader = None
    if grid is None:
        data = _read_fields(path, meta)
    else:
        blk = grid.block(ns.mesh.N, ns.mesh.periodic)
        if meta.get("format") == "sharded":
            reader = ShardedReader(path, meta)
            data = {name: reader.read(name, blk.index(_face_axis(name)))
                    for name in meta["arrays"]}
        else:
            data = _read_fields(path, meta)
            data = {name: blk.cut(a, _face_axis(name)) for name, a in data.items()}
    dim = ns.mesh.dim

    def dev(name):
        return torch.tensor(data[name], dtype=ns.dtype, device=ns.device)

    ns.set_solution(
        v=tuple(dev(f"v{c}") for c in range(dim)),
        U=tuple(dev(f"U{d}") for d in range(dim)),
        p=dev("p"),
        phalf=dev("phalf"),
    )
    ns.step_index = int(meta["step"])
    ns.t = float(meta["time"])
    return reader
