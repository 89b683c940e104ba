"""Checkpoint / restart (counterpart of fluca_tpu.io.checkpoint).

A checkpoint is a directory: ``meta.json`` (step, time, grid and the
shape and dtype of every field) plus the fields, either one ``<name>.bin``
per field ("native") or one ``fields.npz`` ("npz"). The fields are the
solution and the pressure-extrapolation state ``phalf``, so a restarted
run continues bit for bit (reference: nssol.c:130-204,
cnlinear.c:146-162).

A ``.bin`` file is the layout of fluca_tpu's native writer
(fluca_tpu/native/fastio.cpp): a little-endian header of three u64,
[magic "FLUCANAT" 0x464c5543414e4154][payload bytes][CRC-32 of the
payload], then the payload, the field in C order. The CRC is zlib's, so
numpy and ``zlib`` read and write it: each package reads the other's
checkpoints, in both formats.

The format written is the one the caller names; nothing falls back to
another. Every field crosses to the host once on save (``.cpu()``) and
once to the solver's device on load. A sharded NS on one card keeps global tensors on
its one device (``NS.shard``), so it saves and loads through the same
files. The per-rank writer and shard-local reader, and fluca_tpu's
per-shard "sharded" format, wait for ROADMAP queue 1, item 1b: a rank of
a rank-held grid holds only its block, and ``NS.gather_state`` assembles
the whole state on one rank meanwhile.
"""

from __future__ import annotations

import json
import os
import struct
import zlib

import numpy as np
import torch

MAGIC = 0x464C5543414E4154  # "FLUCANAT"
_HEADER = struct.Struct("<QQQ")
FORMATS = ("native", "npz")


def refuse_rank_held(ns, what: str) -> None:
    """Raise for an NS whose state is one rank's block of a rank-held grid:
    its per-rank files wait for ROADMAP queue 1, item 1b."""
    if ns.impl is not None and ns.impl.rank_held:
        raise NotImplementedError(
            f"{what}: this rank holds one block of a rank-held grid; per-rank files "
            f"need the per-rank writer and shard-local reader (ROADMAP queue 1, item "
            f"1b); NS.gather_state gives the whole state on one rank")


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


def save_checkpoint(path: str, ns, fmt: str = "native") -> None:
    """Write the state and its metadata into the directory ``path`` in
    format ``fmt`` ("native" or "npz")."""
    if fmt not in FORMATS:
        raise ValueError(f"unknown checkpoint format {fmt!r}; one of {FORMATS}")
    refuse_rank_held(ns, "save_checkpoint")
    os.makedirs(path, exist_ok=True)
    arrays = {name: t.detach().cpu().numpy()
              for name, t in _named_fields(ns.state).items()}
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


def _read_fields(path: str, meta: dict) -> dict:
    fmt = meta.get("format")
    if fmt == "native":
        return {name: read_array(os.path.join(path, f"{name}.bin"), am["shape"], am["dtype"])
                for name, am in meta["arrays"].items()}
    if fmt == "npz":
        with np.load(os.path.join(path, "fields.npz")) as z:
            return {name: z[name] for name in z.files}
    if fmt == "sharded":
        raise NotImplementedError(
            "per-shard checkpoints need the per-rank writer and shard-local reader "
            "(ROADMAP queue 1, item 1b)"
        )
    raise ValueError(f"{path}: unknown checkpoint format {fmt!r}")


def load_checkpoint(path: str, ns) -> None:
    """Restore the state, step and time into ``ns`` (set up here if it is
    not yet). Refuses a checkpoint of another grid (as the reference does,
    cartcgns.c:644-758), and casts each field to the solver's dtype: a
    checkpoint written at one precision restarts at another, and where the
    dtypes match the round trip is bit for bit."""
    refuse_rank_held(ns, "load_checkpoint")
    with open(os.path.join(path, "meta.json")) as fh:
        meta = json.load(fh)
    if list(ns.mesh.N) != meta["N"]:
        raise ValueError(f"grid size mismatch: {ns.mesh.N} vs {meta['N']}")
    if list(ns.mesh.periodic) != meta["periodic"]:
        raise ValueError(
            f"periodicity mismatch: {ns.mesh.periodic} vs {meta['periodic']}"
        )
    data = _read_fields(path, meta)
    ns.setup()
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
