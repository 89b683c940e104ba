"""Option-string viewer factory (ASCII viewers).

Reference: FlucaOptionsCreateViewer (fluca/src/viewer/interface/
viewerbasic.c:4-145) parses ``type:filename:format:mode`` strings from
the options database. Same syntax here; returns a viewer object with
``write_solution(ns)``/``close``. The CGNS viewer type is not ported
yet (ROADMAP queue 1, item 2).
"""

from __future__ import annotations

import sys

# PetscViewerFormats subset the reference validates against
# (viewerbasic.c:86-92); unknown names are an error there too.
VIEWER_FORMATS = (
    "default",
    "ascii_info",
    "ascii_info_detail",
    "ascii_dense",
    "ascii_matlab",
    "ascii_csv",
)

# PetscFileModes (viewerbasic.c:73-77); default is write.
FILE_MODES = ("read", "write", "append", "update", "append_update")


class AsciiViewer:
    def __init__(self, filename: str | None = None, mode: str = "write",
                 fmt: str = "default"):
        self.filename = filename
        self.format = fmt
        self.mode = mode
        # FILE_MODE_WRITE truncates at open (viewerbasic.c:78-80);
        # later writes through the same viewer append.
        if filename and mode == "write":
            open(filename, "w").close()

    def write_solution(self, ns) -> None:
        u = ns.state["v"][0]
        p = ns.state["p"]
        line = (
            f"step={ns.step_index} t={ns.t:g} "
            f"|u|max={float(u.abs().max()):.6g} "
            f"|p|max={float(p.abs().max()):.6g}"
        )
        if self.filename:
            with open(self.filename, "a") as out:
                print(line, file=out)
        else:
            print(line, file=sys.stdout)

    def close(self) -> None:
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def parse_viewer_spec(spec: str):
    """Split ``type[:filename[:format[:mode]]]`` as the reference does
    (viewerbasic.c:24-43): empty type defaults to ascii; format/mode
    validated against the known enums."""
    parts = spec.split(":", 3)
    vtype = parts[0] or "ascii"
    filename = parts[1] if len(parts) > 1 and parts[1] else None
    fmt = parts[2] if len(parts) > 2 and parts[2] else "default"
    mode = parts[3] if len(parts) > 3 and parts[3] else "write"
    if fmt not in VIEWER_FORMATS:
        raise ValueError(f"Unknown viewer format: {fmt}")
    if mode not in FILE_MODES:
        raise ValueError(f"Unknown file mode: {mode}")
    return vtype, filename, fmt, mode


def create_viewer_from_options(opts, name: str):
    """Parse ``-<name> type[:filename[:format[:mode]]]`` into a viewer
    (viewerbasic.c:133-145). Returns None when the option is absent."""
    spec = opts.get_str(name)
    if spec is None:
        return None
    vtype, filename, fmt, mode = parse_viewer_spec(spec)
    if vtype == "ascii":
        return AsciiViewer(filename, mode=mode, fmt=fmt)
    if vtype in ("cgns", "flucacgns"):
        raise NotImplementedError(
            "CGNS viewers are not ported yet (ROADMAP queue 1, item 2)"
        )
    raise ValueError(f"unknown viewer type {vtype!r} in {spec!r}")
