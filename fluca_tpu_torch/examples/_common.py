"""The probes' command line: ``--device`` (default ``cuda``; a missing
card is an error) and ``--out PATH``; one JSON line on stdout, naming
the device."""

from __future__ import annotations

import argparse
import json

from fluca_tpu_torch.bench import device_info
from fluca_tpu_torch.ns.ns import check_device


def parser(doc: str) -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=doc.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="torch device (default cuda)")
    ap.add_argument("--out", default=None, help="also write the JSON result to this path")
    return ap


def emit(result: dict, device, out=None) -> None:
    """Print ``result`` with its device as one JSON line; write it to
    ``out`` too where one is named."""
    line = {**result, "device": device_info(check_device(device))}
    text = json.dumps(line)
    print(text, flush=True)
    if out is not None:
        with open(out, "w") as f:
            f.write(text + "\n")
