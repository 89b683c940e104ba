"""95th percentile of a window step's wall time."""

from benchmark import readers

read = readers.step_ms_p95
