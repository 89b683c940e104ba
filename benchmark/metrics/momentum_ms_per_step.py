"""Device ms per step of the kernels under the ABF momentum solve (pass C)."""

from benchmark import spans

LAYER = "ABF momentum solve (ns/cnlinear.py)"
SOURCE = "device_trace"
UNIT = "ms"
MOVES = "steps_per_s"

read = spans.momentum_ms_per_step
