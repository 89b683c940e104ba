"""The benchmark of fluca_tpu_torch on one NVIDIA GPU (see ``run.py``)."""
