"""The bench's memory and phase probes, run as
``python -m fluca_tpu_torch.examples.<name>`` (counterparts of the
repo's ``examples/probe512.py``, ``probe512split.py``,
``probe_poisson512.py`` and ``profile512.py``). Each prints one JSON
line and writes a file only where ``--out PATH`` names one."""
