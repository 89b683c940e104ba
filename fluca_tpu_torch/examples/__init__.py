"""Entry points run as ``python -m fluca_tpu_torch.examples.<name>``:
the bench's memory and phase probes (counterparts of the repo's
``examples/probe512.py``, ``probe512split.py``, ``probe_poisson512.py``
and ``profile512.py``), the kernel and step timers, and the validation
runs of the IBM wakes and the backward-facing step
(``cylinder_strouhal``, ``sphere_drag``, ``sphere_ci_checkpoint``,
``backward_step``). Each prints one JSON line and writes a file only
where ``--out PATH`` (or ``--out-dir DIR``) names one."""
