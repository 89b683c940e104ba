"""Multi-process initialization and the rank-to-rank transport.

Counterpart of fluca_tpu.parallel.distributed (``initialize_distributed``,
``process_info``; the reference's static MPI communicator, flucainit.c:14-18).
There one JAX process per host joins a global runtime; here one process
per shard of the grid joins a ``torch.distributed`` process group, and a
``parallel.mesh.RankGrid`` over that group holds one block of the grid
on this rank's device.

The backend is named by the caller, never inferred:
- ``"nccl"``: one card per rank; edge planes and sums cross NVLink or
  PCIe as device tensors.
- ``"gloo"``: CPU tensors, or ranks that share one card. Under gloo a
  CUDA tensor crosses through pinned host buffers explicitly
  (``Transport``): the plane is copied to the host, sent, received and
  copied back. Nothing falls back from one transport to the other.

``Transport`` counts what crosses: the exchanges (batches of planes sent
and received), their bytes and host time, the sums and the gathers.
"""

from __future__ import annotations

import datetime
import os
import time
from dataclasses import dataclass

import torch
import torch.distributed as dist

_BACKENDS = ("nccl", "gloo")
# this process's device, set by initialize_distributed, and the transport
# over its default group (default_transport)
_device = None
_transport = None


def _env_int(name):
    v = os.environ.get(name)
    return None if v is None else int(v)


def initialize_distributed(backend=None, init_method=None, world_size=None, rank=None,
                           device=None, timeout_s: float | None = None) -> torch.device:
    """Join the process group once per process (a second call returns the
    device the first chose). Each argument not given falls back to the
    launcher's standard variables (``torchrun``: ``RANK``, ``WORLD_SIZE``,
    ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR`` for
    ``init_method="env://"``), as the reference's falls back to
    ``JAX_COORDINATOR_ADDRESS``. With neither an ``init_method`` nor a
    launcher, the run is a single process and nothing is joined.

    ``backend`` must be named ("nccl" or "gloo") for a multi-process run.
    ``device`` defaults to ``cuda:<local rank>`` and raises where that
    card is absent; pass ``"cpu"`` for CPU ranks, or ``"cuda:0"`` with
    gloo for ranks that share one card. "nccl" needs one card per rank:
    ranks that would share one raise ValueError before the group is
    joined. Returns this process's device."""
    global _device
    if _device is not None:
        return _device
    if init_method is None and "MASTER_ADDR" in os.environ:
        init_method = "env://"
    if init_method is None:
        # a single-process run: nothing to join
        _device = torch.device(device) if device is not None else _default_device(0)
        return _device
    rank = _env_int("RANK") if rank is None else int(rank)
    world_size = _env_int("WORLD_SIZE") if world_size is None else int(world_size)
    if rank is None or world_size is None:
        raise ValueError("initialize_distributed: give rank and world_size (or run under "
                         "a launcher that sets RANK and WORLD_SIZE)")
    if backend not in _BACKENDS:
        raise ValueError(f"initialize_distributed: name the backend, one of {_BACKENDS} "
                         f"(got {backend!r}); it is never inferred")
    local_rank = _env_int("LOCAL_RANK")
    local_rank = rank if local_rank is None else local_rank
    local_size = _env_int("LOCAL_WORLD_SIZE")
    local_size = world_size if local_size is None else local_size
    if backend == "nccl":
        # one card per rank, checked before the group is joined
        cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
        dev = torch.device(device) if device is not None else torch.device("cuda", local_rank)
        if dev.type != "cuda" or local_size > cards or (dev.index or 0) != local_rank:
            raise ValueError(
                f"initialize_distributed: nccl needs one card per rank: {local_size} ranks "
                f"on this host, {cards} cards, rank {rank} asks for {dev}; ranks that share "
                f"a card (or run on the CPU) take backend='gloo'")
    dev = torch.device(device) if device is not None else _default_device(local_rank)
    if dev.type == "cuda":
        _check_card(dev)
        torch.cuda.set_device(dev)
    kw = {} if timeout_s is None else {"timeout": datetime.timedelta(seconds=timeout_s)}
    dist.init_process_group(backend, init_method=init_method, world_size=world_size,
                            rank=rank, **kw)
    _device = dev
    return _device


def _default_device(local_rank: int) -> torch.device:
    dev = torch.device("cuda", local_rank)
    _check_card(dev)
    return dev


def _check_card(dev: torch.device) -> None:
    if not torch.cuda.is_available() or (dev.index or 0) >= torch.cuda.device_count():
        raise RuntimeError(f"initialize_distributed: {dev} is not present "
                           f"(pass device='cpu' for CPU ranks)")


def finalize_distributed() -> None:
    """Leave the process group (after a barrier, so that no rank leaves
    while another still waits on it). A process that exits without it may
    abort in the group's teardown."""
    global _device, _transport
    if dist.is_available() and dist.is_initialized():
        dist.barrier()
        dist.destroy_process_group()
    _device = _transport = None


def default_transport() -> "Transport":
    """The transport over the default process group, with its backend, on
    this process's device (made once)."""
    global _transport
    if _device is None or not dist.is_initialized():
        raise RuntimeError("no process group of this package: call "
                           "initialize_distributed first")
    if _transport is None:
        _transport = Transport(None, dist.get_backend(), _device)
    return _transport


def world_size() -> int:
    """The ranks of the default process group (1 where none was joined)."""
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def process_info() -> dict:
    """The reference's four keys: this process's index and the number of
    processes, its devices (one: each rank runs on one device) and the
    devices of all ranks."""
    n = world_size()
    return {
        "process_index": dist.get_rank() if dist.is_available() and dist.is_initialized() else 0,
        "process_count": n,
        "local_devices": 1,
        "global_devices": n,
    }


@dataclass
class TransportStats:
    """What crossed between ranks since the last ``reset``: the exchanges
    (batches of planes), the bytes this rank sent in them and their host
    time (staging copies included); the sums and the gathers with their
    host time."""

    exchanges: int = 0
    exchange_bytes: int = 0
    exchange_s: float = 0.0
    sums: int = 0
    gathers: int = 0
    collective_s: float = 0.0

    def reset(self) -> None:
        self.__init__()

    def as_dict(self) -> dict:
        return dict(self.__dict__)


class Transport:
    """Point-to-point and collective operations over a process group for
    tensors on ``device``. Under gloo with CUDA tensors (``staged``) every
    tensor crosses through a pinned host buffer, reused from call to call;
    under nccl the device tensors go as they are; under gloo with CPU
    tensors there is nothing to stage."""

    def __init__(self, group, backend: str, device):
        if backend not in _BACKENDS:
            raise ValueError(f"unknown backend {backend!r}")
        self.group = group
        self.backend = backend
        self.device = torch.device(device)
        if backend == "nccl" and self.device.type != "cuda":
            raise ValueError("nccl moves CUDA tensors; CPU ranks take gloo")
        self.staged = backend == "gloo" and self.device.type == "cuda"
        self.rank = dist.get_rank(group)
        self.size = dist.get_world_size(group)
        self.stats = TransportStats()
        self._pinned = {}

    def _host(self, role, shape, dtype):
        """A pinned host buffer for ``role`` (reused: the exchanges in
        flight at one time differ in their peers or tags)."""
        key = (role, tuple(shape), dtype)
        buf = self._pinned.get(key)
        if buf is None:
            buf = torch.empty(shape, dtype=dtype, pin_memory=True)
            self._pinned[key] = buf
        return buf

    def start_exchange(self, sends, recvs) -> "PendingExchange":
        """Post one ``batch_isend_irecv``: ``sends`` are (peer, tensor,
        tag), ``recvs`` (peer, shape, dtype, tag), in the order every rank
        posts them (the order matches sends to recvs between two peers
        under nccl, which ignores tags). Under nccl the transfer runs on
        NCCL's own stream; ``wait`` returns the received tensors on the
        device, in the order of ``recvs``."""
        t0 = time.perf_counter()
        ops, out = [], []
        for peer, t, tag in sends:
            t = t.contiguous()
            if self.staged:
                h = self._host(("send", peer, tag), t.shape, t.dtype)
                h.copy_(t)
                t = h
            ops.append(dist.P2POp(dist.isend, t, peer, self.group, tag))
            self.stats.exchange_bytes += t.numel() * t.element_size()
        for peer, shape, dtype, tag in recvs:
            if self.staged:
                buf = self._host(("recv", peer, tag), shape, dtype)
            else:
                buf = torch.empty(shape, dtype=dtype, device=self.device)
            ops.append(dist.P2POp(dist.irecv, buf, peer, self.group, tag))
            out.append(buf)
        works = dist.batch_isend_irecv(ops) if ops else []
        self.stats.exchange_s += time.perf_counter() - t0
        return PendingExchange(self, works, out)

    def all_gather(self, x) -> list:
        """Every rank's ``x`` (one shape on all ranks), in rank order, on
        the device."""
        t0 = time.perf_counter()
        shape = x.shape
        x = x.reshape(-1).contiguous()
        src = x.cpu() if self.staged else x
        parts = [torch.empty_like(src) for _ in range(self.size)]
        dist.all_gather(parts, src, group=self.group)
        parts = [p.to(self.device).reshape(shape) for p in parts]
        self.stats.gathers += 1
        self.stats.collective_s += time.perf_counter() - t0
        return parts

    def allsum(self, x):
        """The sum over ranks of ``x`` (a tensor of any shape), added in
        rank order so that every rank holds the same bits."""
        parts = self.all_gather(x)
        tot = parts[0]
        for p in parts[1:]:
            tot = tot + p
        self.stats.gathers -= 1
        self.stats.sums += 1
        return tot


class PendingExchange:
    """The receives of a posted exchange (``Transport.start_exchange``)."""

    def __init__(self, transport: Transport, works, out):
        self.transport, self.works, self.out = transport, works, out

    def wait(self) -> list:
        t0 = time.perf_counter()
        for w in self.works:
            w.wait()
        out = self.out
        if self.transport.staged:
            # a blocking copy: the pinned buffers take the next exchange's planes
            out = [h.to(self.transport.device) for h in out]
        st = self.transport.stats
        st.exchanges += 1
        st.exchange_s += time.perf_counter() - t0
        return out
