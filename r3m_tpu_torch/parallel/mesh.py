"""Device meshes, process groups and the global batch's layout: the port of
``r3m_tpu/parallel/mesh.py``.

The JAX package runs the global batch as one program over a mesh of chips: parameters
replicated, the batch split on axis 0, GSPMD inserting the collectives. The port runs one
process a card instead (``torch.distributed``, NCCL on the card, gloo on the CPU), and the
train step spells the collectives out (`r3m_tpu_torch.parallel.collectives`):

* `make_mesh` is the serving mesh, an ordered tuple of devices that one process drives
  (`R3MEncoder(mesh=...)`: one folded replica a device, the batch split in device order);
* `init_distributed` joins the process group of a training job, the counterpart of the
  root CLI's ``_maybe_init_distributed`` (``train_representation.py:28-80``), and
  `launch_local` starts that job's ranks on this host when no launcher did;
* `local_rows` is which rows of the global batch a rank holds, so that its microbatch
  ``m``, gathered in rank order, is global microbatch ``m``.
"""

from __future__ import annotations

import dataclasses
import os
import signal
import socket
import threading
import time
from multiprocessing.connection import wait
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

_FALSE = ("false", "0", "none", "no", "off")
_TRUE = ("true", "1", "yes", "on")


@dataclasses.dataclass(frozen=True)
class DeviceMesh:
    """The devices of a serving mesh, in the order a batch is split over them."""

    devices: Tuple[torch.device, ...]

    def __len__(self) -> int:
        return len(self.devices)


def make_mesh(
    n_devices: Optional[int] = None,
    devices: Optional[Sequence] = None,
    n_slices: int = 1,
) -> DeviceMesh:
    """A data-parallel mesh of `n_devices` of `devices` (the visible CUDA devices unless
    given; the CPU only when the caller names it, as ``devices=["cpu", "cpu"]``).

    Raises when `n_devices` exceeds the devices, as the JAX mesh does: a smaller mesh
    would silently change the global batch the caller asked for. ``n_slices > 1`` is
    checked for divisibility and has no effect: the reduction's hierarchy over hosts is
    NCCL's own business.
    """
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: no CUDA device is visible; name the devices "
                               "(devices=['cpu', 'cpu']) to build a mesh on the CPU")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    if n_devices is not None:
        if n_devices > len(devices):
            raise ValueError(
                f"n_devices={n_devices} requested but only {len(devices)} visible — a "
                "silently smaller mesh would change the global-batch semantics the caller "
                "asked for")
        devices = devices[:n_devices]
    if not devices:
        raise ValueError("a mesh needs at least one device")
    if n_slices > 1:
        if len(devices) % n_slices:
            raise ValueError(f"{len(devices)} devices not divisible by n_slices={n_slices}")
        print(f"[mesh] n_slices={n_slices} accepted, with no effect: NCCL arranges the "
              "reductions over hosts itself")
    return DeviceMesh(tuple(devices))


def world(group=None) -> int:
    """The process group's size; 1 with no process group."""
    return dist.get_world_size(group) if dist.is_initialized() else 1


def rank(group=None) -> int:
    """This process's rank in the group; 0 with no process group."""
    return dist.get_rank(group) if dist.is_initialized() else 0


def is_lead() -> bool:
    """True on rank 0 (and with no process group): the process that logs and snapshots."""
    return rank() == 0


def local_rows(batch: int, grad_accum: int, world_size: int, rank_: int) -> np.ndarray:
    """The rows of a global batch of `batch` rows that rank `rank_` of `world_size` holds,
    in its local order, with `grad_accum` microbatches.

    Microbatch ``m`` of the global batch is rows ``[m*B/A, (m+1)*B/A)`` (the JAX step's
    ``[B] -> [A, B/A]`` reshape); the rank holds, for each ``m`` in turn, the rows
    ``m*B/A + [r*B/(A*W), (r+1)*B/(A*W))``. Its local microbatch ``m`` gathered in rank
    order is then global microbatch ``m``, whose negatives and BatchNorm statistics span
    all of it.
    """
    if batch % grad_accum:
        raise ValueError(f"batch size {batch} not divisible by grad_accum={grad_accum}")
    micro = batch // grad_accum
    if micro % world_size:
        raise ValueError(
            f"microbatch of {micro} rows (batch {batch} / grad_accum {grad_accum}) not "
            f"divisible by the world size {world_size}")
    per = micro // world_size
    return np.concatenate([np.arange(m * micro + rank_ * per, m * micro + (rank_ + 1) * per)
                           for m in range(grad_accum)])


def _launch_env() -> Optional[Tuple[int, int, int, Optional[int]]]:
    """(rank, world, local rank, local world) a launcher exported, or None: torchrun's
    ``RANK``/``WORLD_SIZE`` (with ``MASTER_ADDR``), else Slurm's ``SLURM_PROCID``/
    ``SLURM_NTASKS``."""
    env = os.environ
    if env.get("RANK") and env.get("WORLD_SIZE") and env.get("MASTER_ADDR"):
        local_world = env.get("LOCAL_WORLD_SIZE")
        return (int(env["RANK"]), int(env["WORLD_SIZE"]), int(env.get("LOCAL_RANK", 0)),
                int(local_world) if local_world else None)
    if env.get("SLURM_PROCID") and env.get("SLURM_NTASKS"):
        per_node = env.get("SLURM_NTASKS_PER_NODE", "").split("(")[0]
        return (int(env["SLURM_PROCID"]), int(env["SLURM_NTASKS"]),
                int(env.get("SLURM_LOCALID", 0)), int(per_node) if per_node.isdigit() else None)
    return None


def launched() -> bool:
    """True when a launcher (torchrun, Slurm, `launch_local`) started this process as a
    rank of a job."""
    return _launch_env() is not None


def _rank_device(device, local_rank: int) -> torch.device:
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("init_distributed: no CUDA device is available; pass "
                               "device='cpu' to train on the CPU")
        if device.index is None:
            device = torch.device("cuda", local_rank)
        if device.index >= torch.cuda.device_count():
            raise ValueError(f"{device} requested but only {torch.cuda.device_count()} "
                             "CUDA device(s) are visible")
    return device


def init_distributed(mode="auto", backend: Optional[str] = None, device=None) -> torch.device:
    """Join the job's process group before anything touches a device; returns this
    process's device.

    `mode`: ``auto`` joins when a launcher exported ``RANK``/``WORLD_SIZE``/``MASTER_ADDR``
    (torchrun) or ``SLURM_PROCID``/``SLURM_NTASKS``; ``true`` joins always (with no
    launcher, as rank 0 of a world of 1 on a free local port); ``false`` never. `backend`
    is NCCL for a CUDA device and gloo for the CPU unless given. `device` is
    ``cuda:LOCAL_RANK`` unless given (a ``cuda`` without index takes the local rank too).
    Under NCCL, more local ranks than cards raises. Where the group exists already it
    joins nothing and returns the device.
    """
    mode = str(mode).lower()
    if mode not in _FALSE + _TRUE + ("auto",):
        raise ValueError(f"distributed_init must be auto, true or false, got {mode!r}")
    env = _launch_env()
    if dist.is_initialized():
        return _rank_device(device, env[2] if env else 0)
    if mode in _FALSE or (mode == "auto" and env is None):
        return _rank_device(device, 0)
    rank_, world_, local_rank, local_world = env or (0, 1, 0, 1)
    device = _rank_device(device, local_rank)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    if backend == "nccl":
        if device.type != "cuda":
            raise ValueError(f"the nccl backend needs a CUDA device, got {device}")
        if local_world is not None and local_world > torch.cuda.device_count():
            raise ValueError(
                f"{local_world} local ranks but {torch.cuda.device_count()} CUDA device(s): "
                "NCCL cannot put two ranks on one card (use backend='gloo' to share one)")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if env is None:
        init_method = f"tcp://127.0.0.1:{_free_port()}"
    elif os.environ.get("MASTER_ADDR") and os.environ.get("MASTER_PORT"):
        init_method = "env://"
    else:
        raise ValueError("a Slurm launch needs MASTER_ADDR and MASTER_PORT exported")
    dist.init_process_group(backend, init_method=init_method, rank=rank_,
                            world_size=world_)
    print(f"[distributed] rank {rank_}/{world_} ({backend}, {device}; local rank "
          f"{local_rank})", flush=True)
    return device


def _free_port() -> int:
    """A TCP port on the loopback interface that nothing listens on."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _local_rank_main(fn: Callable, rank_: int, world_: int, port: int, args: tuple) -> None:
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), RANK=str(rank_),
                      WORLD_SIZE=str(world_), LOCAL_RANK=str(rank_),
                      LOCAL_WORLD_SIZE=str(world_))
    try:
        fn(*args)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def launch_local(fn: Callable, world_size: int, *args, timeout: Optional[float] = None) -> None:
    """Run ``fn(*args)`` in `world_size` spawned processes, ranks ``0..W-1`` of one job on
    this host (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``/``MASTER_PORT``
    exported as torchrun does), and wait for them; `fn` joins the group with
    `init_distributed`.

    A SIGTERM to this process is passed on to every rank. When a rank fails, or `timeout`
    seconds pass, the others are terminated and this raises.
    """
    ctx = torch.multiprocessing.get_context("spawn")
    port = _free_port()
    procs = [ctx.Process(target=_local_rank_main, args=(fn, r, world_size, port, args))
             for r in range(world_size)]
    for p in procs:
        p.start()
    previous = None
    if threading.current_thread() is threading.main_thread():
        def forward(signum, frame):
            for p in procs:
                if p.is_alive():
                    os.kill(p.pid, signal.SIGTERM)

        previous = signal.signal(signal.SIGTERM, forward)
    deadline = None if timeout is None else time.monotonic() + timeout
    timed_out = False
    try:
        while alive := [p for p in procs if p.is_alive()]:
            if any(p.exitcode not in (None, 0) for p in procs):
                break
            if deadline is not None and time.monotonic() > deadline:
                timed_out = True
                break
            wait([p.sentinel for p in alive], timeout=0.5)
    finally:
        for p in procs:  # a rank left waiting in a collective for a failed one
            if p.is_alive():
                p.terminate()
            p.join(10)
            if p.is_alive():  # its SIGTERM handler asked for a clean stop: end it
                p.kill()
                p.join()
        if previous is not None:
            signal.signal(signal.SIGTERM, previous)
    codes = [p.exitcode for p in procs]
    if timed_out or any(codes):
        raise RuntimeError(f"launch_local: rank exit codes {codes}"
                           + (f" (timed out after {timeout} s)" if timed_out else ""))
