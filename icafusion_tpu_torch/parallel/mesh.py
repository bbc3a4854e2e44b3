"""Data parallelism on torch.distributed: the counterpart of the JAX
package's parallel/mesh.py (reference train.py:567-573, :232-235).

The JAX package runs one program over a device mesh: every BatchNorm
statistic, loss normaliser and gradient is taken over the global batch.
The port splits that in two:

- training runs one process per device (a rank), joined to a process
  group: NCCL on CUDA, gloo on the CPU. Each rank feeds its share of every
  global batch (``process_batch_slice``, ``process_rows``); BatchNorm
  (nn/layers.py), the loss's normalisers (train/loss.py) and the gradients
  (train/trainer.py) are summed across the group, so every rank computes
  the global numbers;
- evaluation and serving run in one process over a ``Mesh`` of devices,
  one model replica on each (``replicate``), every batch split into
  contiguous row shards (``shard_batch``).

``init_distributed`` joins a group by the ``env://`` contract torchrun sets
(RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT) or by any other
init method; ``spawn`` starts local ranks itself. The rendezvous is bounded
by RENDEZVOUS_TIMEOUT; a collective by COLLECTIVE_TIMEOUT, torch's default,
because ranks wait in one while rank 0 alone evaluates. ``rank``,
``world``, ``is_main``, ``broadcast_object`` and ``barrier`` give the
one-process answer when no group is initialised.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import multiprocessing
import os
import queue
import tempfile
import time
import traceback
from datetime import timedelta
from pathlib import Path
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from icafusion_tpu_torch.utils.general import resolve_device

RENDEZVOUS_TIMEOUT = timedelta(seconds=60)
COLLECTIVE_TIMEOUT = timedelta(minutes=30)
GRACE_S = 3.0             # spawn: how long failures are gathered for


# ---- replicas in one process ------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The devices of single-process replicas, in row order."""
    devices: Tuple[torch.device, ...]

    @property
    def size(self) -> int:
        return len(self.devices)


def cuda_devices() -> List[torch.device]:
    """The CUDA devices a mesh may take, in order: the one place the port
    reads the device list."""
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def device_count(device) -> int:
    """How many devices of ``device``'s type a mesh may take by default:
    every CUDA device, 1 for a card named by its index (``cuda:1``), or 1
    for the CPU."""
    device = torch.device(device)
    if device.type != "cuda" or device.index is not None:
        return 1
    return len(cuda_devices())


def make_mesh(n_devices: Optional[int] = None, device=None) -> Mesh:
    """A mesh of the first ``n_devices`` CUDA devices (None:
    ``device_count``), raising when fewer exist; on the CPU
    (``device='cpu'``), ``n_devices`` logical replicas of the CPU device
    (None: one).

    A card named by its index is the mesh's first device: alone for one
    device (or None), and it must be the first CUDA device for more, since
    the mesh takes the first n; any other card raises, so no work lands on
    a card the caller did not name."""
    dev = resolve_device(device, "make_mesh")
    n = device_count(dev) if n_devices is None else int(n_devices)
    if n < 1:
        raise ValueError(f"make_mesh: n_devices {n_devices} < 1")
    if dev.type != "cuda":
        return Mesh((dev,) * n)
    devs = cuda_devices()
    if n > len(devs):
        raise ValueError(f"make_mesh: {n_devices} CUDA devices asked for, "
                         f"{len(devs)} present")
    if dev.index is not None:
        if n == 1:
            return Mesh((dev,))
        if dev != devs[0]:
            raise ValueError(f"make_mesh: a mesh of {n} takes the first "
                             f"{n} CUDA devices, from {devs[0]}, not {dev}; "
                             "ask for 'cuda' or for one device")
    return Mesh(tuple(devs[:n]))


def shard_batch(x, mesh: Mesh) -> List[torch.Tensor]:
    """Split a batch-major array or tensor into contiguous row shards, one
    for each mesh device and copied there without a wait for the host. The
    rows must divide over the mesh, as a sharded batch axis must in JAX."""
    t = x if isinstance(x, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(x))
    if len(t) % mesh.size:
        raise ValueError(f"{len(t)} rows do not divide over {mesh.size} "
                         "replicas")
    k = len(t) // mesh.size
    return [t[i * k:(i + 1) * k].to(d, non_blocking=True)
            for i, d in enumerate(mesh.devices)]


def replicate(module: torch.nn.Module, mesh: Mesh) -> List[torch.nn.Module]:
    """One copy of ``module`` on each mesh device."""
    return [copy.deepcopy(module).to(d) for d in mesh.devices]


def device_scope(device: torch.device):
    """The context that makes ``device`` current (its stream is the one the
    kernels launch on); nothing for the CPU."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


# ---- ranks ----------------------------------------------------------------


def _group() -> Tuple[int, int]:
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def world() -> int:
    """The process group's size, or 1 without one."""
    return _group()[1]


def rank() -> int:
    """This process's rank, or 0 without a group."""
    return _group()[0]


def is_main() -> bool:
    """Rank 0, or the one process: the one that writes and evaluates."""
    return rank() == 0


def process_batch_slice(global_batch: int, rank: Optional[int] = None,
                        world: Optional[int] = None) -> Tuple[int, int]:
    """The contiguous [start, stop) rows of a global batch that a rank
    holds (default: this process's), as the JAX function gives them for a
    process on a process-major mesh; the batch must divide over the
    ranks."""
    r, w = _group()
    r, w = (r if rank is None else rank), (w if world is None else world)
    if global_batch % w:
        raise ValueError(f"global batch {global_batch} does not divide over "
                         f"{w} ranks")
    k = global_batch // w
    return r * k, (r + 1) * k


def process_rows(batch_size: int, accum: int = 1,
                 rank: Optional[int] = None,
                 world: Optional[int] = None) -> np.ndarray:
    """The rows of an (accum * batch_size)-row global batch that a rank
    holds: its slice of every microbatch, microbatch a being rows
    [a * batch_size, (a + 1) * batch_size) as in the JAX train step."""
    lo, hi = process_batch_slice(batch_size, rank, world)
    return np.concatenate([np.arange(a * batch_size + lo, a * batch_size + hi)
                           for a in range(accum)])


def init_distributed(backend: Optional[str] = None,
                     init_method: str = "env://", rank: int = -1,
                     world_size: int = -1):
    """Join a process group: NCCL where CUDA is available, else gloo, or
    ``backend`` by name. env:// reads RANK, WORLD_SIZE, MASTER_ADDR and
    MASTER_PORT; NCCL ranks take cuda:LOCAL_RANK (else cuda:rank) as their
    current device."""
    backend = backend or ("nccl" if torch.cuda.is_available() else "gloo")
    store, r, w = next(dist.rendezvous(init_method, rank, world_size,
                                       timeout=RENDEZVOUS_TIMEOUT))
    store.set_timeout(RENDEZVOUS_TIMEOUT)
    device = None
    if backend == "nccl":
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", r)))
        torch.cuda.set_device(device)
    dist.init_process_group(backend, store=store, rank=r, world_size=w,
                            timeout=COLLECTIVE_TIMEOUT, device_id=device)


def broadcast_object(obj):
    """Rank 0's ``obj`` on every rank (picklable)."""
    if not dist.is_initialized():
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def barrier():
    """Wait for every rank (nothing without a group)."""
    if dist.is_initialized():
        dist.barrier()


class _AllReduceSum(torch.autograd.Function):
    """Sum over the group; the gradient of each rank's input is the sum of
    every rank's output gradient, so the backward of a loss that is the sum
    of the ranks' shares is exact."""

    @staticmethod
    def forward(ctx, x):
        y = x.clone()
        dist.all_reduce(y)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g)
        return g


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum of ``x`` over the group, differentiable (``x`` without one)."""
    return _AllReduceSum.apply(x) if world() > 1 else x


# ---- local ranks ------------------------------------------------------------


def _rank_main(fn, args, r: int, w: int, backend: str, init: str, q):
    try:
        init_distributed(backend, init, r, w)
        out = fn(*args)
    except BaseException:
        # reported before this rank's exit closes its connections, so the
        # cause arrives ahead of the errors it raises in the other ranks
        q.put(("error", r, traceback.format_exc()))
        q.close()
        q.join_thread()
        raise SystemExit(1)
    dist.destroy_process_group()
    q.put(("ok", r, out if r == 0 else None))


def spawn(fn: Callable, world_size: int, args: Sequence = (),
          backend: str = "gloo", timeout: Optional[float] = None):
    """fn(*args) in ``world_size`` new processes (spawned), rank r joined to
    a ``backend`` group by a file:// rendezvous in a temporary directory;
    returns rank 0's result. ``fn`` must be importable by name.

    A rank that raises or dies ends the others at once, and the call raises
    with its traceback; ``timeout`` seconds (None: none) bound the run."""
    ctx = multiprocessing.get_context("spawn")
    q = ctx.Queue()
    deadline = None if timeout is None else time.monotonic() + timeout
    with tempfile.TemporaryDirectory() as tmp:
        init = Path(tmp, "rendezvous").as_uri()
        procs = [ctx.Process(target=_rank_main,
                             args=(fn, tuple(args), r, world_size, backend,
                                   init, q))
                 for r in range(world_size)]
        for p in procs:
            p.start()
        try:
            return _collect(procs, q, deadline)
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
            for p in procs:
                p.join(10)
                if p.is_alive():
                    p.kill()
                    p.join(10)


def _collect(procs, q, deadline):
    """Rank 0's result once every rank has reported. A failure raises, with
    every failure seen within GRACE_S of the first (a rank's error makes
    the others' collectives fail too): errors in arrival order, and ranks
    that exited without a word."""
    done, result, failures, seen_dead = set(), None, {}, {}
    first = None
    while len(done) < len(procs):
        try:
            status, r, payload = q.get(timeout=0.5)
            if status == "error":
                failures.setdefault(r, f"rank {r} failed:\n{payload}")
            else:
                done.add(r)
                result = payload if r == 0 else result
        except queue.Empty:
            pass
        now = time.monotonic()
        for r, p in enumerate(procs):
            # a rank's last message is in the pipe before it exits: wait a
            # little for it before calling the rank silent
            if r not in done and r not in failures and p.exitcode is not None:
                if now - seen_dead.setdefault(r, now) > 2.0:
                    failures[r] = (f"rank {r} exited with code {p.exitcode} "
                                   "and no result")
        if failures:
            first = now if first is None else first
            if now - first > GRACE_S or len(done) + len(failures) == len(
                    procs):
                raise RuntimeError("\n".join(failures.values()))
        if deadline is not None and now > deadline:
            missing = sorted(set(range(len(procs))) - done)
            raise TimeoutError(f"ranks {missing} did not finish in time")
    return result
