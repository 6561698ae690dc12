"""Data parallelism over processes, the port's counterpart of the JAX
package's ``parallel/mesh.py``.

The JAX package is single-controller: one process holds a ``Mesh`` of D
devices, batches are sharded on axis 0 (``P("data")``), parameters are
replicated, and XLA reduces the gradients, so a step means what the
single-device step means. The port gets the same semantics from
``torch.distributed`` with one process a rank:

- ``launch`` starts D ranks (``torch.multiprocessing`` spawn) and waits
  until every rank has returned or one has failed, or, where the caller
  gives one, until a timeout (the tests' and the smoke's launches). The
  rendezvous is a file store in a fresh temporary
  directory, so concurrent launches never share a port. On CUDA under NCCL
  rank r takes ``cuda:r``; under gloo ranks may share a device, and on the
  CPU they run under gloo. Each rank computes on one CPU thread.
- ``make_mesh`` gives the rank its ``Mesh``: the world size, its rank and
  its device. Outside a rank it is the one-device mesh, on which every
  collective below is the identity, so the trainers and the evaluations
  run one code path for any D.
- ``data_sharding`` / ``shard_batch``: the rank's contiguous share of axis
  0, as ``P("data")`` places it (shares of ceil(n / D), the last one
  shorter). ``replicate`` broadcasts a module's parameters and buffers
  from rank 0.
- ``gather_rows``: the rows of a global batch, each held by one rank's
  share, put together on every rank (bit for bit: each row's bytes are
  summed as integers with the zeros of the other ranks).
- ``mean_gradients``: the gradients averaged over the ranks, once a step.
- ``all_reduce``, ``all_reduce_sum`` (differentiable), ``all_gather``,
  ``any_rank``, ``barrier``.

A train-mode BatchNorm normalises over the whole global batch when a mesh
of more than one rank is active (``models/batchnorm.py`` reads
``active_mesh``).
"""

from __future__ import annotations

import dataclasses
import math
import os
import pickle
import queue
import shutil
import tempfile
import time
import traceback
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One rank's view of the data axis: ``size`` ranks, this one ``rank``,
    computing on ``device``. ``distributed``: the collectives run through
    ``torch.distributed`` (inside a rank), else they are identities."""

    size: int = 1
    rank: int = 0
    device: torch.device = torch.device("cpu")
    distributed: bool = False

    @property
    def is_main(self) -> bool:
        return self.rank == 0


_MESH: Optional[Mesh] = None     # the rank's mesh, set by the rank's entry
EXIT_GRACE_S = 60.0              # seconds a rank may take to exit after its result


def in_rank() -> bool:
    """True inside a process that ``launch`` started."""
    return _MESH is not None


def active_mesh() -> Optional[Mesh]:
    """The rank's mesh when it has more than one rank, else None."""
    return _MESH if _MESH is not None and _MESH.size > 1 else None


def make_mesh(n_devices: Optional[int] = None, device=None) -> Mesh:
    """The data mesh of this process (the JAX ``make_mesh``): inside a rank
    its mesh, whose size must be ``n_devices`` where that is above 1;
    outside, the one-device mesh on ``device``. More than one device
    outside a rank raises: ranks are processes that ``launch`` starts."""
    n = int(n_devices or 0)
    if _MESH is not None:
        if n > 1 and n != _MESH.size:
            raise ValueError(f"{n} data-parallel devices asked for in a world of {_MESH.size}")
        return _MESH
    if n > 1:
        raise RuntimeError(f"{n} data-parallel devices need {n} ranks: start them with "
                           "blurry_edges_tpu_torch.parallel.launch (the CLI's --dp_devices does)")
    return Mesh(device=torch.device(device or "cpu"))


def data_sharding(n: int, mesh: Mesh) -> slice:
    """The rank's contiguous share of an axis of length ``n``."""
    per = math.ceil(n / mesh.size)
    return slice(min(n, mesh.rank * per), min(n, (mesh.rank + 1) * per))


def shard_batch(batch: Dict[str, object], mesh: Mesh) -> Dict[str, object]:
    """The rank's share of every array of ``batch`` on axis 0."""
    return {k: v[data_sharding(len(v), mesh)] for k, v in batch.items()}


@torch.no_grad()
def replicate(module: torch.nn.Module, mesh: Mesh) -> torch.nn.Module:
    """Every parameter and buffer of ``module`` broadcast from rank 0."""
    if mesh.distributed:
        for t in list(module.parameters()) + list(module.buffers()):
            dist.broadcast(t.data, 0)
    return module


def all_reduce(t: torch.Tensor, mesh: Mesh, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """``t`` reduced over the ranks, in place; returns ``t``."""
    if mesh.distributed:
        dist.all_reduce(t, op=op)
    return t


class _AllReduceSum(torch.autograd.Function):
    """A sum over the ranks whose backward sums the gradients over them."""

    @staticmethod
    def forward(ctx, t):
        t = t.clone()
        dist.all_reduce(t)
        return t

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad)
        return grad


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over the ranks of the default group, differentiably:
    the backward reaches every rank's ``t``."""
    return _AllReduceSum.apply(t)


def all_gather(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Every rank's ``t`` (equal shapes) stacked on a new leading axis, in
    rank order."""
    if not mesh.distributed:
        return t[None]
    out = [torch.empty_like(t) for _ in range(mesh.size)]
    dist.all_gather(out, t.contiguous())
    return torch.stack(out)


def any_rank(flag: bool, mesh: Mesh) -> bool:
    """True on every rank when ``flag`` is true on one (a decision that
    ranks must take together, as a time budget's stop)."""
    t = torch.tensor([float(flag)], device=mesh.device)
    return bool(all_reduce(t, mesh, dist.ReduceOp.MAX).item())


def barrier(mesh: Mesh) -> None:
    if mesh.distributed:
        dist.barrier()


@torch.no_grad()
def mean_gradients(params: Sequence[torch.Tensor], mesh: Mesh) -> None:
    """Each parameter's gradient replaced by its mean over the ranks (one
    all-reduce of the flattened gradients)."""
    if not mesh.distributed:
        return
    grads = [p.grad for p in params if p.grad is not None]
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat)
    flat /= mesh.size
    for g, part in zip(grads, flat.split([g.numel() for g in grads])):
        g.copy_(part.view_as(g))


def gather_rows(shard: Dict[str, torch.Tensor], start: int, idx: np.ndarray,
                mesh: Mesh) -> Dict[str, torch.Tensor]:
    """Rows ``idx`` (global indices) of arrays of which this rank holds rows
    [start, start + len(shard)), on every rank, in the order of ``idx``.
    One all-reduce of the rows' bytes as int32: each row comes from the
    rank that holds it and the others add zeros, so the result is exact in
    any dtype. On the one-device mesh it is ``shard[idx]``."""
    if not mesh.distributed:
        sel = torch.from_numpy(np.asarray(idx) - start)
        return {k: v[sel.to(v.device)] for k, v in shard.items()}
    n_local = len(next(iter(shard.values())))
    idx = np.asarray(idx)
    own = np.flatnonzero((idx >= start) & (idx < start + n_local))
    dev = next(iter(shard.values())).device
    dst = torch.from_numpy(own).to(dev)
    src = torch.from_numpy(idx[own] - start).to(dev)
    parts, layout = [], []
    for k, v in shard.items():
        buf = torch.zeros((len(idx),) + tuple(v.shape[1:]), dtype=v.dtype, device=dev)
        buf[dst] = v[src]
        parts.append(buf.reshape(len(idx), -1).view(torch.uint8))
        layout.append((k, v.dtype, tuple(v.shape[1:]), parts[-1].shape[1]))
    flat = torch.cat(parts, 1)
    pad = (-flat.shape[1]) % 4
    if pad:
        flat = torch.cat([flat, flat.new_zeros((len(idx), pad))], 1)
    words = flat.view(torch.int32).contiguous()
    dist.all_reduce(words)
    flat = words.view(torch.uint8)
    out, at = {}, 0
    for k, dtype, shape, nbytes in layout:
        out[k] = flat[:, at:at + nbytes].contiguous().view(dtype).reshape((len(idx),) + shape)
        at += nbytes
    return out


def _rank_entry(rank, world_size, backend, device, store_file, fn, args, kwargs, results):
    global _MESH
    try:
        # the ranks share this host: collectives' sockets on the loopback
        os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
        os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
        torch.set_num_threads(1)
        device = torch.device(device)
        if device.type == "cuda":
            torch.cuda.set_device(device)
        dist.init_process_group(backend, init_method=f"file://{store_file}",
                                world_size=world_size, rank=rank,
                                **({"device_id": device} if backend == "nccl" else {}))
        _MESH = Mesh(size=world_size, rank=rank, device=device, distributed=True)
        # by value: the queue's pickler would share a tensor's storage
        # through this process, which may have exited when it is read
        out = pickle.dumps(fn(*args, **kwargs))
        dist.barrier()
        results.put((rank, True, out))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def launch(fn: Callable, world_size: int, *, backend: Optional[str] = None,
           devices: Optional[Sequence] = None, args: tuple = (), kwargs: Optional[dict] = None,
           timeout: Optional[float] = None) -> list:
    """Run ``fn(*args, **kwargs)`` in ``world_size`` spawned ranks and
    return their results in rank order. ``devices``: each rank's device
    (default the CPU); ``backend``: ``nccl`` when the devices are CUDA
    ones, else ``gloo``. ``fn`` and its arguments must pickle (``fn`` a
    module-level function). A rank that raises or exits without a result
    stops every rank and raises here, and so does a run past ``timeout``
    seconds where one is given (None: no limit, as a training run needs)."""
    import multiprocessing as mp

    devices = [torch.device(d) for d in (devices or ["cpu"] * world_size)]
    if len(devices) != world_size:
        raise ValueError(f"{len(devices)} devices for {world_size} ranks")
    if backend is None:
        backend = "nccl" if devices[0].type == "cuda" else "gloo"
    if backend == "nccl" and len(set(devices)) < world_size:
        raise ValueError("NCCL takes one rank a device; ranks that share one need gloo")
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    store_dir = tempfile.mkdtemp(prefix="dp_store_")
    procs = [ctx.Process(target=_rank_entry,
                         args=(r, world_size, backend, str(devices[r]),
                               os.path.join(store_dir, "store"), fn, args, kwargs or {},
                               results))
             for r in range(world_size)]
    for p in procs:
        p.start()
    deadline = None if timeout is None else time.monotonic() + timeout
    got = {}
    try:
        while len(got) < world_size:
            try:
                rank, ok, payload = results.get(timeout=1.0)
            except queue.Empty:
                if deadline is not None and time.monotonic() > deadline:
                    raise TimeoutError(f"data-parallel ranks still running after {timeout} s")
                dead = [r for r, p in enumerate(procs) if r not in got and p.exitcode is not None]
                if dead:
                    raise RuntimeError(f"rank(s) {dead} exited without a result "
                                       f"(exit codes {[procs[r].exitcode for r in dead]})")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} of {world_size} failed:\n{payload}")
            got[rank] = pickle.loads(payload)
        for p in procs:
            # every result is in: a rank left only has to exit
            p.join(timeout=EXIT_GRACE_S if deadline is None
                   else max(1.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        shutil.rmtree(store_dir, ignore_errors=True)
    return [got[r] for r in range(world_size)]
