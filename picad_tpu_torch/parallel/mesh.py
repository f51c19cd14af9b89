"""Data parallelism over ranks: one process per card.

Counterpart of picad_tpu/parallel/mesh.py.  The JAX package runs one
process per host over a 1-D mesh of all its devices: batches are sharded
on the leading axis, parameters replicated, and XLA inserts the gradient
all-reduce and turns every batch reduction into a global one (exact
sync-BN, global masked losses).  The port states those collectives
itself, in PyTorch's idiom:

- a rank is a process that owns one device (`launch` starts N of them on
  a host, rank i on cuda:i); P hosts join one process group of P*N ranks
  (`initialize_distributed`, tcp:// rendezvous at process 0's address);
- each rank holds its own rows of the global batch (`local_rows`, the
  batcher's strided shard) and moves them to its card itself
  (`put_global_batch`);
- `global_sum` and `global_stats` are the autograd-aware reductions the
  losses and BatchNorm take over the global batch; `all_reduce_grads`
  averages the gradients before the optimizer.

Without a process group every helper is the identity and launches
nothing: the one-card path is the one that ran before.  Only all_reduce,
broadcast and barrier are used, the collectives gloo also offers for
CUDA tensors, so two ranks can share one card over gloo.
"""

from __future__ import annotations

import datetime
import math
import socket
import time
from typing import Callable, Iterable, Sequence

import numpy as np
import torch
import torch.distributed as dist

GRAD_BUCKET_BYTES = 32 << 20  # the gradient all-reduce's flat buckets


def is_active() -> bool:
    """True inside an initialized process group (of any size)."""
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    return dist.get_rank() if is_active() else 0


def world_size() -> int:
    return dist.get_world_size() if is_active() else 1


def is_main() -> bool:
    """Rank 0, or the only process: the one that prints and writes files."""
    return rank() == 0


def backend_for(devices: Sequence) -> str:
    """The backend of a host's ranks on `devices`: NCCL when each rank has
    a card of its own, gloo on the CPU and for ranks that share a card
    (NCCL refuses two ranks on one)."""
    devs = [torch.device(d) for d in devices]
    own_cards = all(d.type == "cuda" for d in devs) and len(set(devs)) == len(devs)
    return "nccl" if own_cards else "gloo"


def rank_seed(seed: int, r: int) -> int:
    """Rank r's dropout seed from (seed, r); rank 0 keeps `seed`, so a
    one-rank run draws what a run without a group draws."""
    return seed + (r << 32)


def free_port() -> int:
    """A free TCP port on localhost for a one-host rendezvous."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def host_devices(num_devices: int, device, devices: Sequence | None = None) -> list[torch.device]:
    """The devices of a host's ranks.  `devices` when given (cuda:0 twice:
    two ranks sharing one card), and --num_devices (0 = as many) must
    count as many; else --num_devices of them (0 = every visible card,
    one on the CPU), rank i on cuda:i, more than the visible cards
    raising, or all on the CPU."""
    if devices is not None:
        devs = [torch.device(d) for d in devices]
        if num_devices not in (0, len(devs)):
            raise ValueError(f"--num_devices {num_devices} with {len(devs)} rank devices")
        return devs
    dev = torch.device(device)
    if dev.type != "cuda":
        return [dev] * (num_devices or 1)
    visible = torch.cuda.device_count()
    n = num_devices or visible
    if n > visible:
        raise ValueError(f"--num_devices {n} > {visible} visible devices")
    return [torch.device("cuda", i) for i in range(n)]


def initialize_distributed(init_method: str, world: int, r: int, *, device,
                           backend: str | None = None, timeout_s: float = 600.0) -> None:
    """Join the process group as rank `r` of `world` (tcp://host:port of
    process 0).  The backend defaults to NCCL on a CUDA device and gloo
    on the CPU; a CUDA rank first makes its card the current device."""
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend or backend_for([dev]), init_method=init_method,
                            world_size=world, rank=r,
                            timeout=datetime.timedelta(seconds=timeout_s))


def launch(fn: Callable, nprocs: int, args: tuple = (), *, timeout: float | None = None) -> None:
    """Run fn(local_rank, *args) in `nprocs` fresh spawned processes and
    wait for all of them.  A rank that fails raises here, and the others
    are stopped; so are all of them when `timeout` seconds pass."""
    import torch.multiprocessing as mp

    ctx = mp.start_processes(fn, args=args, nprocs=nprocs, join=False, start_method="spawn")
    deadline = None if timeout is None else time.monotonic() + timeout
    try:
        while not ctx.join(timeout=1.0):
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError(f"{nprocs} ranks still running after {timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
            p.join()


def local_rows(batch, r: int, world: int):
    """Rank r's contiguous block of rows of a global batch (a dict of
    arrays or tensors, or one of them): the inverse of concatenating the
    ranks' batches in rank order."""
    if isinstance(batch, dict):
        return {k: local_rows(v, r, world) for k, v in batch.items()}
    n = batch.shape[0]
    if n % world:
        raise ValueError(f"local_rows: {n} rows do not split over {world} ranks")
    b = n // world
    return batch[r * b:(r + 1) * b]


def put_global_batch(batch: dict, device) -> dict:
    """This rank's rows of the global batch (numpy arrays or tensors), on
    its device.  Each rank already holds only its own rows, so nothing
    is stitched: the global batch is the ranks' batches in rank order."""
    dev = torch.device(device)
    return {k: (v if isinstance(v, torch.Tensor) else torch.as_tensor(np.asarray(v))
                ).to(dev, non_blocking=True) for k, v in batch.items()}


class _AllReduceSum(torch.autograd.Function):
    """Sum over ranks.  Every rank's loss is the same function of the
    sum, so the adjoint sums the ranks' upstream gradients: a factor of
    `world` that `all_reduce_grads`' average divides out."""

    @staticmethod
    def forward(ctx, t):
        t = t.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(t)
        return t

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g)
        return g


class _AllGather(torch.autograd.Function):
    """(world, *t.shape): every rank's t in rank order, built by one
    all_reduce of a slotted buffer (gloo has no all_gather for CUDA
    tensors).  The adjoint keeps this rank's slot of the summed gradient."""

    @staticmethod
    def forward(ctx, t):
        out = t.new_zeros((dist.get_world_size(), *t.shape))
        out[dist.get_rank()] = t
        dist.all_reduce(out)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g)
        return g[dist.get_rank()]


def global_sum(t: torch.Tensor) -> torch.Tensor:
    """t summed over every rank, differentiable; t itself without a group."""
    return _AllReduceSum.apply(t) if is_active() else t


def global_stats(mean: torch.Tensor, var: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Combine each rank's per-group (mean, biased var) over an equal
    count into the global batch's, differentiably:

        mean = mean_r(mean_r),  var = mean_r(var_r) + mean_r((mean_r - mean)^2),

    the parallel-variance formula, which cancels nothing (E[x^2] - E[x]^2
    would; picad_tpu/ops/bn_stats.py:28-34).  The identity without a group."""
    if not is_active():
        return mean, var
    from picad_tpu_torch.ops.bn_stats import combine_group_stats

    st = _AllGather.apply(torch.stack([mean, var]))  # (world, 2, *mean.shape)
    return combine_group_stats(st[:, 0], st[:, 1])


def all_reduce_grads(parameters: Iterable[torch.nn.Parameter]) -> None:
    """Average the parameters' gradients over the ranks, in place: flat
    buckets of at most GRAD_BUCKET_BYTES (one all_reduce each), in parameter
    order, so every rank issues the same collectives.  Parameters without
    a gradient are skipped (the same ones on every rank)."""
    if not is_active():
        return
    world = dist.get_world_size()
    bucket: list[torch.Tensor] = []
    size = 0

    def flush():
        flat = torch.cat([g.reshape(-1) for g in bucket])
        dist.all_reduce(flat)
        flat.div_(world)
        for g, v in zip(bucket, flat.split([g.numel() for g in bucket])):
            g.copy_(v.view_as(g))

    for p in parameters:
        g = p.grad
        if g is None:
            continue
        nbytes = g.numel() * g.element_size()
        if bucket and (size + nbytes > GRAD_BUCKET_BYTES or g.dtype != bucket[0].dtype):
            flush()
            bucket, size = [], 0
        bucket.append(g)
        size += nbytes
    if bucket:
        flush()


def broadcast_tensors(tensors: Sequence[torch.Tensor], src: int = 0) -> None:
    """Copy rank `src`'s values of `tensors` (parameters, buffers) into
    every rank's, in place; nothing without a group."""
    if not is_active():
        return
    with torch.no_grad():
        for t in tensors:
            dist.broadcast(t.data, src)


def broadcast_object(obj, src: int = 0):
    """Rank `src`'s `obj` (picklable) on every rank; `obj` without a group."""
    if not is_active():
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src)
    return box[0]


def gather_objects(obj) -> list:
    """Every rank's `obj`, in rank order, on every rank; [obj] without a group."""
    if not is_active():
        return [obj]
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, obj)
    return out


def all_reduce_floats(values: Sequence[float], device) -> list[float]:
    """Host floats summed over the ranks (one small all_reduce, on
    `device` for NCCL's sake); the values themselves without a group."""
    if not is_active():
        return [float(v) for v in values]
    t = torch.tensor([float(v) for v in values], dtype=torch.float64, device=device)
    dist.all_reduce(t)
    return t.cpu().tolist()


def barrier() -> None:
    if is_active():
        dist.barrier()


def check_rank_batch(bs: int, n: int) -> int:
    """The per-rank batch of a host batch `bs` over its n ranks; it must
    split evenly and stay even (half labelled, half unlabelled rows)."""
    if bs % n or (bs // n) % 2:
        raise ValueError(f"--bs {bs} over {n} ranks gives {bs / n:g} rows a rank; the "
                         "batcher needs an even count (half labelled, half unlabelled)")
    return bs // n


def steps_lockstep(n: int, world: int, rows: int) -> int:
    """Steps for every rank to cover its strided shard of n items at
    `rows` a step: from the longest shard, at least one (short shards pad)."""
    return max(math.ceil(math.ceil(n / world) / rows), 1)
