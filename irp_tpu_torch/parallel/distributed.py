"""Process groups and the collectives of the data and model axes (the JAX
package's ``parallel/distributed.py``).

JAX runs one controller per host over every local device; the PyTorch
idiom is one process per device.  :func:`initialize` joins this process
to a ``torch.distributed`` group over TCP and records the device the
process drives; ``parallel/mesh.py::make_mesh`` then builds a process
mesh whose data axis is the ranks.  Launch one process per device by
hand (``initialize(coordinator_address, num_processes, process_id)``) or
with ``torchrun`` (``initialize(auto=True)`` reads its ``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` and ``MASTER_PORT``).

The port's collectives are built from ``broadcast`` and ``all_reduce``
only: those are the two that gloo runs on CUDA tensors, so a gloo group
of ranks that share one card and an NCCL group of one rank per card run
the same code.  A failed collective raises; nothing retries it on the
host.

Tensor parallelism (``parallel/tensor.py``) needs two differentiable
collectives over the model axis, Megatron's *f* and *g*:
:func:`copy_to_model` (identity forward, SUM of the gradients backward)
and :func:`reduce_from_model` (SUM forward, identity backward).  Both
reduce in f32 (f64 stays).
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence

import torch
import torch.distributed as dist

_LOCAL_DEVICE: Optional[torch.device] = None


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               auto: bool = False, backend: Optional[str] = None,
               device=None) -> None:
    """Join the process group: ``init_process_group`` with
    ``init_method=f"tcp://{coordinator_address}"``.

    With no arguments this is a no-op (one process).  ``auto=True``
    takes what the arguments leave out from torchrun's environment.  A
    second call on an initialized group is a no-op.  ``device``: the
    device this process drives, ``cuda:{LOCAL_RANK}`` by default (the
    process index modulo the card count without torchrun), or the CPU
    when the caller asks for it; ``backend``: NCCL for a CUDA device and
    gloo for the CPU unless given (gloo lets several ranks share one
    card, which NCCL refuses).
    """
    global _LOCAL_DEVICE

    if not auto and num_processes is None and coordinator_address is None:
        return
    if dist.is_initialized():
        return
    env = os.environ
    if auto:
        if coordinator_address is None:
            coordinator_address = (f"{env.get('MASTER_ADDR', 'localhost')}:"
                                   f"{env['MASTER_PORT']}")
        if num_processes is None:
            num_processes = int(env["WORLD_SIZE"])
        if process_id is None:
            process_id = int(env["RANK"])
    if coordinator_address is None or num_processes is None \
            or process_id is None:
        raise ValueError("initialize needs coordinator_address, "
                         "num_processes and process_id (or auto=True "
                         "under torchrun)")
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run "
                "the process group on the CPU")
        local = int(env.get("LOCAL_RANK",
                            process_id % torch.cuda.device_count()))
        device = f"cuda:{local}"
    dev = torch.device(device)
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(dev)
    dist.init_process_group(
        backend or ("nccl" if dev.type == "cuda" else "gloo"),
        init_method=f"tcp://{coordinator_address}",
        world_size=int(num_processes), rank=int(process_id))
    _LOCAL_DEVICE = dev


def shutdown() -> None:
    """Leave the process group (a no-op without one)."""
    global _LOCAL_DEVICE

    if dist.is_initialized():
        dist.destroy_process_group()
    _LOCAL_DEVICE = None


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def local_device() -> Optional[torch.device]:
    """The device :func:`initialize` gave this process (None without a
    group); for a group joined without it, the current CUDA device, or
    the CPU without a card."""
    if not is_initialized():
        return None
    if _LOCAL_DEVICE is not None:
        return _LOCAL_DEVICE
    return (torch.device("cuda", torch.cuda.current_device())
            if torch.cuda.is_available() else torch.device("cpu"))


def _rank() -> int:
    return dist.get_rank() if is_initialized() else 0


def _world() -> int:
    return dist.get_world_size() if is_initialized() else 1


def process_index() -> int:
    """This process's rank (0 without a group)."""
    return _rank()


def process_count() -> int:
    """The ranks in the group (1 without a group)."""
    return _world()


def global_batch_for(per_device_batch: int) -> int:
    """The global batch of a run whose every device takes
    ``per_device_batch`` rows: times the ranks of the group (one device
    each), or without a group times the local cards (one on a host
    without a card)."""
    n = _world() if is_initialized() else max(torch.cuda.device_count(), 1)
    return int(per_device_batch) * n


def host_shards(shard_paths: Sequence[str],
                process_index: Optional[int] = None,
                process_count: Optional[int] = None) -> List[str]:
    """Round-robin shard assignment for this process's input pipeline:
    of the sorted paths, those whose position is this process's index
    modulo the process count."""
    pi = _rank() if process_index is None else process_index
    pc = _world() if process_count is None else process_count
    return [p for i, p in enumerate(sorted(shard_paths)) if i % pc == pi]


def all_reduce_sum(t: torch.Tensor, group=None) -> torch.Tensor:
    """Sum ``t`` over the group's ranks, in place; returns ``t``."""
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    return t


def broadcast(t: torch.Tensor, src: int = 0, group=None) -> torch.Tensor:
    """Overwrite ``t`` with rank ``src``'s, in place; returns ``t``."""
    dist.broadcast(t, src=src, group=group)
    return t


class _AllReduceSum(torch.autograd.Function):
    """Sum over the ranks whose backward sums the gradients over the
    ranks: the gradient of the sum of every rank's loss."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce_sum(x.clone(), group)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_sum(grad.contiguous().clone(), ctx.group), None


def all_reduce_sum_autograd(x: torch.Tensor, group=None) -> torch.Tensor:
    """:func:`all_reduce_sum` out of place, differentiable (BatchNorm's
    global moments)."""
    return _AllReduceSum.apply(x, group)


def _f32_sum(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` summed over the group in f32 (f64 stays), out of place, in
    ``t``'s dtype."""
    wide = t.double() if t.dtype == torch.float64 else t.float()
    wide = all_reduce_sum(wide.contiguous().clone(), group)
    return wide.to(t.dtype)


class _CopyToModel(torch.autograd.Function):
    """Megatron's *f*: identity forward; the gradients of the ranks of
    the model group summed backward (each rank's column shard gives its
    share of the input's gradient)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _f32_sum(grad, ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    """Megatron's *g*: the ranks' partial products summed forward;
    identity backward (the loss is replicated over the model axis, so
    each rank's gradient of the sum is already the whole one)."""

    @staticmethod
    def forward(ctx, x, group):
        return _f32_sum(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def copy_to_model(x: torch.Tensor, group) -> torch.Tensor:
    """*f* over the model ``group``: the input of a column-parallel
    layer."""
    return _CopyToModel.apply(x, group)


def reduce_from_model(x: torch.Tensor, group) -> torch.Tensor:
    """*g* over the model ``group``: the partial products of a
    row-parallel layer, summed."""
    return _ReduceFromModel.apply(x, group)


def all_reduce_grads(params, group=None) -> None:
    """Sum the ``.grad`` of ``params`` over the ranks with one flat
    all-reduce per dtype (a missing grad counts as zeros)."""
    params = [p for p in params if p.requires_grad]
    by_dtype: dict = {}
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
        by_dtype.setdefault(p.grad.dtype, []).append(p.grad)
    for grads in by_dtype.values():
        flat = all_reduce_sum(torch.cat([g.reshape(-1) for g in grads]),
                              group)
        off = 0
        for g in grads:
            n = g.numel()
            g.copy_(flat[off:off + n].view_as(g))
            off += n


def broadcast_module(module: torch.nn.Module, src: int = 0,
                     group=None) -> None:
    """Every parameter and buffer of ``module`` set to rank ``src``'s,
    one flat broadcast per dtype."""
    tensors = list(module.parameters()) + list(module.buffers())
    by_dtype: dict = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    with torch.no_grad():
        for group_ts in by_dtype.values():
            flat = broadcast(torch.cat([t.reshape(-1) for t in group_ts]),
                             src, group)
            off = 0
            for t in group_ts:
                n = t.numel()
                t.copy_(flat[off:off + n].view_as(t))
                off += n
