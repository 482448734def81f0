"""The device mesh of the port (the JAX package's ``parallel/mesh.py``).

The JAX mesh is one controller over every local device; the PyTorch
idiom is one process per device.  :class:`Mesh` carries both forms of
the ``data`` axis:

- **A local mesh** (``make_mesh(cfg, devices=[...])`` with no process
  group): the data axis is a tuple of devices that this one process
  drives.  Devices may repeat (``[cpu, cpu]``, ``[cuda:0, cuda:0]``).
  Inference uses it: ``Predictor(mesh=)``, ``extract_features(mesh=)``
  and the CLIs' ``--data-parallel`` split each batch evenly over the
  devices, run each part's forward on its device and concatenate the
  parts in order, with no collective.  Without ``devices`` it is every
  local CUDA device: on one card, one device, and ``--data-parallel``
  then changes nothing, as in the JAX package with one device.
- **A process mesh** (``make_mesh()`` after
  ``parallel/distributed.py::initialize``): the data axis is the ranks,
  one device each, and the mesh keeps the process group.  Training uses
  it: ``fit(mesh=)`` and ``train_final_model(mesh=)`` run one process
  per device, each holding its rows of every global batch; BatchNorm's
  moments, the loss denominator, the gradients (one flat all-reduce
  SUM after the backward) and the metrics are summed over the ranks, so
  a step is the JAX package's step on the global batch.  This is the
  port's counterpart of JAX's single controller: ``fit`` on a local
  mesh of more than one device raises, naming ``distributed.initialize``
  and ``torchrun``.

The ``model`` axis (Megatron tensor parallelism of the head and of the
ViT and ConvNeXt blocks) is not ported: ``MeshConfig(model>1)`` raises
``NotImplementedError`` (ROADMAP A14b).
"""

from __future__ import annotations

import copy
from typing import List, Sequence, Tuple

import numpy as np
import torch

from irp_tpu_torch.config import MeshConfig
from irp_tpu_torch.parallel import distributed

DATA_AXIS = "data"
MODEL_AXIS = "model"
_A14B = ("MeshConfig(model>1), tensor parallelism of the head and of the "
         "ViT and ConvNeXt blocks, is not ported yet (ROADMAP.md, Queue 1, "
         "A14b); use model=1")


class Mesh:
    """The data axis: ``devices`` this process drives (a local mesh), or
    this rank's one device in a process group of ``size`` ranks (a
    process mesh, ``group`` set, ``index`` its rank)."""

    def __init__(self, devices: Sequence, group=None, index: int = 0,
                 size: int | None = None):
        self.devices: Tuple[torch.device, ...] = tuple(
            torch.device(d) for d in devices)
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        self.group = group
        self.index = int(index)
        self.size = int(size if size is not None else len(self.devices))
        if group is None and self.size != len(self.devices):
            raise ValueError("a local mesh's size is its device count")

    @property
    def shape(self) -> dict:
        return {DATA_AXIS: self.size, MODEL_AXIS: 1}

    @property
    def is_process(self) -> bool:
        """Whether the data axis is a process group's ranks."""
        return self.group is not None

    @property
    def device(self) -> torch.device:
        """The device this process computes on first: its rank's
        device, or a local mesh's first."""
        return self.devices[0]

    @property
    def is_leader(self) -> bool:
        """Rank 0 of a process mesh, or any local mesh: the process that
        writes files and tracking runs."""
        return self.index == 0

    def rows(self, n: int) -> List[slice]:
        """The data axis's even split of ``n`` rows: one slice per
        device of a local mesh, this rank's one slice of a process
        mesh."""
        if n % self.size:
            raise ValueError(f"batch {n} does not split over the "
                             f"{self.size}-way data axis")
        part = n // self.size
        if self.is_process:
            return [slice(self.index * part, (self.index + 1) * part)]
        return [slice(i * part, (i + 1) * part) for i in range(self.size)]

    def __repr__(self):
        kind = (f"process rank {self.index}/{self.size}" if self.is_process
                else "local")
        return f"Mesh({kind}, {[str(d) for d in self.devices]})"


def _local_cuda_devices() -> List[torch.device]:
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass devices=[torch.device("
            "'cpu')] for a mesh on the CPU")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(cfg: MeshConfig = MeshConfig(), devices=None) -> Mesh:
    """The data-axis mesh: a process mesh over the group's ranks when
    ``distributed.initialize`` has run and no ``devices`` are given,
    else a local mesh over ``devices`` (default: every local CUDA
    device), cut to ``cfg``'s data size."""
    if cfg.model > 1:
        raise NotImplementedError(_A14B)
    if devices is None and distributed.is_initialized():
        world = distributed.process_count()
        data, _ = cfg.axis_sizes(world)
        if data != world:
            raise ValueError(f"a process mesh spans every rank: data={data} "
                             f"with {world} processes")
        return Mesh([distributed.local_device()],
                    group=torch.distributed.group.WORLD,
                    index=distributed.process_index(), size=world)
    devices = list(devices) if devices is not None \
        else _local_cuda_devices()
    data, _ = cfg.axis_sizes(len(devices))
    if data > len(devices) or data < 1:
        raise ValueError(f"mesh {data}x1 needs {data} devices, have "
                         f"{len(devices)}")
    return Mesh(devices[:data])


def batch_sharding(mesh: Mesh):
    """Batch tensors split on the leading dim: the (device, rows) pairs
    this process holds (``Mesh.rows``)."""
    return lambda n: list(zip(mesh.devices, mesh.rows(n)))


def replicated(mesh: Mesh) -> Tuple[torch.device, ...]:
    """The distinct devices a replicated tensor lives on in this
    process."""
    return tuple(dict.fromkeys(mesh.devices))


def shard_variables(mesh: Mesh, model: torch.nn.Module
                    ) -> List[torch.nn.Module]:
    """The model on every distinct device of this process (a copy per
    device after the first, which is ``model`` itself); on a process
    mesh, every parameter and buffer is then broadcast from rank 0, so
    that every rank starts from the same weights."""
    devices = replicated(mesh)
    out = []
    for i, dev in enumerate(devices):
        m = model if i == 0 else copy.deepcopy(model)
        m = m.to(device=dev, memory_format=torch.channels_last)
        out.append(m)
    if mesh.is_process:
        distributed.broadcast_module(out[0], 0, mesh.group)
    return out


def gather_rows(mesh: Mesh, local: torch.Tensor, n_total: int,
                index: np.ndarray) -> torch.Tensor:
    """Each rank's rows into one (n_total, ...) tensor on every rank:
    rank r writes ``local`` at ``index`` (its rows' positions, which no
    other rank writes) into zeros and the ranks' buffers are summed
    (``all_reduce``, so that gloo on CUDA tensors and NCCL share the
    path)."""
    out = torch.zeros((n_total,) + tuple(local.shape[1:]),
                      dtype=local.dtype, device=local.device)
    out[torch.as_tensor(index, device=local.device)] = local
    if mesh.is_process:
        distributed.all_reduce_sum(out, mesh.group)
    return out
