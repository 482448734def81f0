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

- **The model axis** (``MeshConfig(model=M)``, M > 1; the JAX package's
  ``np.array(devices).reshape(data, model)``): a process mesh of D x M
  ranks puts rank r at data index ``r // M`` and model index ``r % M``;
  the M ranks of one data index form a model group, the D ranks of one
  model index a data group.  ``shard_variables`` lays the head and the
  ViT and ConvNeXt blocks out Megatron-style over the model group
  (``parallel/tensor.py``, :func:`param_shardings`); everything else is
  replicated.  The ranks of one model group hold the same rows of every
  batch, so every data-axis sum (BatchNorm's moments, the loss
  denominator, the gradients, the metrics, the resident sets' rows) runs
  over the data group (``Mesh.group``), as JAX's ``psum('data')``.  A
  local mesh of D x M devices keeps the first device of each model row
  as its data axis: inference replicates the model axis, as the JAX
  package's ``Predictor`` does.
"""

from __future__ import annotations

import copy
import re
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from irp_tpu_torch.config import MeshConfig
from irp_tpu_torch.models.layers import Linear
from irp_tpu_torch.parallel import distributed
from irp_tpu_torch.parallel.tensor import (ColumnParallelLinear,
                                           RowParallelLinear, shard_index)

DATA_AXIS = "data"
MODEL_AXIS = "model"


class Mesh:
    """The data axis: ``devices`` this process drives (a local mesh), or
    this rank's one device in a process group (a process mesh: ``group``
    the data group of ``size`` ranks, ``index`` this rank's place on it).

    The model axis: ``model_size`` ranks (1 without one), this rank's
    place ``model_index`` on it and its ``model_group`` (None unless a
    process mesh has ``model_size`` > 1); ``world_group`` spans every
    rank of a process mesh, and ``rank``, ``index * model_size +
    model_index``, is this rank's place in it."""

    def __init__(self, devices: Sequence, group=None, index: int = 0,
                 size: int | None = None, model_group=None,
                 model_index: int = 0, model_size: int = 1,
                 world_group=None):
        self.devices: Tuple[torch.device, ...] = tuple(
            torch.device(d) for d in devices)
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        self.group = group
        self.index = int(index)
        self.size = int(size if size is not None else len(self.devices))
        if group is None and self.size != len(self.devices):
            raise ValueError("a local mesh's size is its device count")
        self.model_group = model_group
        self.model_index = int(model_index)
        self.model_size = int(model_size)
        self.world_group = world_group if world_group is not None else group
        self.rank = self.index * self.model_size + self.model_index

    @property
    def shape(self) -> dict:
        return {DATA_AXIS: self.size, MODEL_AXIS: self.model_size}

    @property
    def tensor_parallel(self) -> bool:
        """Whether the model is split over a model group of this process
        mesh (``model_size`` > 1)."""
        return self.model_group is not None

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
        """World rank 0 of a process mesh, or any local mesh: the process
        that writes files and tracking runs."""
        return self.rank == 0

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
        kind = (f"process rank {self.rank}: data {self.index}/{self.size}, "
                f"model {self.model_index}/{self.model_size}"
                if self.is_process else f"local, model {self.model_size}")
        return f"Mesh({kind}, {[str(d) for d in self.devices]})"


def _local_cuda_devices() -> List[torch.device]:
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass devices=[torch.device("
            "'cpu')] for a mesh on the CPU")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def _process_mesh(data: int, model: int) -> Mesh:
    """This rank's place on a data x model process mesh over the group:
    every rank creates every model group (one per data index) and every
    data group (one per model index), in that order, and keeps its
    own."""
    world = distributed.process_count()
    rank = distributed.process_index()
    if data * model != world:
        raise ValueError(f"a process mesh spans every rank: data={data} x "
                         f"model={model} with {world} processes")
    whole = torch.distributed.group.WORLD
    if model == 1:
        return Mesh([distributed.local_device()], group=whole, index=rank,
                    size=world)
    new_group = torch.distributed.new_group
    model_groups = [new_group([i * model + j for j in range(model)])
                    for i in range(data)]
    data_groups = [new_group([i * model + j for i in range(data)])
                   for j in range(model)]
    i, j = divmod(rank, model)
    return Mesh([distributed.local_device()], group=data_groups[j], index=i,
                size=data, model_group=model_groups[i], model_index=j,
                model_size=model, world_group=whole)


def make_mesh(cfg: MeshConfig = MeshConfig(), devices=None) -> Mesh:
    """The (data, model) mesh: a process mesh over the group's ranks
    when ``distributed.initialize`` has run and no ``devices`` are given
    (data x model must be the rank count), else a local mesh over
    ``devices`` (default: every local CUDA device), cut to data x model
    of them, whose data axis is the first device of each model row."""
    if devices is None and distributed.is_initialized():
        return _process_mesh(*cfg.axis_sizes(distributed.process_count()))
    devices = list(devices) if devices is not None \
        else _local_cuda_devices()
    data, model = cfg.axis_sizes(len(devices))
    if data * model > len(devices) or data < 1:
        raise ValueError(f"mesh {data}x{model} needs {data * model} "
                         f"devices, have {len(devices)}")
    return Mesh(devices[:data * model:model], model_size=model)


def batch_sharding(mesh: Mesh):
    """Batch tensors split on the leading dim: the (device, rows) pairs
    this process holds (``Mesh.rows``)."""
    return lambda n: list(zip(mesh.devices, mesh.rows(n)))


def replicated(mesh: Mesh) -> Tuple[torch.device, ...]:
    """The distinct devices a replicated tensor lives on in this
    process."""
    return tuple(dict.fromkeys(mesh.devices))


# The Megatron layout of the JAX package's _head_spec under torchvision's
# state_dict keys: (pattern, sharded dim, packs).  Column-parallel
# weights and their biases shard dim 0 (torch's Linear.weight is (out,
# in)); row-parallel weights dim 1, their biases stay whole.  ViT's
# in_proj packs q, k and v (the JAX package's attn_q/k/v): each rank
# holds its rows of each of the three blocks, i.e. whole heads.
# ConvNeXt's block.3/block.5 are the JAX package's mlp_dense1/mlp_dense2.
_VIT_BLOCK = r"backbone\.encoder\.layers\.encoder_layer_\d+\."
_CNX_BLOCK = r"backbone\.features\.\d+\.\d+\.block\."
_LAYOUT = tuple((re.compile(pattern), dim, packs) for pattern, dim, packs in (
    (r"classifier\.1\.(weight|bias)", 0, 1),
    (r"classifier\.4\.weight", 1, 1),
    (_VIT_BLOCK + r"self_attention\.in_proj_(weight|bias)", 0, 3),
    (_VIT_BLOCK + r"self_attention\.out_proj\.weight", 1, 1),
    (_VIT_BLOCK + r"mlp\.0\.(weight|bias)", 0, 1),
    (_VIT_BLOCK + r"mlp\.3\.weight", 1, 1),
    (_CNX_BLOCK + r"3\.(weight|bias)", 0, 1),
    (_CNX_BLOCK + r"5\.weight", 1, 1)))


def _layout(key: str) -> Optional[Tuple[int, int]]:
    """(sharded dim, packs) of a state_dict key, or None (replicated)."""
    for pattern, dim, packs in _LAYOUT:
        if pattern.fullmatch(key):
            return dim, packs
    return None


def param_shardings(mesh: Mesh, model: torch.nn.Module
                    ) -> Dict[str, Optional[int]]:
    """``{state_dict key: the dim split over the model axis, or None}``
    under the JAX package's rules: the head's first dense layer, ViT's
    q/k/v (``in_proj``) and ``mlp.0``, and ConvNeXt's ``block.3`` column-
    parallel (dim 0, their biases too); the head's second dense layer,
    ViT's ``out_proj`` and ``mlp.3``, and ConvNeXt's ``block.5``
    row-parallel (dim 1, their biases None); everything else None.  As in
    the JAX package the rules name the model axis whatever its size."""
    del mesh  # the layout is the rules'; the mesh gives the split's size
    out = {}
    for key in model.state_dict():
        lay = _layout(key)
        out[key] = None if lay is None else lay[0]
    return out


def _index(mesh: Mesh, key: str, n: int, packs: int,
           device) -> torch.Tensor:
    """This rank's positions along the sharded dim (of ``n``) of
    ``key``; ``ValueError`` naming the tensor where it does not split."""
    if n % (packs * mesh.model_size):
        raise ValueError(f"{key}: {n // packs} does not split over the "
                         f"{mesh.model_size}-way model axis")
    return shard_index(n, mesh.model_size, mesh.model_index, packs, device)


def shard_tensors(mesh: Mesh, tensors: Dict[str, torch.Tensor]
                  ) -> Dict[str, torch.Tensor]:
    """Whole tensors keyed by state_dict name -> this rank's slices of
    the sharded ones (the others as they are)."""
    if mesh is None or not mesh.tensor_parallel:
        return dict(tensors)
    out = {}
    for key, t in tensors.items():
        lay = _layout(key)
        if lay is not None:
            dim, packs = lay
            t = t.index_select(dim, _index(mesh, key, t.shape[dim], packs,
                                           t.device)).contiguous()
        out[key] = t
    return out


def gather_tensors(mesh: Mesh, tensors: Dict[str, torch.Tensor]
                   ) -> Dict[str, torch.Tensor]:
    """This rank's slices keyed by state_dict name -> whole tensors on
    every rank of the model group: each rank writes its slice into zeros
    at its positions and the ranks' buffers are summed over the model
    group (``all_reduce``, as :func:`gather_rows`), on the mesh's device;
    each whole tensor is returned on its slice's device."""
    if mesh is None or not mesh.tensor_parallel:
        return dict(tensors)
    out = {}
    for key, t in tensors.items():
        lay = _layout(key)
        if lay is None:
            out[key] = t
            continue
        dim, packs = lay
        local = t.detach().to(mesh.device)
        shape = list(local.shape)
        shape[dim] *= mesh.model_size
        whole = torch.zeros(shape, dtype=local.dtype, device=local.device)
        whole.index_copy_(dim, _index(mesh, key, shape[dim], packs,
                                      local.device), local)
        out[key] = distributed.all_reduce_sum(whole, mesh.model_group).to(
            t.device)
    return out


def _set_module(model: torch.nn.Module, name: str,
                module: torch.nn.Module) -> None:
    parent, _, child = name.rpartition(".")
    setattr(model.get_submodule(parent), child, module)


def _param(t: torch.Tensor, like: torch.nn.Parameter) -> torch.nn.Parameter:
    return torch.nn.Parameter(t, requires_grad=like.requires_grad)


def _linear_as(cls, lin: Linear, weight: torch.Tensor,
               bias: torch.Tensor) -> Linear:
    """A ``cls`` layer (Linear or a parallel one) with ``lin``'s dtype and
    gradient flags, holding ``weight`` and ``bias``."""
    with torch.device("meta"):
        out = cls(weight.shape[1], weight.shape[0], lin.compute_dtype)
    out.weight = _param(weight, lin.weight)
    out.bias = _param(bias, lin.bias)
    return out.train(lin.training)


def _sharded_layers(model: torch.nn.Module):
    """(name, module, parallel class or None) of every module that
    holds a sharded tensor: the dense layers (column- or row-parallel by
    their weight's dim) and ViT's attention (its packed ``in_proj``)."""
    for name, mod in list(model.named_modules()):
        lay = _layout(f"{name}.weight")
        if isinstance(mod, Linear) and lay is not None:
            yield name, mod, (ColumnParallelLinear if lay[0] == 0
                              else RowParallelLinear)
        elif _layout(f"{name}.in_proj_weight") is not None:
            yield name, mod, None


def _shard_model(mesh: Mesh, model: torch.nn.Module) -> None:
    """Swap in the parallel layers, each with this rank's slices."""
    parts = mesh.model_size
    for name, mod, cls in _sharded_layers(model):
        if cls is None:  # ViT's attention: whole heads on each rank
            if mod.num_heads % parts:
                raise ValueError(
                    f"{name}: {mod.num_heads} heads do not split over the "
                    f"{parts}-way model axis (whole heads per rank)")
            local = shard_tensors(mesh, {
                f"{name}.{k}": getattr(mod, k).detach()
                for k in ("in_proj_weight", "in_proj_bias")})
            for k in ("in_proj_weight", "in_proj_bias"):
                setattr(mod, k, _param(local[f"{name}.{k}"],
                                       getattr(mod, k)))
            mod.num_heads //= parts
            mod.model_group = mesh.model_group
            continue
        local = shard_tensors(mesh, {f"{name}.weight": mod.weight.detach(),
                                     f"{name}.bias": mod.bias.detach()})
        new = _linear_as(cls, mod, local[f"{name}.weight"],
                         local[f"{name}.bias"])
        new._set_place(mesh.model_group, mesh.model_index, parts)
        _set_module(model, name, new)


def shard_variables(mesh: Mesh, model: torch.nn.Module
                    ) -> List[torch.nn.Module]:
    """The model on every distinct device of this process (a copy per
    device after the first, which is ``model`` itself); on a process
    mesh, every parameter and buffer is then broadcast from world rank
    0, so that every rank starts from the same weights, and with a model
    axis (``model_size`` > 1) the head and the ViT and ConvNeXt blocks
    are swapped in place for their Megatron layers (``parallel/
    tensor.py``), each rank keeping its slices (:func:`param_shardings`).
    A ViT's heads must split whole over the model axis; ``ValueError``
    names the tensor or the layer that does not split."""
    devices = replicated(mesh)
    out = []
    for i, dev in enumerate(devices):
        m = model if i == 0 else copy.deepcopy(model)
        m = m.to(device=dev, memory_format=torch.channels_last)
        out.append(m)
    if mesh.is_process:
        distributed.broadcast_module(out[0], 0, mesh.world_group)
        if mesh.tensor_parallel:
            _shard_model(mesh, out[0])
    return out


def gather_variables(mesh: Mesh, model: torch.nn.Module
                     ) -> Dict[str, torch.Tensor]:
    """The whole ``state_dict`` on every rank (the counterpart of
    ``np.asarray`` on a sharded JAX array): the model-axis slices
    gathered (:func:`gather_tensors`, a collective every rank of the
    model group calls); the model's own ``state_dict`` without a model
    axis."""
    return gather_tensors(mesh, {k: v.detach() for k, v in
                                 model.state_dict().items()})


def unshard_variables(mesh: Mesh, model: torch.nn.Module
                      ) -> torch.nn.Module:
    """Undo :func:`shard_variables`'s swap in place: every parallel
    layer back to a whole one holding the gathered tensors, the same on
    every rank (a collective); returns ``model``, as is without a model
    axis."""
    if mesh is None or not mesh.tensor_parallel:
        return model
    whole = gather_variables(mesh, model)
    for name, mod, cls in list(_sharded_layers(model)):
        if cls is None:
            for k in ("in_proj_weight", "in_proj_bias"):
                setattr(mod, k, _param(whole[f"{name}.{k}"],
                                       getattr(mod, k)))
            mod.num_heads *= mesh.model_size
            mod.model_group = None
            continue
        _set_module(model, name, _linear_as(
            Linear, mod, whole[f"{name}.weight"], whole[f"{name}.bias"]))
    return model


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
