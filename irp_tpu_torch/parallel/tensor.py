"""Megatron tensor parallelism over the ``model`` axis (the layout of the
JAX package's ``parallel/mesh.py::param_shardings``).

A column-parallel layer holds its rank's rows of the weight (torch's
``Linear.weight`` is (out, in), the transpose of flax's kernel) and of
the bias: its output is the rank's columns of the whole layer's.  A
row-parallel layer holds its rank's columns of the weight and the whole
bias: each rank's product is a partial sum, and the ranks' partials are
summed over the model group.  A pair (column, then row) needs one
all-reduce forward (*g*, after the row layer) and one backward (*f*,
before the column layer); what lies between them (ReLU, GELU, the
attention of whole heads) is local.

Both layers keep :class:`~irp_tpu_torch.models.layers.Linear`'s dtype
rules: f32 parameters, the product in the compute dtype.  A row layer's
partials are summed in f32 (f64 stays) and its bias added once, after
the sum, before the one rounding to the compute dtype.

The layers are made from a whole layer by
``parallel/mesh.py::shard_variables``, which keeps each parameter's
``state_dict`` key, and turned back by ``unshard_variables``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from irp_tpu_torch.models.layers import Linear, at_least_f32
from irp_tpu_torch.parallel.distributed import (copy_to_model,
                                                reduce_from_model)


def shard_index(n: int, parts: int, index: int, packs: int = 1,
                device=None) -> torch.Tensor:
    """The positions, along a dim of ``n``, that shard ``index`` of
    ``parts`` holds: of each of ``packs`` equal blocks (q, k and v of a
    packed ``in_proj``), its ``index``-th of ``parts`` equal pieces."""
    block = n // packs
    piece = block // parts
    return torch.cat([torch.arange(p * block + index * piece,
                                   p * block + (index + 1) * piece,
                                   device=device) for p in range(packs)])


class _ModelShard:
    """The model-axis place of a parallel layer: its ``group``, this
    rank's ``index`` on the axis and the axis's size ``parts``."""

    def _set_place(self, group, index: int, parts: int) -> None:
        self.group = group
        self.index = int(index)
        self.parts = int(parts)


class ColumnParallelLinear(_ModelShard, Linear):
    """A dense layer's output rows ``[index * out / parts, (index + 1) *
    out / parts)``; its input goes through *f*."""

    def forward(self, x):
        dt = self.compute_dtype
        x = copy_to_model(x, self.group)
        return F.linear(x.to(dt), self.weight.to(dt), self.bias.to(dt))

    def local_columns(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's columns of a tensor over the whole layer's outputs
        on its last dim (the head's second dropout mask)."""
        idx = shard_index(t.shape[-1], self.parts, self.index,
                          device=t.device)
        return t.index_select(-1, idx)


class RowParallelLinear(_ModelShard, Linear):
    """A dense layer's input columns ``[index * in / parts, (index + 1) *
    in / parts)``: the partial product, summed over the model group by
    *g* in f32, plus the whole bias."""

    def forward(self, x):
        dt = self.compute_dtype
        partial = F.linear(x.to(dt), self.weight.to(dt))
        y = reduce_from_model(at_least_f32(partial), self.group)
        return (y + self.bias.to(y.dtype)).to(dt)
