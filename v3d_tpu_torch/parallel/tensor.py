"""The tensor-parallel forward over "model": attention heads and MLP columns
spread over the ranks of a model row (the port's counterpart of the
collectives that XLA places where v3d_tpu/parallel/mesh.py's
``DEFAULT_TP_RULES`` shard the UNet's parameters).

Placement is ``parallel.mesh.param_specs``': Q/K/V and the MLP's first
projection are column-parallel (each rank holds a contiguous block of their
output features), the attention's and the MLP's projections back are
row-parallel (the matching block of their input features).
``tp_shard_(module, mesh)`` replaces each such parameter by this rank's
block in place, so optimizer state is local, and binds a ``ModelShard`` to
every layer it cut and to the module itself.  One parameter is cut
otherwise: the GEGLU's ``net.0.proj`` (weight and bias) outputs [value |
gate], so rank r keeps value rows and gate rows [r inner/m, (r+1) inner/m)
and forms its own slice of value * gelu(gate), the block ``net.2``'s input
columns hold on the same rank (the same bytes as the even chunk).
``tp_gather`` returns the whole state dict, ``tp_unshard_`` puts it back.

The forward of a bound layer (Megatron's pair of conjugate collectives):

- ``copy_to_model`` at the input of the column-parallel projections:
  identity forward, all_reduce of the cotangent backward (each rank's
  columns give a part of the input's gradient);
- ``reduce_from_model`` at the output of the row-parallel projection:
  all_reduce of the partial products forward, identity backward (every
  rank computes the same loss from the reduced output).  The bias is added
  once, after it.

Heads that straddle two ranks' columns (5 heads of 64 over 2 ranks: 160
columns a rank) are run whole: ``head_plan`` gives each rank every head that
touches its columns, ``gather_columns`` all_gathers the layer's Q/K/V
weights over "model" (backward: all_reduce of the gradient, this rank's
rows), and the rank's row-parallel slice is padded with zero input columns
for the part of a boundary head it does not own, so each output column is
summed once over the ranks.  Layers whose heads split evenly gather nothing.

Routing is the whole layer's (its full head count), so a rank launches the
kernels one process would, on its share of the heads.  Only all_reduce and
all_gather are used (gloo has no reduce_scatter).  On the meta device a
collective moves nothing and returns its result's shape (the full-size
dry-run stage); CPU and CUDA tensors always communicate.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from v3d_tpu_torch.parallel.mesh import (
    MODEL_AXIS,
    axis_group,
    axis_index,
    axis_size,
    param_specs,
)

# collectives this process ran over "model" and the bytes of the
# tensors they reduced or received (meta tensors included: what a forward
# would move); reset with ``reset_traffic``
TRAFFIC: Dict[str, int] = {"all_reduce": 0, "all_gather": 0, "bytes": 0}

# the parameters of each kind of layer that the TP forward cuts, with the
# dim of the weight that is split: 0, output features (column-parallel); 1,
# input features (row-parallel)
TP_PARAMS = {
    "attention": (("to_q.weight", 0), ("to_k.weight", 0), ("to_v.weight", 0),
                  ("to_out.0.weight", 1)),
    "geglu_mlp": (("net.0.proj.weight", 0), ("net.2.weight", 1)),
}
GEGLU_CUT = ("net.0.proj.weight", "net.0.proj.bias")   # re-cut half-wise


def reset_traffic() -> None:
    for k in TRAFFIC:
        TRAFFIC[k] = 0


@dataclasses.dataclass(frozen=True)
class ModelShard:
    """This rank's place in its model row: ``size`` ranks of ``group``, this
    one ``index``."""

    group: Optional[object]
    size: int
    index: int


def model_shard(mesh) -> ModelShard:
    return ModelShard(axis_group(mesh, MODEL_AXIS), axis_size(mesh, MODEL_AXIS),
                      axis_index(mesh, MODEL_AXIS))


@dataclasses.dataclass(frozen=True)
class HeadPlan:
    """One rank's heads of a layer: it runs heads [first, last) and owns the
    inner columns ``cols``; ``pad`` zero columns before and after them fill
    the run heads' span."""

    first: int
    last: int
    cols: Tuple[int, int]
    pad: Tuple[int, int]

    @property
    def heads(self) -> int:
        return self.last - self.first

    @property
    def even(self) -> bool:
        return self.pad == (0, 0)


def head_plan(heads: int, dim_head: int, size: int, index: int) -> HeadPlan:
    """The heads rank ``index`` of ``size`` runs for a layer of ``heads``
    heads of ``dim_head``: every head that touches its even block of the
    inner columns."""
    inner = heads * dim_head
    if inner % size:
        raise ValueError(f"{inner} inner columns do not split over {MODEL_AXIS}={size}")
    per = inner // size
    c0, c1 = index * per, (index + 1) * per
    first, last = c0 // dim_head, -(-c1 // dim_head)
    return HeadPlan(first, last, (c0, c1), (c0 - first * dim_head, last * dim_head - c1))


# ---------------------------------------------------------------------------
# collectives


def _count(kind: str, x: torch.Tensor) -> None:
    TRAFFIC[kind] += 1
    TRAFFIC["bytes"] += x.numel() * x.element_size()


def _all_reduce(x: torch.Tensor, shard: ModelShard) -> torch.Tensor:
    """The sum of x over the model row (a new tensor)."""
    y = x.contiguous().clone()
    _count("all_reduce", y)
    if y.device.type != "meta":
        dist.all_reduce(y, group=shard.group)
    return y


def _all_gather(x: torch.Tensor, shard: ModelShard) -> torch.Tensor:
    """Every rank's x concatenated along dim 0, in rank order."""
    x = x.contiguous()
    if x.device.type == "meta":
        out = x.new_empty((shard.size * x.shape[0],) + tuple(x.shape[1:]))
    else:
        parts = [torch.empty_like(x) for _ in range(shard.size)]
        dist.all_gather(parts, x, group=shard.group)
        out = torch.cat(parts)
    _count("all_gather", out)
    return out


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, shard):
        ctx.shard = shard
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad, ctx.shard), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, shard):
        return _all_reduce(x, shard)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GatherColumns(torch.autograd.Function):
    @staticmethod
    def forward(ctx, w, shard):
        ctx.shard, ctx.rows = shard, w.shape[0]
        return _all_gather(w, shard)

    @staticmethod
    def backward(ctx, grad):
        g = _all_reduce(grad, ctx.shard)
        i = ctx.shard.index * ctx.rows
        return g[i:i + ctx.rows], None


def copy_to_model(x: torch.Tensor, shard: ModelShard) -> torch.Tensor:
    """x, replicated over the model row, at the input of column-parallel
    projections: identity forward, all_reduce of the cotangent backward."""
    return _CopyToModel.apply(x, shard)


def reduce_from_model(x: torch.Tensor, shard: ModelShard) -> torch.Tensor:
    """The sum of the ranks' partial outputs of a row-parallel projection:
    all_reduce forward, identity backward."""
    return _ReduceFromModel.apply(x, shard)


def gather_columns(w: torch.Tensor, shard: ModelShard) -> torch.Tensor:
    """A column-parallel weight whole: every rank's rows (output features)
    in rank order; backward, the all_reduced gradient's rows of this rank."""
    return _GatherColumns.apply(w, shard)


# ---------------------------------------------------------------------------
# the bound layers' weights


def column_weights(layer, dtype: torch.dtype) -> Tuple[Tuple[torch.Tensor, ...], int]:
    """((wq, wk, wv, wo), heads run) of a bound attention layer in ``dtype``:
    its local Q/K/V rows and row-parallel slice, or, where its heads
    straddle the ranks, the run heads' rows of the gathered weights and the
    slice padded with zero columns (``head_plan``)."""
    plan, shard = layer.tp_plan, layer.tp
    ws = [m.weight.to(dtype) for m in (layer.to_q, layer.to_k, layer.to_v)]
    wo = layer.to_out[0].weight.to(dtype)
    if not plan.even:
        rows = slice(plan.first * layer.dim_head, plan.last * layer.dim_head)
        ws = [gather_columns(w, shard)[rows] for w in ws]
        wo = F.pad(wo, plan.pad)
    return (*ws, wo), plan.heads


def row_output(y: torch.Tensor, bias: Optional[torch.Tensor],
               shard: ModelShard) -> torch.Tensor:
    """A row-parallel projection's partial output ``y`` summed over the
    model row, plus its bias once."""
    y = reduce_from_model(y, shard)
    return y if bias is None else y + bias.to(y.dtype)


# ---------------------------------------------------------------------------
# sharding a module


def _geglu_cut(x: torch.Tensor, shard: ModelShard) -> torch.Tensor:
    """Rank ``shard.index``'s value rows and gate rows of a GEGLU projection
    (its output features [value | gate])."""
    value, gate = x.chunk(2, 0)
    return torch.cat([value.chunk(shard.size, 0)[shard.index],
                      gate.chunk(shard.size, 0)[shard.index]])


def _geglu_join(parts) -> torch.Tensor:
    """The inverse of ``_geglu_cut`` over every rank's part."""
    halves = [p.chunk(2, 0) for p in parts]
    return torch.cat([h[0] for h in halves] + [h[1] for h in halves])


def _layers(module):
    """(prefix, layer) of every layer with a tensor-parallel forward."""
    for prefix, mod in module.named_modules():
        if getattr(mod, "tp_kind", None) in TP_PARAMS:
            yield (prefix + "." if prefix else ""), mod


def _set(layer, name: str, value: torch.Tensor) -> None:
    *path, leaf = name.split(".")
    owner = layer
    for p in path:
        owner = getattr(owner, p)
    old = getattr(owner, leaf)
    setattr(owner, leaf, torch.nn.Parameter(value, requires_grad=old.requires_grad))


@torch.no_grad()
def tp_shard_(module: torch.nn.Module, mesh) -> torch.nn.Module:
    """Cut ``module``'s parameters to this rank's blocks along "model" of
    ``mesh`` (``param_specs``' placements; the GEGLU projections re-cut
    half-wise) and bind the model row to the module and to each layer cut.
    Raises where a rule places a parameter that no layer here runs tensor-
    parallel.  A model axis of 1 leaves the module as it is."""
    shard = model_shard(mesh)
    if shard.size == 1:
        return module
    if getattr(module, "tp", None) is not None:
        raise ValueError("tp_shard_: the module is sharded already")
    placed = {name: spec.dim for name, spec in param_specs(module).items()
              if hasattr(spec, "dim")}
    cut = {}
    for prefix, layer in _layers(module):
        for name, dim in TP_PARAMS[layer.tp_kind]:
            cut[prefix + name] = dim
        if layer.tp_kind == "attention":
            layer.tp_plan = head_plan(layer.heads, layer.dim_head, shard.size, shard.index)
    if cut != placed:
        extra = sorted(set(placed.items()) ^ set(cut.items()))
        raise ValueError(f"tp_shard_: the placements and the tensor-parallel layers "
                         f"differ at {extra[:4]}")
    for prefix, layer in _layers(module):
        for name, dim in TP_PARAMS[layer.tp_kind]:
            w = layer.get_parameter(name)
            local = (_geglu_cut(w, shard) if name in GEGLU_CUT
                     else w.chunk(shard.size, dim)[shard.index])
            _set(layer, name, local.contiguous().clone())
        if layer.tp_kind == "geglu_mlp":
            bias = layer.get_parameter(GEGLU_CUT[1])
            _set(layer, GEGLU_CUT[1], _geglu_cut(bias, shard).clone())
        layer.tp = shard
    module.tp = shard
    return module


@torch.no_grad()
def tp_gather(module: torch.nn.Module,
              named: Optional[Dict[str, torch.Tensor]] = None) -> Dict[str, torch.Tensor]:
    """The whole state dict of a module that ``tp_shard_`` cut: one
    all_gather a cut tensor, in the same order on every rank.  ``named``:
    tensors of the parameters' local shapes instead (name -> tensor, e.g.
    their gradients), made whole the same way."""
    state = dict(module.state_dict() if named is None else named)
    for prefix, layer in _layers(module):
        shard = layer.tp
        if shard is None:
            continue
        names = dict(TP_PARAMS[layer.tp_kind])
        if layer.tp_kind == "geglu_mlp":
            names[GEGLU_CUT[1]] = 0
        for name, dim in names.items():
            local = state[prefix + name]
            whole = _all_gather(local.movedim(dim, 0), shard)
            parts = whole.chunk(shard.size, 0)
            full = (_geglu_join(parts) if name in GEGLU_CUT
                    else torch.cat(parts)).movedim(0, dim)
            state[prefix + name] = full.contiguous()
    return state


@torch.no_grad()
def tp_unshard_(module: torch.nn.Module) -> torch.nn.Module:
    """The inverse of ``tp_shard_``: every parameter whole again (``tp_gather``)
    and no binding left."""
    if getattr(module, "tp", None) is None:
        return module
    state = tp_gather(module)
    for prefix, layer in _layers(module):
        names = [n for n, _ in TP_PARAMS[layer.tp_kind]]
        if layer.tp_kind == "geglu_mlp":
            names.append(GEGLU_CUT[1])
        for name in names:
            _set(layer, name, state[prefix + name])
        layer.tp, layer.tp_plan = None, None
    module.tp = None
    return module


def local_param_bytes(module: torch.nn.Module) -> int:
    """The bytes of the parameters this rank holds."""
    return sum(p.numel() * p.element_size() for p in module.parameters())
