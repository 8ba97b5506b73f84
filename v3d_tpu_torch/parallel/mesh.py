"""Device mesh and sharding helpers (counterpart of v3d_tpu/parallel/mesh.py).

The reference fine-tunes under Lightning DDP over NCCL (SURVEY.md §2.10);
the JAX package declares a ``("data", "model")`` mesh and lets XLA place
the collectives.  Here the mesh is a ``torch.distributed`` ``DeviceMesh``
over the ranks that ``torchrun`` (or a caller) started, one process a card,
and the collectives are placed by hand:

- "data": data parallelism.  Each rank keeps its contiguous slice of every
  batch tensor's leading axis (``shard_batch``); parameters are replicated
  (``replicate``) and gradients averaged over the axis
  (``engines/trainer.py``).  A slice may cut a video's frames: the UNet
  forward is then frame-parallel (``parallel/frames.py``, which also
  exchanges blocks by all_to_all on NCCL).
- "model": tensor parallelism.  ``param_specs`` / ``shard_params`` give the
  placements of ``DEFAULT_TP_RULES``; ``parallel/tensor.py`` cuts a UNet's
  parameters to them (``tp_shard_``) and runs its attention heads and MLP
  columns over the ranks of a model row, all-reducing the row-parallel
  outputs.  As in the JAX package, the fine-tune trainer keeps the
  parameters replicated over "model" (its ranks then compute the same
  step); the dry run's stages and a caller's ``sample_latents`` /
  ``training_loss`` on a cut UNet run tensor-parallel.

Only ``all_reduce``, ``broadcast`` and ``all_gather`` are used: gloo, which
carries two ranks that share one card, takes CUDA tensors for those three
and has no ``reduce_scatter``.  NCCL is the backend on the card and gloo on
the CPU; neither stands in for the other.
"""

from __future__ import annotations

import datetime
import os
import re
from typing import Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

from v3d_tpu_torch.data.prefetch import _tree_map

DATA_AXIS = "data"
MODEL_AXIS = "model"
AXES = (DATA_AXIS, MODEL_AXIS)


def init_distributed(device="cuda", timeout_s: float = 600.0,
                     backend: Optional[str] = None, init_method: str = "env://",
                     rank: Optional[int] = None,
                     world_size: Optional[int] = None) -> torch.device:
    """Join the process group of this rank and return its device.

    ``rank`` / ``world_size`` default to torchrun's ``RANK`` /
    ``WORLD_SIZE``.  On ``device="cuda"`` the rank takes ``cuda:LOCAL_RANK``
    (or the index ``device`` names) and NCCL, which fails loudly where it
    cannot start; ``backend="gloo"`` is for ranks that share one card.  On
    ``device="cpu"``, gloo.  A collective that outlasts ``timeout_s`` fails
    its rank."""
    rank = int(os.environ["RANK"]) if rank is None else rank
    world_size = int(os.environ["WORLD_SIZE"]) if world_size is None else world_size
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("init_distributed: no CUDA device; pass device='cpu' "
                               "to run the ranks on the CPU over gloo")
        index = dev.index if dev.index is not None else int(
            os.environ.get("LOCAL_RANK", rank))
        if index >= torch.cuda.device_count():
            raise RuntimeError(f"init_distributed: rank {rank} wants cuda:{index}, "
                               f"{torch.cuda.device_count()} visible")
        dev = torch.device("cuda", index)
        torch.cuda.set_device(dev)
        backend = backend or "nccl"
    elif dev.type == "cpu":
        backend = backend or "gloo"
        if backend != "gloo":
            raise ValueError(f"init_distributed: backend {backend!r} on the CPU")
    else:
        raise ValueError(f"init_distributed: no backend for device {dev}")
    kw = dict(device_id=dev) if backend == "nccl" else {}
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size,
                            timeout=datetime.timedelta(seconds=timeout_s), **kw)
    return dev


class LocalMesh:
    """The (1, 1) mesh of a process with no process group
    (``single_device_mesh``): the axes of a ``DeviceMesh``, no collective."""

    mesh_dim_names = AXES
    shape = (1, 1)

    def __init__(self, device="cuda"):
        self.device_type = torch.device(device).type

    def size(self, mesh_dim=None) -> int:
        return 1

    def get_local_rank(self, mesh_dim=None) -> int:
        return 0

    def __repr__(self) -> str:
        return f"LocalMesh({self.device_type!r}, (1, 1), {AXES})"


def make_mesh(data: Optional[int] = None, model: int = 1, device="cuda"):
    """The ("data", "model") ``DeviceMesh`` over every rank of the process
    group (``init_distributed`` first); ``data`` defaults to world / model."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("make_mesh: no CUDA device; pass device='cpu' for a "
                           "mesh of CPU ranks")
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: no process group; launch under torchrun and "
                           "call init_distributed(), or use single_device_mesh()")
    from torch.distributed.device_mesh import init_device_mesh

    n = dist.get_world_size()
    if data is None:
        data = n // model
    assert data * model == n, f"mesh {data}x{model} != {n} devices"
    return init_device_mesh(dev.type, (data, model), mesh_dim_names=AXES)


def single_device_mesh(device="cuda") -> LocalMesh:
    """A (1, 1) mesh for a process with no group, so a trainer that takes a
    mesh also runs unlaunched."""
    return LocalMesh(device)


def axis_size(mesh, axis: str) -> int:
    return mesh.size(mesh.mesh_dim_names.index(axis))


def axis_index(mesh, axis: str) -> int:
    """This rank's coordinate along ``axis``."""
    return mesh.get_local_rank(axis)


def data_block(mesh) -> Tuple[int, int]:
    """(this rank's index, the number of ranks) along "data": the ``block``
    of a rank's draws (``diffusion.loss.global_rows``); (0, 1) with no
    mesh (None)."""
    if mesh is None:
        return 0, 1
    return axis_index(mesh, DATA_AXIS), axis_size(mesh, DATA_AXIS)


def _local(mesh) -> bool:
    """True for a process with no group: no mesh (None) or a ``LocalMesh``."""
    return mesh is None or isinstance(mesh, LocalMesh)


def axis_group(mesh, axis: str):
    """The process group of this rank's ranks along ``axis``; None with no
    group (``_local``)."""
    return None if _local(mesh) else mesh.get_group(axis)


def mesh_group(mesh):
    """The group of every rank of the mesh (the world: ``make_mesh`` spans
    it); None with no group (``_local``)."""
    return None if _local(mesh) else dist.group.WORLD


def mesh_device(mesh) -> torch.device:
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def _leaves(tree) -> list:
    out = []
    _tree_map(out.append, tree)
    return out


def shard_block(n: int, mesh, axis: str = DATA_AXIS) -> slice:
    """This rank's contiguous block of a leading axis of ``n`` split over
    ``axis``; ``n`` that the axis does not divide raises."""
    size = axis_size(mesh, axis)
    if n % size:
        raise ValueError(f"leading axis {n} does not split evenly over "
                         f"{axis}={size}")
    per = n // size
    start = axis_index(mesh, axis) * per
    return slice(start, start + per)


def pixel_strips(s: int, n: int) -> List[Tuple[int, int]]:
    """The ``n`` contiguous strips (start, stop) of ``s`` pixels that
    ``torch.tensor_split`` cuts, the first ``s % n`` one pixel longer: each
    rank's pixels in a frame-parallel temporal layer (``parallel/frames.py``);
    a strip of no pixel raises (``s < n``)."""
    if s < n:
        raise ValueError(f"{s} pixels do not give each of {n} ranks a strip")
    sizes = [s // n + (i < s % n) for i in range(n)]
    starts = [sum(sizes[:i]) for i in range(n)]
    return [(a, a + k) for a, k in zip(starts, sizes)]


def shard_batch(tree, mesh):
    """Every tensor's and numeric array's (as a tensor) contiguous slice of
    its leading axis for this rank along "data" (0-d values, ints and
    strings whole), on the host or device it was on."""
    return _tree_map(
        lambda x: x if x.ndim == 0 else x[shard_block(x.shape[0], mesh)], tree)


@torch.no_grad()
def _coalesced(tensors, op) -> None:
    """``op`` on one flat buffer per (dtype, device) of ``tensors``, copied
    back into them."""
    groups: Dict[tuple, list] = {}
    for t in tensors:
        groups.setdefault((t.dtype, t.device), []).append(t)
    for ts in groups.values():
        flat = torch.cat([t.reshape(-1) for t in ts])
        op(flat)
        torch._foreach_copy_(ts, [part.view_as(t) for t, part in
                                  zip(ts, flat.split([t.numel() for t in ts]))])


def replicate(tree, mesh):
    """The tree with every tensor overwritten by the mesh's first rank's
    (data 0, model 0): one broadcast a dtype.  Tensors on the mesh's device
    are overwritten in place; others, and numeric numpy arrays, are copied
    there first."""
    dev = mesh_device(mesh)
    tree = _tree_map(lambda x: x.to(dev), tree)
    group = mesh_group(mesh)
    if group is not None:
        _coalesced([t.detach() for t in _leaves(tree)],
                   lambda flat: dist.broadcast(flat, src=0, group=group))
    return tree


# ---------------------------------------------------------------------------
# Tensor-parallel parameter placement (rules over parameter names)
# ---------------------------------------------------------------------------

# DEFAULT_TP_RULES of the JAX package in the port's parameter names (the
# reference checkpoint's, core/keymap.py).  A torch Linear weight is (out,
# in), a flax kernel (in, out): the JAX P(None, "model") on a kernel shards
# the output features, dim 0 here; P("model", None) the input features, dim
# 1.  Attention Q/K/V and the MLP's first projection split their outputs,
# the projections back split their inputs.  Like the JAX rules, only 2-D
# weights match.
DEFAULT_TP_RULES: Tuple[Tuple[str, int], ...] = (
    (r".*\.(to_q|to_k|to_v)\.weight$", 0),
    (r".*\.to_out(\.0)?\.weight$", 1),
    (r".*\.(net\.0\.proj|c_fc)\.weight$", 0),
    (r".*\.(net\.2|c_proj)\.weight$", 1),
    (r".*\.in_proj(_weight|\.weight)$", 0),
)


def _named(module_or_state) -> Dict[str, torch.Tensor]:
    if isinstance(module_or_state, torch.nn.Module):
        return dict(module_or_state.state_dict())
    return dict(module_or_state)


def param_specs(named_params, rules=DEFAULT_TP_RULES) -> Dict:
    """name -> placement on the "model" axis (``Shard(dim)`` or
    ``Replicate()``) of a module, a state dict or (name, tensor) pairs; a
    parameter that no rule matches is replicated."""
    from torch.distributed.tensor import Replicate, Shard

    specs = {}
    for name, x in _named(named_params).items():
        dim = next((d for pattern, d in rules
                    if re.match(pattern, name) and x.dim() == 2), None)
        specs[name] = Replicate() if dim is None else Shard(dim)
    return specs


def shard_params(module_or_state, mesh, rules=DEFAULT_TP_RULES) -> Dict:
    """name -> DTensor of each parameter on ``mesh``: replicated over
    "data", placed over "model" by ``param_specs``.  Each rank keeps the
    slice of its model coordinate of the (replicated) tensor it holds; no
    data moves.  Placement only: the tensor-parallel forward runs on the
    module that ``parallel.tensor.tp_shard_`` cuts to these slices."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    if isinstance(mesh, LocalMesh):
        raise TypeError("shard_params needs a DeviceMesh (make_mesh)")
    tensors = _named(module_or_state)
    size, index = axis_size(mesh, MODEL_AXIS), axis_index(mesh, MODEL_AXIS)
    out = {}
    for name, spec in param_specs(tensors, rules).items():
        x = tensors[name].detach()
        if isinstance(spec, Shard):
            if x.shape[spec.dim] % size:
                raise ValueError(f"{name}: dim {spec.dim} of {tuple(x.shape)} does "
                                 f"not split over {MODEL_AXIS}={size}")
            x = x.chunk(size, spec.dim)[index]
        out[name] = DTensor.from_local(x, mesh, [Replicate(), spec], run_check=False)
    return out


def all_reduce_mean_(tensors, mesh, axis: str = DATA_AXIS) -> None:
    """Average ``tensors`` over ``axis`` in place: one all_reduce (sum) on
    a flat buffer a dtype, then divided by the axis size; nothing with no
    group."""
    group = axis_group(mesh, axis)
    if group is None:
        return
    size = axis_size(mesh, axis)

    def reduce(flat):
        dist.all_reduce(flat, group=group)
        flat.div_(size)

    _coalesced([t.detach() for t in tensors], reduce)


def is_first_rank(mesh) -> bool:
    """True on the mesh's first rank (data 0, model 0), which writes files
    and logs, and in a process with no mesh (None)."""
    return _local(mesh) or dist.get_rank() == 0


def barrier(mesh) -> None:
    group = mesh_group(mesh)
    if group is not None:
        dist.barrier(group=group)

