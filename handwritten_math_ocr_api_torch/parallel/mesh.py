"""Device meshes and sharding rules (data + tensor parallel).

The port of ``handwritten_math_ocr_api_tpu/parallel/mesh.py``. JAX's one
``jax.sharding.Mesh`` plays two roles there, and the port has a mechanism
for each:

- **Serving** shards only the data axis, under one host scheduler:
  ``Mesh`` is a ``(data, tensor)`` grid of ``torch.device``s that one
  process drives. ``replicate`` places one copy of a tree on each data
  device and ``split_rows`` the rows of a batch over them; the engines
  (``decode/api.py``, ``decode/continuous.py``) run each shard on its own
  device. This is PyTorch's single-process idiom (``replicate`` /
  ``scatter`` / ``parallel_apply`` / ``gather``); the reference ran its
  eval under ``nn.DataParallel``.
- **Training** runs one process per device under ``torch.distributed``
  (``torchrun``) on a 2-D ``DeviceMesh`` named ``("data", "tensor")``:
  ``shard_params`` places the params as DTensors by ``TP_RULES``,
  ``shard_batch`` the batch's rows on ``data``, and DTensor inserts the
  collectives, as GSPMD does for the JAX step (``replicate_on_tensor``
  and ``placed_like`` at the points where torch 2.11's DTensor stops).

``TP_RULES`` and ``param_spec`` are JAX's: ``param_spec`` returns the
tuple that JAX's ``PartitionSpec`` holds (``()`` for replicated).

Like JAX's mesh, ``make_mesh`` takes any list of devices, one device
repeated included: the CPU tests build ``["cpu"] * 4`` and a one-card
machine ``[cuda:0, cuda:0]``, the counterpart of the JAX tests' virtual
CPU devices (the shards then share one device). A training mesh cannot
repeat a device: NCCL puts one rank on one GPU.
"""

from __future__ import annotations

import contextlib
import functools
import re
import sys
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..utils import tree as tree_lib

AXES = ("data", "tensor")


class Mesh:
    """A ``(data, tensor)`` grid of devices (``devices``, a numpy object
    array of ``torch.device``) with JAX's ``shape`` mapping."""

    def __init__(self, devices: np.ndarray):
        self.devices = devices

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(AXES, self.devices.shape))

    @property
    def data_devices(self) -> List[torch.device]:
        """The device of each data shard (the first of its tensor row)."""
        return list(self.devices[:, 0])


def make_mesh(data: int = -1, tensor: int = 1,
              devices: Optional[Sequence] = None) -> Mesh:
    """Build a ('data', 'tensor') mesh of ``devices`` (every CUDA device if
    not given; names or ``torch.device``s, repeats allowed). ``data=-1``
    uses all remaining devices. A grid that does not fit the devices
    raises ``AssertionError``, as JAX's does."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass devices=['cpu'] * n to "
                "build a mesh on the host")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    n = len(devices)
    if data == -1:
        if n % tensor != 0:
            raise AssertionError(
                f"{n} devices not divisible by tensor={tensor}")
        data = n // tensor
    if data * tensor != n:
        raise AssertionError(f"mesh {data}x{tensor} != {n} devices")
    grid = np.empty((data, tensor), dtype=object)
    for i, d in enumerate(devices):
        grid[i // tensor, i % tensor] = d
    return Mesh(grid)


# (path-regex, spec): first match wins. Paths look like
# "decoder/layers/3/self_attn/w_qkv". Specs shard the head, hidden or vocab
# dimension over 'tensor'; every leaf no rule matches is replicated.
TP_RULES: Tuple[Tuple[str, Tuple[Optional[str], ...]], ...] = (
    # packed qkv: (d, 3d) -- shard output columns (heads)
    (r".*attn/w_qkv$", (None, "tensor")),
    (r".*attn/b_qkv$", ("tensor",)),
    # attention output projection: (d, d) -- shard input rows (heads)
    (r".*attn/w_out$", ("tensor", None)),
    # FFN: fc1 (d, f) column-sharded, fc2 (f, d) row-sharded
    (r".*ffn/fc1/w$", (None, "tensor")),
    (r".*ffn/fc1/b$", ("tensor",)),
    (r".*ffn/fc2/w$", ("tensor", None)),
    (r".*mlp/fc1/w$", (None, "tensor")),
    (r".*mlp/fc1/b$", ("tensor",)),
    (r".*mlp/fc2/w$", ("tensor", None)),
    # vocab projection: shard the vocab dimension
    (r".*fc_out/w$", (None, "tensor")),
    (r".*fc_out/b$", ("tensor",)),
    # embeddings: shard vocab rows
    (r".*embedding/table$", ("tensor", None)),
)


def param_spec(path_str: str, shape: Tuple[int, ...],
               tensor_size: int) -> Tuple[Optional[str], ...]:
    """The spec of one parameter under ``TP_RULES`` (the tuple of JAX's
    ``PartitionSpec``); replicated, ``()``, when the sharded dimension
    does not divide."""
    for pattern, spec in TP_RULES:
        if re.match(pattern, path_str):
            for dim, axis in enumerate(spec):
                if axis == "tensor" and (dim >= len(shape)
                                         or shape[dim] % tensor_size != 0):
                    return ()
            return spec
    return ()


# -- serving: one process, one tree a data device -----------------------------


def _to(node, device: torch.device):
    if torch.is_tensor(node):
        return node.to(device)
    if isinstance(node, dict):
        return {k: _to(v, device) for k, v in node.items()}
    if isinstance(node, tuple) and hasattr(node, "_fields"):  # NamedTuple
        return type(node)(*(_to(v, device) for v in node))
    if isinstance(node, (list, tuple)):
        return type(node)(_to(v, device) for v in node)
    return node


def replicate(tree, mesh: Mesh) -> list:
    """One copy of ``tree`` (nested dicts, lists and NamedTuples of
    tensors) on each data device of ``mesh``, in data order; shards on one
    device share one copy, and a device the tree is already on shares its
    tensors."""
    copies: Dict[torch.device, object] = {}
    for dev in mesh.data_devices:
        if dev not in copies:
            copies[dev] = _to(tree, dev)
    return [copies[dev] for dev in mesh.data_devices]


def split_rows(x: torch.Tensor, mesh: Mesh) -> List[torch.Tensor]:
    """The rows of ``x`` in ``data`` equal parts, each on its data device
    (``P('data')``); the row count must divide."""
    n = mesh.shape["data"]
    if x.shape[0] % n:
        raise ValueError(f"{x.shape[0]} rows do not split over data={n}")
    return [part.to(dev, non_blocking=True)
            for part, dev in zip(x.chunk(n), mesh.data_devices)]


def device_scope(device: torch.device):
    """``torch.cuda.device(device)`` for a CUDA device (the kernels launch
    on the current device's stream), else nothing."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


# -- training: torch.distributed, one process a device ------------------------


def is_dtensor(x) -> bool:
    """Whether ``x`` is a DTensor, without importing DTensor where no
    DTensor can exist yet (a serving or one-device process never loads
    it)."""
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(x, mod.DTensor)


def make_device_mesh(data: int = -1, tensor: int = 1):
    """A ('data', 'tensor') ``DeviceMesh`` over the initialised process
    group (CUDA under NCCL, the CPU under gloo), with ``make_mesh``'s
    checks."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    n = dist.get_world_size()
    if data == -1:
        if n % tensor != 0:
            raise AssertionError(
                f"{n} ranks not divisible by tensor={tensor}")
        data = n // tensor
    if data * tensor != n:
        raise AssertionError(f"mesh {data}x{tensor} != {n} ranks")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    _register_sharding_rules()
    return init_device_mesh(device_type, (data, tensor),
                            mesh_dim_names=AXES)


@functools.cache
def _register_sharding_rules() -> None:
    """DTensor sharding rules of the ops of the train step that some torch
    releases lack or get wrong: ``roll`` (Swin's cyclic shift; no rule in
    torch 2.11) and ``constant_pad_nd`` (the padding of a stage's map to
    whole windows; torch 2.11's rule drops a mesh dimension). Each keeps
    its input's placements where they shard no dimension it moves, so a
    batch-sharded map stays sharded and nothing is sent. Registered once,
    when the first training mesh is made (the registry is torch's)."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import register_sharding

    aten = torch.ops.aten

    def keeping(x, moved, rest):
        """(output, inputs) placements for each placement of ``x`` that
        shards none of the ``moved`` dimensions."""
        keep = [Replicate()] + [Shard(d) for d in range(x.ndim)
                                if d not in moved]
        return [([p], [p] + [None] * len(rest)) for p in keep]

    @register_sharding(aten.roll.default)
    def roll(x, shifts, *rest):
        dims = rest[0] if rest else ()
        moved = ({d % x.ndim for d in dims} if dims
                 else set(range(x.ndim)))  # no dims: the flattened tensor
        return keeping(x, moved, (shifts,) + rest)

    @register_sharding(aten.constant_pad_nd.default)
    def constant_pad_nd(x, pad, *rest):
        moved = {x.ndim - 1 - i for i in range(len(pad) // 2)}
        return keeping(x, moved, (pad,) + rest)


def placements(spec: Tuple[Optional[str], ...]):
    """The DTensor placements on ('data', 'tensor') of a ``param_spec``:
    replicated on data, and on tensor sharded where the spec names it."""
    from torch.distributed.tensor import Replicate, Shard

    dim = next((d for d, axis in enumerate(spec) if axis == "tensor"), None)
    return [Replicate(), Replicate() if dim is None else Shard(dim)]


def shard_params(params, mesh):
    """``params`` as DTensors on ``mesh`` by ``TP_RULES``; each leaf keeps
    its ``requires_grad``."""
    from torch.distributed.tensor import distribute_tensor

    t = mesh.size(AXES.index("tensor"))

    def place(path, x):
        spec = param_spec("/".join(path), tuple(x.shape), t)
        d = distribute_tensor(x.detach(), mesh, placements(spec))
        return d.requires_grad_(x.requires_grad)

    leaves = [place(p, x) for p, x in zip(tree_lib.paths(params),
                                          tree_lib.leaves(params))]
    return tree_lib.unflatten(params, leaves)


def data_rows(x, mesh) -> torch.Tensor:
    """This rank's rows of ``x`` (every rank holds all of them) on the
    mesh's device: its part of ``data`` near-equal parts (an empty one
    where there are fewer rows than parts)."""
    x = torch.as_tensor(x)
    part = torch.tensor_split(x, mesh.size(AXES.index("data")))[
        mesh.get_local_rank("data")]
    return part.to(mesh.device_type).contiguous()


def shard_batch(batch, mesh):
    """Every tensor of ``batch`` (a tree; each rank holds the whole batch)
    as a DTensor of its rows on 'data' and replicated on 'tensor'
    (``P('data')``). Each rank keeps its own rows: nothing is sent. The
    rows must divide over ``data``."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    n = mesh.size(AXES.index("data"))

    def place(x):
        x = torch.as_tensor(x)
        if x.shape[0] % n:
            raise ValueError(f"a batch of {x.shape[0]} rows does not split "
                             f"over data={n}")
        return DTensor.from_local(data_rows(x, mesh), mesh,
                                  [Shard(0), Replicate()], run_check=False)

    return tree_lib.map_tree(place, batch)


def full_tensors(tree):
    """``tree`` with every DTensor gathered into a plain tensor of its whole
    value (a collective: every rank calls it, in the same order)."""
    return tree_lib.map_tree(
        lambda x: x.full_tensor() if is_dtensor(x) else x, tree)


def _replicated(x):
    """``x`` (a DTensor) replicated on 'tensor', differentiably (an
    all-gather or all-reduce where that axis shards it or holds partial
    sums; DTensor sends the gradient back to ``x``'s placements)."""
    from torch.distributed.tensor import Replicate

    t = x.device_mesh.mesh_dim_names.index("tensor")
    if x.placements[t].is_replicate():
        return x
    placements = list(x.placements)
    placements[t] = Replicate()
    return x.redistribute(x.device_mesh, placements)


class _ReplicatedGradient(torch.autograd.Function):
    """The identity, whose gradient is replicated on 'tensor'."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _replicated(g)


def replicate_on_tensor(x):
    """``x`` and its gradient replicated on 'tensor' where ``x`` is a
    DTensor (``_replicated``); any other ``x`` as it is. The model calls
    it where torch 2.11's DTensor rules stop on tensor-sharded operands:
    around the attention core (its forward and backward flatten the
    batch and head dimensions into one, which 2.11 refuses where 'tensor'
    shards the heads: the q, k and v projections and the gradient that
    the row-sharded output projection sends back) and on the
    vocab-sharded embedding's partial rows (which 2.11 cannot add to the
    positional rows). The products keep the placements ``TP_RULES`` gives
    their weights."""
    if not is_dtensor(x):
        return x
    return _ReplicatedGradient.apply(_replicated(x))


def placed_like(grads, params):
    """Each DTensor of ``grads`` redistributed to the placements of its
    param in ``params`` (lists in one order): the partial sums that a
    backward over batch-sharded rows leaves on 'data' (and on 'tensor')
    reduced, as GSPMD gives a gradient its param's sharding. The
    optimizer then sees no partial sums (torch 2.11's DTensor moves
    Adam's first moment off on them); plain tensors are returned as they
    are."""
    return [g.redistribute(p.device_mesh, p.placements) if is_dtensor(g)
            else g for g, p in zip(grads, params)]


def step_scope(tree):
    """The context a step over ``tree`` runs in: for DTensor leaves,
    DTensor's implicit replication (the plain tensors that the step makes,
    its random draws, masks and position tables among them, join the
    DTensors as replicated, so each rank draws the whole batch's values
    and uses its own rows'); for plain leaves, none."""
    leaves = tree_lib.leaves(tree)
    if leaves and is_dtensor(leaves[0]):
        from torch.distributed.tensor.experimental import (
            implicit_replication,
        )

        return implicit_replication()
    return contextlib.nullcontext()


def commit_to_mesh(tree, mesh):
    """Replicate onto ``mesh`` every tensor leaf not already a DTensor on
    it (the optimizer's count and learning rate, BatchNorm statistics);
    DTensors on ``mesh`` (the sharded params) are kept. A step that mixes
    plain tensors with DTensors raises, so a state is committed whole."""
    from torch.distributed.tensor import DTensor, Replicate, distribute_tensor

    rep = [Replicate()] * mesh.ndim

    def place(x):
        if not torch.is_tensor(x):
            return x
        if isinstance(x, DTensor) and x.device_mesh == mesh:
            return x
        d = distribute_tensor(x.detach(), mesh, rep)
        return d.requires_grad_(x.requires_grad)

    return tree_lib.map_tree(place, tree)
