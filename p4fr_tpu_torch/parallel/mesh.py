"""The (data, model) mesh over ``torch.distributed`` ranks, port of
``p4fr_tpu/parallel/mesh.py``.

Where the JAX package lays a 2-D grid over the devices one process sees,
the port lays it over the ranks of the process group, one device each: a
card per rank under NCCL (``torchrun --nproc_per_node N``, rank r on
``cuda:LOCAL_RANK``), host ranks under gloo. ``grid[d, m]`` is the rank at
data index d and model index m;

- batch tensors shard over ``data`` (``shard_batch``: this rank's rows);
- the transformer projections split over ``model`` (``param_shardings``:
  the JAX package's partition rule, applied to the flax leaf that the weight
  bridge maps each parameter to);
- a mesh of one rank needs no process group, and every collective over it
  is the identity.

``init_distributed`` joins torchrun's process group (its environment) or,
without one, starts a group of one rank in this process.
"""

from __future__ import annotations

import os
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"

Spec = Tuple[Optional[str], ...]  # one mesh axis (or None) per tensor dim; () replicates


class Axis(NamedTuple):
    """One axis of a mesh as a rank sees it: its ``index`` along the axis,
    the axis's ``size``, and the process group over it (None: this rank
    alone)."""
    index: int
    size: int
    group: Optional[object] = None

    def sum(self, tensor: torch.Tensor) -> torch.Tensor:
        """The sum of ``tensor`` over the axis's ranks, differentiable: its
        backward sums the gradients over them too."""
        if self.group is None:
            return tensor
        from torch.distributed.nn.functional import all_reduce

        return all_reduce(tensor, group=self.group)

    def columns(self, linear: torch.nn.Linear, x: torch.Tensor) -> torch.Tensor:
        """Column-parallel ``linear(x)``: this rank's slice of its outputs."""
        w = linear.weight.chunk(self.size)[self.index]
        return torch.nn.functional.linear(x, w, linear.bias.chunk(self.size)[self.index])

    def rows(self, linear: torch.nn.Linear, x: torch.Tensor) -> torch.Tensor:
        """Row-parallel ``linear``: ``x`` is this rank's slice of the inputs;
        the partial products are summed over the axis before the bias."""
        w = linear.weight.chunk(self.size, dim=1)[self.index]
        return self.sum(torch.nn.functional.linear(x, w)) + linear.bias


class Mesh:
    """A (data, model) grid of ranks. ``rank`` is this process's rank (None:
    a description only, no process group); ``coords`` its (d, m), None where
    the rank is outside the grid; ``data_group`` the ranks that share its m
    (they split the batch), ``model_group`` those that share its d (they
    split the projections); ``group`` every rank of the grid."""

    def __init__(self, grid: np.ndarray, rank: Optional[int] = None,
                 groups: Optional[Dict[str, object]] = None):
        self.grid = np.asarray(grid).reshape(grid.shape[0], -1)
        self.shape = {DATA_AXIS: self.grid.shape[0], MODEL_AXIS: self.grid.shape[1]}
        self.rank = rank
        where = np.argwhere(self.grid == rank) if rank is not None else ()
        self.coords = tuple(int(i) for i in where[0]) if len(where) else None
        groups = groups or {}
        self.group = groups.get("mesh")
        self.data_group = groups.get(DATA_AXIS)
        self.model_group = groups.get(MODEL_AXIS)

    @property
    def size(self) -> int:
        return self.grid.size

    def axis(self, name: str) -> "Axis":
        """This rank's view of one axis of the mesh."""
        index = 0 if self.coords is None else self.coords[name == MODEL_AXIS]
        group = self.data_group if name == DATA_AXIS else self.model_group
        return Axis(index, self.shape[name], group)

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, rank={self.rank}, coords={self.coords})"


def _world() -> Tuple[int, int]:
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def make_mesh(n_data: int = -1, n_model: int = 1,
              devices: Optional[Sequence[int]] = None) -> Mesh:
    """Build a (data, model) mesh over ``devices``, the ranks of the process
    group (default: all of them). ``n_data=-1`` consumes all remaining ranks
    after the model axis. Every rank of the group must call it, in the same
    order as its other group calls (it makes the process subgroups)."""
    rank, world = _world()
    devices = list(devices if devices is not None else range(world))
    if n_model < 1:
        n_model = 1
    if n_data == -1:
        n_data = len(devices) // n_model
    use = n_data * n_model
    if use < 1 or use > len(devices):
        raise ValueError(
            f"mesh {n_data}x{n_model} does not fit {len(devices)} devices")
    grid = np.asarray(devices[:use]).reshape(n_data, n_model)
    if not dist.is_initialized():
        return Mesh(grid, rank)
    # new_group is collective over the whole group: every rank makes every
    # subgroup, member or not, in one order
    groups = {"mesh": (dist.group.WORLD if use == world
                       else dist.new_group(grid.ravel().tolist()))}
    for d in range(n_data):
        group = dist.new_group(grid[d].tolist())
        if rank in grid[d]:
            groups[MODEL_AXIS] = group
    for m in range(n_model):
        group = dist.new_group(grid[:, m].tolist())
        if rank in grid[:, m]:
            groups[DATA_AXIS] = group
    return Mesh(grid, rank, groups)


class Sharding(NamedTuple):
    """A placement: ``spec`` names the mesh axis each tensor dim splits over."""
    mesh: Mesh
    spec: Spec


def batch_sharding(mesh: Mesh) -> Sharding:
    """Shard the leading (batch) axis over the data axis."""
    return Sharding(mesh, (DATA_AXIS,))


def replicated(mesh: Mesh) -> Sharding:
    return Sharding(mesh, ())


def _spec_for_param(path: Tuple[str, ...], shape: Tuple[int, ...], n_model: int) -> Spec:
    """The JAX package's tensor-parallel rule, on a flax path and shape.

    Column-parallel (shard output dim): q/k/v projections, FF up-proj.
    Row-parallel (shard input dim): attention out-proj, FF down-proj.
    Everything else (convs, norms, embeddings, biases) replicates.
    """
    if n_model <= 1:
        return ()
    names = [p.lower() for p in path]
    joined = "/".join(names)
    if names[-1] != "kernel" or len(shape) != 2:
        return ()

    def divisible(dim):
        return shape[dim] % n_model == 0

    if any(k in joined for k in ("q_linear", "k_linear", "v_linear")):
        return (None, MODEL_AXIS) if divisible(1) else ()
    if "out_linear" in joined:
        return (MODEL_AXIS, None) if divisible(0) else ()
    if "linear0" in joined:  # FF up
        return (None, MODEL_AXIS) if divisible(1) else ()
    if "linear1" in joined:  # FF down
        return (MODEL_AXIS, None) if divisible(0) else ()
    return ()


def param_shardings(model: torch.nn.Module, network: str, mesh: Mesh) -> Dict[str, Spec]:
    """Each parameter's name -> its spec over the torch tensor's dims: the
    JAX rule's spec for the flax leaf the bridge routes it to
    (``utils/convert.py::param_routes``), carried through the route's layout
    transform (a Linear's [out, in] weight is the flax kernel [in, out]
    transposed)."""
    from p4fr_tpu_torch.utils.convert import param_routes

    n_model = mesh.shape[MODEL_AXIS]
    params = dict(model.named_parameters())
    specs = {}
    for name, (path, forward, _) in param_routes(network, params.items()).items():
        flax_shape = forward(np.empty(tuple(params[name].shape), np.bool_)).shape
        spec = _spec_for_param(tuple(path.split("/")), flax_shape, n_model)
        specs[name] = spec[::-1]  # only 2-D kernels shard, and their routes transpose
    return specs


def shard_batch(mesh: Mesh, *tensors):
    """This rank's rows of each batch tensor (dim 0 split evenly over the
    data axis, in rank order)."""
    n_data = mesh.shape[DATA_AXIS]
    d = mesh.coords[0] if mesh.coords is not None else 0
    out = []
    for t in tensors:
        if t.shape[0] % n_data:
            raise ValueError(f"batch of {t.shape[0]} rows does not split over "
                             f"{n_data} data ranks")
        out.append(t.chunk(n_data)[d] if n_data > 1 else t)
    return tuple(out) if len(out) > 1 else out[0]


def gather_rows(mesh: Mesh, tensor: torch.Tensor) -> torch.Tensor:
    """The data axis's rows of ``tensor`` [b, ...], concatenated in rank
    order (input order after ``shard_batch``), on the host: every rank gets
    them all. Gloo gathers host tensors; NCCL the card's."""
    if mesh.data_group is None:
        return tensor.cpu()
    if dist.get_backend(mesh.data_group) != "nccl":
        tensor = tensor.cpu()
    parts = [torch.empty_like(tensor) for _ in range(mesh.shape[DATA_AXIS])]
    dist.all_gather(parts, tensor.contiguous(), group=mesh.data_group)
    return torch.cat(parts).cpu()


def init_distributed(device: str = "cuda") -> torch.device:
    """Join the process group torchrun describes in the environment
    (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``/``PORT``), or
    start a group of one rank in this process; -> this rank's device.
    ``device="cuda"``: NCCL, one card per rank (``cuda:LOCAL_RANK``);
    raises where the host has more ranks than cards. ``"cpu"``: gloo."""
    if dist.is_initialized():
        raise RuntimeError("init_distributed: a process group is already running")
    if device == "cuda":
        local_world = int(os.environ.get("LOCAL_WORLD_SIZE", "1"))
        cards = torch.cuda.device_count()
        if local_world > cards:
            raise ValueError(f"NCCL runs one card per rank: {local_world} ranks on "
                             f"this host, {cards} card(s)")
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
        torch.cuda.set_device(dev)
        backend = "nccl"
    elif device == "cpu":
        dev, backend = torch.device("cpu"), "gloo"
    else:
        raise ValueError(f"device {device!r}")
    if "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend)
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)
    return dev
