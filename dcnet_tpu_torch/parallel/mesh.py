"""Data and tensor parallelism in PyTorch's idiom: the port of
`dcnet_tpu/parallel/mesh.py`.

The JAX package jits its train step over a 1-D `'data'` mesh: the batch
sharded on it, the state replicated, XLA's all-reduces for the gradient and
for the train-mode BatchNorm's moments (they are the global batch's). Here
the same step is one process per card: `torch.distributed` with NCCL on
cards and gloo on the CPU, `DistributedDataParallel` for the gradient mean,
each training process reading its rows of every global batch
(`batch_iterator(batch_shards, batch_shard)`: the rows the JAX mesh places
on its device, the same step count on every rank), each evaluating
process its interleaved share of the clips (`batch_iterator(num_shards,
shard_index)`, the `DistributedSampler` analog), and the cross-batch parts
of the step made global by hand:

- `bn_group` gives `models.heads.bn_train` the group whose count, sum and
  sum of squares it all-reduces (`all_reduce_sum`, whose backward is the
  matching all-reduce), so BatchNorm normalises with the global batch's
  moments and moves the running statistics identically on every rank, as
  the JAX step does;
- `global_flip` is the flip over the global batch, the concatenation of
  the ranks' batches, that the rank loss and the reversed-phrase scores
  pair samples with.

Every loss of the step is a mean over equal local batches, so DDP's
gradient mean is the gradient of the global batch's loss.

Processes: `torchrun` sets RANK / WORLD_SIZE / LOCAL_RANK (and
MASTER_ADDR / MASTER_PORT) and each process joins through `env://`; a CLI
asked for N processes without it (`--devices N`) is rank 0 itself and
spawns ranks 1..N-1 (`launch`), which join through a `file://` store in a
temporary directory (no port). `init_distributed` with a world of one
makes a group of one (the DDP path on one card).

The 2-D mesh. `make_mesh(n_data, n_model)` lays the processes out as the
JAX package's `Mesh(devices.reshape(n_data, n_model), ("data", "model"))`
(rank = data index * n_model + model index) and makes it the current mesh:
a `data` group per model index and a `model` group per data index. The
batch goes over `data` and everything above reduces over it (the DDP
gradient mean, the BatchNorm moments, the global flip, the metric means);
the ranks of one model group hold the same rows and split the
co-attention's query rows between them (`ops.coattention`'s `tp_shard`,
`cfg.tp_internals`) through two collectives of their own: `gather_rows`
(the windows all-gathered; its backward takes this rank's rows of the
gradient, which is replicated over the model group, so a sum there would
scale it by n_model) and `all_reduce_sum` (K3's partial dkv). Without a
mesh the data axis is the whole world and there is no model axis. Only
all_gather, all_reduce and broadcast are used: gloo (CPU tensors, and CUDA
tensors of ranks sharing one card) and NCCL both have them.
"""

from __future__ import annotations

import dataclasses
import os
import tempfile
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

_ENV = ("RANK", "WORLD_SIZE")
_INIT = "DCNET_DIST_INIT"       # the init method a spawned rank joins through


def world() -> Tuple[int, int]:
    """(world size, rank): (1, 0) without a process group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def launched() -> bool:
    """Whether this process is one rank of a launch (torchrun's, or
    `launch`'s): the environment names its rank and world size."""
    return all(k in os.environ for k in _ENV)


def local_rank() -> int:
    return int(os.environ.get("LOCAL_RANK", os.environ.get("RANK", "0")))


def init_distributed(device: torch.device, world_size: Optional[int] = None,
                     rank: Optional[int] = None,
                     init_method: Optional[str] = None,
                     backend: Optional[str] = None) -> Tuple[int, int]:
    """Join the default process group, NCCL for a CUDA `device` and gloo
    for the CPU (or `backend`: gloo for ranks that share a card). Without
    arguments the environment gives the rank, the world size and the
    rendezvous (torchrun's `env://`, or `launch`'s `file://` store); a world
    of one without either makes a group of one on a `file://` store of its
    own. Returns (world size, rank)."""
    if dist.is_initialized():
        return world()
    if world_size is None:
        world_size = int(os.environ.get("WORLD_SIZE", "1"))
        rank = int(os.environ.get("RANK", "0"))
        init_method = init_method or os.environ.get(_INIT) or (
            "env://" if "MASTER_ADDR" in os.environ else None)
    if init_method is None:
        if world_size != 1:
            raise ValueError(f"a world of {world_size} processes needs an init method "
                             f"(torchrun's environment or launch())")
        init_method = "file://" + os.path.join(tempfile.mkdtemp(prefix="dcnet_pg_"),
                                               "store")
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    kw = {"device_id": device} if backend == "nccl" else {}
    dist.init_process_group(backend, init_method=init_method, world_size=world_size,
                            rank=rank, **kw)
    return world()


def shutdown() -> None:
    clear_mesh()
    if dist.is_initialized():
        dist.destroy_process_group()


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The mesh's shape, this process's index on the data axis, and its
    data and model groups (None in a world without a process group)."""

    n_data: int
    n_model: int
    data_rank: int
    data_group: Any = None
    model_group: Any = None


# The current mesh: the implicit context that `bn_group`, DDP, the flip and
# the co-attention's `tp_shard` read deep inside the model, as the JAX
# package's `with mesh:` is, beside torch.distributed's own default group.
_MESH: Optional[Mesh] = None


def make_mesh(n_data: Optional[int] = None, n_model: int = 1) -> Mesh:
    """The (data, model) mesh over the current world, made current:
    n_data defaults to world // n_model, as the JAX package's; n_data *
    n_model must be the world. Every rank calls it (it makes the groups)."""
    size, rank = world()
    n_data = size // n_model if n_data is None else n_data
    if n_model < 1 or n_data < 1 or n_data * n_model != size:
        raise ValueError(f"a ({n_data}, {n_model}) mesh needs a world of "
                         f"{n_data * n_model} processes, this one has {size}")
    groups = {"data": None, "model": None}
    if dist.is_available() and dist.is_initialized():
        grid = [[d * n_model + m for m in range(n_model)] for d in range(n_data)]
        for d in range(n_data):          # every rank makes every group, in order
            g = dist.new_group(grid[d])
            if rank in grid[d]:
                groups["model"] = g
        for m in range(n_model):
            ranks = [grid[d][m] for d in range(n_data)]
            g = dist.new_group(ranks)
            if rank in ranks:
                groups["data"] = g
    global _MESH
    _MESH = Mesh(n_data, n_model, rank // n_model, groups["data"], groups["model"])
    return _MESH


def clear_mesh() -> None:
    global _MESH
    _MESH = None


def data_world() -> Tuple[int, int]:
    """(size, rank) of this process's data group: the mesh's data axis, or
    the whole world without a mesh."""
    if _MESH is not None:
        return _MESH.n_data, _MESH.data_rank
    return world()


def data_group():
    """The group the data axis reduces over: the mesh's data group, or the
    default group without a mesh."""
    return _MESH.data_group if _MESH is not None else dist.group.WORLD


def model_group():
    """The model group of a mesh whose model axis has more than one rank;
    None otherwise (the unsharded co-attention)."""
    if _MESH is None or _MESH.n_model == 1:
        return None
    return _MESH.model_group


def row_window(p: int, n: int, r: int) -> Tuple[int, int]:
    """(row0, rows) of rank r's window of P rows split over n ranks: P // n
    rows each, the first P % n ranks one more."""
    base, extra = divmod(p, n)
    return r * base + min(r, extra), base + (r < extra)


def group_window(p: int, group) -> Tuple[int, int]:
    """This rank's `row_window` of P rows over `group`."""
    return row_window(p, dist.get_world_size(group), dist.get_rank(group))


def all_gather_rows(x: torch.Tensor, group, p: int) -> torch.Tensor:
    """The ranks' row windows (`row_window` of P over `group`), each rank's
    x its own (B, rows, ...), concatenated along dim 1 in rank order: the
    whole (B, P, ...) on every rank. Windows are padded to the largest for
    the all-gather."""
    n = dist.get_world_size(group)
    most = -(-p // n)
    pad = x
    if x.shape[1] < most:
        pad = torch.cat([x, x.new_zeros((x.shape[0], most - x.shape[1], *x.shape[2:]))],
                        dim=1)
    parts = [torch.empty_like(pad) for _ in range(n)]
    dist.all_gather(parts, pad.contiguous(), group=group)
    return torch.cat([parts[i][:, :row_window(p, n, i)[1]] for i in range(n)], dim=1)


def _gather_rows_grad(g: torch.Tensor, group, p: int) -> torch.Tensor:
    """The gradient of `gather_rows`' input: this rank's rows of the output
    gradient, which every rank of the model group holds whole and equal."""
    row0, rows = group_window(p, group)
    return g[:, row0:row0 + rows].contiguous()


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, p):
        ctx.group, ctx.p = group, p
        return all_gather_rows(x, group, p)

    @staticmethod
    def backward(ctx, g):
        return _gather_rows_grad(g, ctx.group, ctx.p), None, None


def gather_rows(x: torch.Tensor, group, p: int) -> torch.Tensor:
    """`all_gather_rows`, differentiable: the gradient of this rank's
    window is its rows of the (replicated) output gradient."""
    return _GatherRows.apply(x, group, p)


def shard_args() -> Dict[str, int]:
    """`batch_iterator`'s `num_shards` and `shard_index` for this rank:
    its interleaved share of the clips (an eval, which runs no collective
    per batch), over the data axis."""
    size, rank = data_world()
    return {"num_shards": size, "shard_index": rank}


def batch_slice_args() -> Dict[str, int]:
    """`batch_iterator`'s `batch_shards` and `batch_shard` for this rank:
    its rows of every global batch (a train or validate epoch, whose steps
    run collectives and so must be as many on every rank), over the data
    axis."""
    size, rank = data_world()
    return {"batch_shards": size, "batch_shard": rank}


def any_rank(flag: bool) -> bool:
    """Whether `flag` is set on any rank (an all-reduce MAX): a decision,
    such as a preemption stop, that every rank must take at the same step."""
    if world()[0] == 1:
        return flag
    dev = (torch.device("cuda", torch.cuda.current_device())
           if dist.get_backend() == "nccl" else torch.device("cpu"))
    t = torch.tensor([int(flag)], dtype=torch.int32, device=dev)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return bool(t.item())


def wrap_ddp(model: torch.nn.Module, device: torch.device
             ) -> torch.nn.parallel.DistributedDataParallel:
    """`model` under DistributedDataParallel: the gradient mean over the
    data axis (the ranks of a model group hold the same gradient already).
    Buffers are not broadcast at each forward (the BatchNorm statistics
    move identically everywhere); a parameter the loss does not reach (the
    cross-modal map's smoothing conv, whose output only picks indices) is
    allowed."""
    ids = [device.index] if device.type == "cuda" else None
    return torch.nn.parallel.DistributedDataParallel(
        model, device_ids=ids, broadcast_buffers=False, find_unused_parameters=True,
        process_group=data_group())


@torch.no_grad()
def replicate_state(tensors: Sequence[torch.Tensor], src: int = 0) -> None:
    """Broadcast `tensors` in place from rank `src` (a resumed model's
    parameters and buffers, the optimizer's state)."""
    if world()[0] > 1:
        for t in tensors:
            dist.broadcast(t, src)


def model_and_optimizer_tensors(model: torch.nn.Module,
                                optimizer: Optional[torch.optim.Optimizer] = None
                                ) -> List[torch.Tensor]:
    """The tensors a resume replicates: parameters, buffers and the
    optimizer's per-parameter state, in an order every rank shares."""
    out = [p.data for p in model.parameters()] + list(model.buffers())
    if optimizer is not None:
        for group in optimizer.param_groups:
            for p in group["params"]:
                for v in optimizer.state.get(p, {}).values():
                    if torch.is_tensor(v) and v.dim() > 0:
                        out.append(v)
    return out


class _AllReduceSum(torch.autograd.Function):
    """Sum over the ranks; the gradient of every rank's input is the sum of
    the ranks' output gradients."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def all_reduce_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    """Differentiable sum of x over the ranks of `group`."""
    return _AllReduceSum.apply(x, group)


def bn_group(bn: torch.nn.Module):
    """The process group whose moments `bn_train` merges for `bn`: the data
    group of more than one process; None otherwise (the single-process code
    path)."""
    if data_world()[0] == 1:
        return None
    return data_group()


def _mirror(x: torch.Tensor) -> torch.Tensor:
    """This rank's rows of flip(concat of every data rank's x) along dim 0:
    the flipped rows of the mirror rank's x (equal batches on every rank)."""
    size, rank = data_world()
    parts = [torch.empty_like(x) for _ in range(size)]
    dist.all_gather(parts, x.contiguous(), group=data_group())
    return torch.flip(parts[size - 1 - rank], dims=[0])


class _GlobalFlip(torch.autograd.Function):
    """The global flip; its gradient is the same permutation of the
    gradients."""

    @staticmethod
    def forward(ctx, x):
        return _mirror(x)

    @staticmethod
    def backward(ctx, g):
        return _mirror(g)


def global_flip(x: torch.Tensor) -> torch.Tensor:
    """torch.flip(x, [0]) over the global batch (the data ranks' batches
    concatenated in rank order): this rank's rows of it. Without a data
    group of more than one process it is torch.flip."""
    if data_world()[0] == 1:
        return torch.flip(x, dims=[0])
    if x.requires_grad and torch.is_grad_enabled():
        return _GlobalFlip.apply(x)
    return _mirror(x)


def mean_over_ranks(values: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Each 0-dim metric averaged over the data ranks (equal batches), for
    the log."""
    size = data_world()[0]
    if size == 1:
        return values
    keys = sorted(values)
    stacked = torch.stack([values[k].detach().float() for k in keys])
    dist.all_reduce(stacked, group=data_group())
    return {k: v for k, v in zip(keys, stacked / size)}


def gather_to_rank0(obj) -> Optional[list]:
    """Every rank's picklable `obj`, in rank order, on rank 0 (None on the
    others)."""
    size, rank = world()
    if size == 1:
        return [obj]
    out = [None] * size if rank == 0 else None
    dist.gather_object(obj, out, dst=0)
    return out


def barrier() -> None:
    if world()[0] > 1:
        dist.barrier()


def _spawned(i: int, fn: Callable, argv: list, size: int, init: str) -> None:
    """Rank i + 1 of `launch`: its environment, then the CLI's `main`."""
    os.environ.update({"RANK": str(i + 1), "WORLD_SIZE": str(size),
                       "LOCAL_RANK": str(i + 1), _INIT: init})
    try:
        fn(argv)
    finally:
        shutdown()


def launch(fn: Callable, argv: list, nprocs: int):
    """Run the CLI `fn(argv)` as `nprocs` processes: this process is rank
    0 and spawns ranks 1..nprocs-1 (`torch.multiprocessing`, spawn), all
    joining through a `file://` store. Returns rank 0's result; raises if
    a rank failed."""
    init = "file://" + os.path.join(tempfile.mkdtemp(prefix="dcnet_pg_"), "store")
    ctx = mp.start_processes(_spawned, args=(fn, argv, nprocs, init),
                             nprocs=nprocs - 1, join=False, start_method="spawn")
    saved = {k: os.environ.get(k) for k in (*_ENV, "LOCAL_RANK", _INIT)}
    os.environ.update({"RANK": "0", "WORLD_SIZE": str(nprocs), "LOCAL_RANK": "0",
                       _INIT: init})
    try:
        result = fn(argv)
    except BaseException:
        for proc in ctx.processes:  # they would wait on rank 0's collectives
            proc.terminate()
        raise
    finally:
        shutdown()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    while not ctx.join():
        pass
    return result
