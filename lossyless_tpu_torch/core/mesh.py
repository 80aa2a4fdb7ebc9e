"""Devices, process groups and the data-parallel collectives.

Counterpart of `lossyless_tpu/core/mesh.py`. JAX runs one program over a
named 1-D "data" mesh and lets XLA insert the collectives (the gradient
all-reduce, the contrastive all-gather, the global BatchNorm statistics).
The port has two forms of data parallelism:

* one process driving several devices, for inference without collectives
  (the hub encoder, `hub/compressor.py`): `make_mesh` gives it an ordered
  device list, which may repeat a device (`["cpu"] * 4` in the CPU tests,
  two replicas on one card);
* one process a rank under `torch.distributed` for training (NCCL on the
  card, gloo on the CPU): `init_distributed` joins the group that torchrun
  (or the pipeline's own spawn) describes; every rank holds the whole
  model and trains on its rows of the global batch (`shard_batch`).

A training step runs inside `data_parallel(rank, world, rows)`. There the
step's random draws are the global batch's (`global_draw`: each rank draws
what one device would and keeps its rows, as JAX draws one global array and
shards it), BatchNorm sums its statistics over the ranks
(`all_reduce_sum`), the contrastive loss gathers both views' rows from every
rank (`all_gather_rows`), the gradients are averaged (`average_gradients`)
and the logs are the global batch's (`reduce_logs`). Outside it nothing
communicates, so rank 0 can evaluate alone.

JAX's `respect_platform_env` (re-asserting JAX_PLATFORMS) has no
counterpart: the port's entry points take their device explicitly and
`core/device.py::resolve_device` refuses to fall back to the CPU.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import socket

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class Mesh:
    """An ordered device list: shard i of a batch runs on `devices[i]`."""

    devices: tuple

    @property
    def size(self) -> int:
        return len(self.devices)


def make_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    """A mesh of `devices` (names or `torch.device`s, repeats allowed), or
    of the first `n_devices` visible CUDA devices; None or 0 takes every
    visible one. Asking for more than are visible raises."""
    if devices is None:
        avail = torch.cuda.device_count()
        n = avail if n_devices in (None, 0, -1) else n_devices
        if n < 1 or n > avail:
            raise ValueError(f"n_devices={n} but {avail} CUDA devices are "
                             f"visible (pass devices=[...] for others)")
        devices = [torch.device("cuda", i) for i in range(n)]
    elif n_devices not in (None, 0, -1):
        devices = list(devices)[:n_devices]
    devices = tuple(torch.device(d) for d in devices)
    if not devices:
        raise ValueError("a mesh needs at least one device")
    return Mesh(devices)


def visible_devices(device: torch.device) -> tuple[int, int]:
    """(the ranks `trainer.n_devices` 0 takes, the most it may ask for) on
    `device`'s type: every visible CUDA device for both; on the CPU one
    device, as JAX counts one CPU device, and at most its cores (a gloo
    rank is a process)."""
    if device.type == "cuda":
        n = torch.cuda.device_count()
        return n, n
    return 1, os.cpu_count() or 1


def free_port() -> int:
    """A free TCP port on localhost, for a process group's rendezvous."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def init_distributed(device=None) -> bool:
    """Join the process group that torchrun's environment describes
    (`RANK`, `WORLD_SIZE`, `LOCAL_RANK`, `MASTER_ADDR`, `MASTER_PORT`), as
    JAX's reads `JAX_COORDINATOR_ADDRESS`. NCCL when the ranks run on CUDA
    (`device`, else CUDA when it is available), each on the card
    `LOCAL_RANK`; gloo on the CPU. A no-op without the variables, and when
    a group is already up. Returns whether a group is active. Run it
    before anything touches the device."""
    if dist.is_initialized():
        return True
    env = os.environ
    if "RANK" not in env or "WORLD_SIZE" not in env:
        return False
    rank, world = int(env["RANK"]), int(env["WORLD_SIZE"])
    cuda = (torch.device(device).type == "cuda" if device is not None
            else torch.cuda.is_available())
    kwargs = {}
    if cuda:
        local = torch.device("cuda", int(env.get("LOCAL_RANK", rank)))
        torch.cuda.set_device(local)
        kwargs["device_id"] = local
    dist.init_process_group(
        "nccl" if cuda else "gloo",
        init_method=f"tcp://{env.get('MASTER_ADDR', 'localhost')}:"
                    f"{env.get('MASTER_PORT', '29500')}",
        rank=rank, world_size=world, **kwargs)
    return True


def in_group() -> bool:
    """Whether this process is a rank of a process group."""
    return dist.is_available() and dist.is_initialized()


def rank_world() -> tuple[int, int]:
    """(rank, world size) of the process group, (0, 1) without one."""
    if in_group():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def shard_batch(batch, rank: int, world: int):
    """This rank's rows of a global batch (a tensor, an array or a
    tuple / list / dict of them): rows [rank * b, (rank + 1) * b) of each,
    b = B / world. The batch must divide evenly."""
    if isinstance(batch, dict):
        return {k: shard_batch(v, rank, world) for k, v in batch.items()}
    if isinstance(batch, (tuple, list)):
        return type(batch)(shard_batch(v, rank, world) for v in batch)
    if batch is None or world == 1:
        return batch
    n = batch.shape[0]
    if n % world:
        raise ValueError(f"a batch of {n} rows does not split over "
                         f"{world} ranks")
    b = n // world
    return batch[rank * b:(rank + 1) * b]


# (rank, world, rows a rank, views) inside `data_parallel` in a process
# group or with world > 1
_ACTIVE: tuple[int, int, int, int] | None = None


@contextlib.contextmanager
def data_parallel(rank: int, world: int, rows: int):
    """Run a training step as rank `rank` of `world`, on `rows` rows of
    the global batch (module docstring). Inside a process group it is on
    for a world of one too, whose collectives are identities: one rank
    runs the data-parallel step as W ranks do. Without a group and with
    world 1 it is off."""
    global _ACTIVE
    saved = _ACTIVE
    on = world > 1 or in_group()
    if on and rows < 1:
        raise ValueError("a data-parallel step needs the rows a rank "
                         "trains on")
    _ACTIVE = (rank, world, rows, 1) if on else None
    try:
        yield
    finally:
        _ACTIVE = saved


@contextlib.contextmanager
def views(k: int):
    """Inside `data_parallel`: the step's tensors are k views of the batch
    concatenated (the two-view step's `concat_views`), for `global_draw`."""
    global _ACTIVE
    saved = _ACTIVE
    if _ACTIVE is not None:
        _ACTIVE = _ACTIVE[:3] + (k,)
    try:
        yield
    finally:
        _ACTIVE = saved


def active() -> tuple[int, int, int, int] | None:
    """(rank, world, rows, views) of the enclosing `data_parallel`, else
    None."""
    return _ACTIVE


def global_draw(draw, shape):
    """`draw(shape)` as one device draws it for the global batch, this
    rank's rows kept. A draw's rows are `views` blocks (1, or the two-view
    step's 2), each the rank's images in order, each image the same number
    of rows (one, or a spatial latent's folded positions): the global draw
    is `views` blocks of every rank's rows, and the rank keeps its part of
    each block."""
    if _ACTIVE is None:
        return draw(shape)
    rank, world, rows, k = _ACTIVE
    n, rest = shape[0], tuple(shape[1:])
    if n % (k * rows):
        raise ValueError(f"a draw of {n} rows is not {k} view(s) of the "
                         f"{rows} images a rank trains on")
    full = draw((world * n,) + rest)
    return full.reshape((k, world, n // k) + rest)[:, rank] \
        .reshape((n,) + rest)


class _AllReduceSum(torch.autograd.Function):
    """Sum over the ranks; its gradient is the sum of the ranks' gradients
    (every rank's loss reads the sum)."""

    @staticmethod
    def forward(ctx, t):
        t = t.clone()
        dist.all_reduce(t)
        return t

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g)
        return g


class _AllGatherRows(torch.autograd.Function):
    """Every rank's rows, in rank order (the reference's `GatherFromGpus`):
    the gradient of a rank's rows is the sum over the ranks of the
    gradients that their losses send them."""

    @staticmethod
    def forward(ctx, t):
        rank, world = rank_world()
        ctx.rows, ctx.rank = t.shape[0], rank
        parts = [torch.empty_like(t) for _ in range(world)]
        dist.all_gather(parts, t.contiguous())
        return torch.cat(parts)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g)
        return g[ctx.rank * ctx.rows:(ctx.rank + 1) * ctx.rows]


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """Differentiable sum of `t` over the ranks (inside `data_parallel`)."""
    return _AllReduceSum.apply(t)


def all_gather_rows(t: torch.Tensor) -> torch.Tensor:
    """Differentiable concatenation of every rank's `t`, in rank order."""
    return _AllGatherRows.apply(t)


def average_gradients(params) -> None:
    """Average the gradients over the ranks: one flat all-reduce a dtype
    (a parameter without a gradient contributes zeros)."""
    world = dist.get_world_size()
    params = [p for p in params if p.requires_grad]
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    by_dtype: dict = {}
    for p in params:
        by_dtype.setdefault(p.grad.dtype, []).append(p.grad)
    for grads in by_dtype.values():
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat)
        flat /= world
        i = 0
        for g in grads:
            g.copy_(flat[i:i + g.numel()].view_as(g))
            i += g.numel()


# logs that are a batch's extreme, not its mean
_LOG_OPS = {"zmin": dist.ReduceOp.MIN, "zmax": dist.ReduceOp.MAX}


def reduce_logs(logs: dict) -> dict:
    """A step's logs over the global batch: the ranks' equal shards make a
    batch mean the mean of their means (one all-reduce); `zmin` / `zmax`
    the minimum / maximum. Host numbers are the same on every rank."""
    world = dist.get_world_size()
    keys = [k for k, v in logs.items() if isinstance(v, torch.Tensor)]
    if not keys:
        return dict(logs)
    out = dict(logs)
    means = [k for k in keys if k not in _LOG_OPS]
    if means:
        flat = torch.stack([logs[k].detach().float().reshape(())
                            for k in means])
        dist.all_reduce(flat)
        flat /= world
        out.update(zip(means, flat.unbind()))
    for k in keys:
        if k in _LOG_OPS:
            v = logs[k].detach().float().clone()
            dist.all_reduce(v, op=_LOG_OPS[k])
            out[k] = v
    return out
