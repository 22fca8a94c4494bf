"""Env-batch data parallelism over torch.distributed (port of
booster_gym_tpu/parallel/mesh.py).

The JAX package shards the env batch over a 1-D ("dp",) device mesh and
lets XLA insert the collectives, or psums them by hand around its Pallas
calls.  Here every rank is a process of its own with its own device: it
holds rows [lo, hi) of the env batch (Group), steps them with its own
kernel launches, and meets the other ranks only in the collectives the
callers place where the JAX package reduces over "dp" (all_reduce,
all_gather).  Parameters and optimizer state are replicated: every rank
applies the same all-reduced gradient.

Random draws follow the JAX semantics, where a sharded jax.random draw
equals the unsharded one: every rank seeds the same generator and draws at
the global batch shape, keeping its rows (Group.draw).  At world size 1
the draws and every other call are those of a single-process run.

The launcher: launch() starts the ranks on this host with the environment
torchrun gives them (RANK, WORLD_SIZE, LOCAL_RANK, LOCAL_WORLD_SIZE,
MASTER_ADDR, MASTER_PORT); initialize_distributed() reads it.
"""

import dataclasses
import datetime
import multiprocessing
import multiprocessing.connection
import os
import socket
import time

import torch
import torch.distributed as dist

# torchrun's variables that say a process group is configured
_DIST_ENV_SIGNALS = ("WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT")
_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


@dataclasses.dataclass(frozen=True)
class Group:
    """This process's share of the env batch: `world` ranks over
    `backend` (None at world size 1), this one `rank`, on `device`.  The
    global batch of `num_envs` rows is cut into `world` equal slices; this
    rank holds rows [lo, hi)."""

    num_envs: int
    device: torch.device
    world: int = 1
    rank: int = 0
    backend: str = None

    def __post_init__(self):
        if not 0 <= self.rank < self.world:
            raise ValueError(f"rank {self.rank} is outside a world of {self.world}")
        if self.num_envs % self.world:
            raise ValueError(f"num_envs={self.num_envs} does not divide into {self.world} ranks")
        if self.world > 1 and self.backend is None:
            raise ValueError("a world of several ranks needs its backend")

    @property
    def local_envs(self):
        return self.num_envs // self.world

    @property
    def lo(self):
        return self.rank * self.local_envs

    @property
    def hi(self):
        return self.lo + self.local_envs

    def rows(self, x):
        """This rank's rows [lo, hi) of x [num_envs, ...]."""
        return x if self.world == 1 else x[self.lo:self.hi]

    def shard_rows(self, tree, batch_size):
        """shard_batch_pytree's counterpart: every tensor leaf whose leading
        dim is batch_size (the global batch) keeps this rank's rows, the
        rest is left as it is.  Leaves sit in dataclasses, dicts, lists and
        tuples."""
        if isinstance(tree, torch.Tensor):
            if tree.ndim >= 1 and tree.shape[0] == batch_size:
                return tree[self.lo:self.hi] if self.world > 1 else tree
            return tree
        if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
            return dataclasses.replace(tree, **{
                f.name: self.shard_rows(getattr(tree, f.name), batch_size)
                for f in dataclasses.fields(tree) if f.init})
        if isinstance(tree, dict):
            return type(tree)((k, self.shard_rows(v, batch_size)) for k, v in tree.items())
        if isinstance(tree, (list, tuple)):
            out = [self.shard_rows(v, batch_size) for v in tree]
            return type(tree)(*out) if hasattr(tree, "_fields") else type(tree)(out)
        return tree

    def draw(self, fn, gen, shape, *args, device=None):
        """fn(*args, shape, generator=gen, device=device) drawn at the
        global batch (shape[0] replaced by num_envs), this rank's rows kept:
        the draw a single process makes, sliced.  shape[0] must be the
        local batch.  At world size 1, exactly fn(*args, shape, ...)."""
        device = self.device if device is None else device
        shape = tuple(shape)
        if self.world == 1:
            return fn(*args, shape, generator=gen, device=device)
        if shape[0] != self.local_envs:
            raise ValueError(f"a draw of shape {shape} does not lead with the "
                             f"{self.local_envs} local envs")
        full = fn(*args, (self.num_envs, *shape[1:]), generator=gen, device=device)
        return full[self.lo:self.hi]

    # -- collectives: every rank calls each, in the same order ------------
    def all_reduce(self, x, op="sum"):
        """x reduced over the ranks (op "sum" or "max"), in place; x itself
        at world size 1."""
        if self.world > 1:
            if not x.is_contiguous():
                raise ValueError("all_reduce takes a contiguous tensor")
            dist.all_reduce(x, op=_OPS[op])
        return x

    def all_gather(self, x):
        """The ranks' x [n, ...] stacked in rank order along dim 0 ([world
        * n, ...]); x itself at world size 1."""
        if self.world == 1:
            return x
        parts = [torch.empty_like(x) for _ in range(self.world)]
        dist.all_gather(parts, x.contiguous())
        return torch.cat(parts)

    def broadcast(self, x, src=0):
        """Rank src's x on every rank, in place; x itself at world size 1."""
        if self.world > 1:
            dist.broadcast(x, src)
        return x

    def barrier(self):
        if self.world > 1:
            dist.barrier()


def largest_world(n_devices, num_envs):
    """The JAX runner's mesh size (Runner._build_mesh): the largest count
    of at most n_devices that divides num_envs, at least 1."""
    n = max(int(n_devices), 1)
    while n > 1 and num_envs % n:
        n -= 1
    return n


def configured():
    """Whether the environment configures a process group (torchrun's
    variables, or launch()'s)."""
    return any(os.environ.get(k) for k in _DIST_ENV_SIGNALS)


def initialize_distributed(backend, init_method=None, world_size=None, rank=None,
                           timeout_s=None):
    """Join the process group: before anything runs on the device.

    Returns True when a process group was initialized.  With nothing
    configured (no argument, none of torchrun's variables) it is a quiet
    no-op that returns False.  A configured but broken group raises: a rank
    outside the world, a missing variable, an unreachable store (after
    timeout_s, default torch's).  It never falls back to one rank.
    backend is explicit: "nccl" when each rank has a card of its own,
    "gloo" on the CPU and for ranks that share a card (default_backend)."""
    explicit = init_method is not None or world_size is not None or rank is not None
    if not (explicit or configured()):
        return False
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend must be nccl or gloo, got {backend!r}")
    world = int(os.environ["WORLD_SIZE"] if world_size is None else world_size)
    rank = int(os.environ["RANK"] if rank is None else rank)
    if not 0 <= rank < world:
        raise ValueError(f"rank {rank} is outside a world of {world}")
    kw = {} if timeout_s is None else {"timeout": datetime.timedelta(seconds=timeout_s)}
    dist.init_process_group(backend, init_method=init_method or "env://", world_size=world,
                            rank=rank, **kw)
    return True


def default_backend(device):
    """nccl when each rank on this host has a card of its own, gloo on the
    CPU and where ranks share a card (NCCL refuses two ranks on one)."""
    if torch.device(device).type != "cuda":
        return "gloo"
    local = int(os.environ.get("LOCAL_WORLD_SIZE", os.environ.get("WORLD_SIZE", "1")))
    return "nccl" if local <= torch.cuda.device_count() else "gloo"


def rank_device(device):
    """The device of this rank: cuda:(LOCAL_RANK % device_count), made
    current, for a CUDA device; the CPU as it is."""
    device = torch.device(device)
    if device.type != "cuda":
        return device
    device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0"))
                          % torch.cuda.device_count())
    torch.cuda.set_device(device)
    return device


def process_group(num_envs, device):
    """The Group of an initialized process group's rank."""
    return Group(num_envs, device, world=dist.get_world_size(), rank=dist.get_rank(),
                 backend=dist.get_backend())


def free_port():
    """A TCP port on localhost that was free a moment ago."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_entry(fn, rank, world, port, args):
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                      LOCAL_WORLD_SIZE=str(world), MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=str(port))
    try:
        fn(*args)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def launch(fn, world, args=(), timeout_s=None):
    """Run fn(*args) in `world` new processes (spawned), ranks 0 to world
    - 1 of one group on this host, each with torchrun's environment.
    Returns when every rank has exited 0.  Raises once a rank exits
    non-zero or, with timeout_s, when a rank still runs after it; every
    rank still running is stopped first (the others would wait in a
    collective for ever)."""
    ctx = multiprocessing.get_context("spawn")
    port = free_port()
    procs = [ctx.Process(target=_rank_entry, args=(fn, r, world, port, args))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = None if timeout_s is None else time.monotonic() + timeout_s
    try:
        while any(p.exitcode is None for p in procs):
            if any(p.exitcode not in (None, 0) for p in procs):
                break
            left = None if deadline is None else deadline - time.monotonic()
            if left is not None and left <= 0:
                break
            # a rank's sentinel can stay unready after it exits (a process it
            # started may hold the pipe), so its exit code is polled each second
            multiprocessing.connection.wait([p.sentinel for p in procs if p.exitcode is None],
                                            timeout=1.0 if left is None else min(left, 1.0))
    finally:
        for p in procs:
            if p.exitcode is None:
                p.terminate()
                p.join(10)
                if p.exitcode is None:
                    p.kill()
            p.join()
    codes = [p.exitcode for p in procs]
    if any(codes):
        hung = " (stopped after the timeout)" if deadline and time.monotonic() >= deadline else ""
        raise RuntimeError(f"data-parallel ranks exited with {codes}{hung}")
