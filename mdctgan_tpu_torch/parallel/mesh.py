"""Data parallelism: the port of ``mdctgan_tpu/parallel/mesh.py``.

The JAX package trains one program over a mesh of devices: the batch is
sharded along its leading axis, the state is replicated, and XLA inserts the
gradient all-reduces.  Its claim (``tests/test_train_step.py::
test_dp_invariance_1_vs_8_devices``) is that a global batch split over
devices gives what the same batch gives on one device.  The port keeps that
claim in two forms:

* **Training: one process per card** (a "rank"), joined by
  ``torch.distributed``.  ``--gpu_ids a,b,...`` starts one rank per listed
  card of this host (``spawn``); ``--multihost`` joins a group that torchrun
  launched (``init_multihost``).  Each rank holds its rows of the global
  batch (``Ranks.host_rows``) and a full copy of the state (``replicate``).
  What the JAX program computes over the global batch, the port sums across
  ranks itself: the attention stack's BatchNorm statistics
  (``models/attention.py``), the losses' denominators
  (``models/losses.py``), the gradients and the reported metrics
  (``train/step.py``).  One process per card, because the bf16 step is
  host-bound: one process driving N cards would serialise N enqueues.
* **Serving: one process, one generator replica per device** of a
  ``Mesh`` (``api.replicate``, ``api.serve_segments``): each segment batch
  is split over the replicas and gathered on the first device, as the JAX
  package shards it over its mesh.

With one id and without ``--multihost`` no process group exists, and every
function of the port takes its single-card path (``ranks`` is None).

The JAX package's ``honor_jax_platforms_env``, ``set_default_matmul_precision``
and ``enable_compilation_cache`` have no counterpart here.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import queue as queue_mod
import signal
import socket
import threading
import time
import traceback
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from mdctgan_tpu_torch.device import resolve_device

# A collective or a rendezvous that waits longer than this fails: long enough
# for rank 0's eval and save, which the other ranks wait for at their next
# collective.
TIMEOUT = datetime.timedelta(seconds=600)
# The flat buffers of ``all_reduce_`` and ``replicate``: each collective
# costs the host ~0.1 ms on a step the host bounds, so few and large (the
# flagship's 428 MB of gradients in 2)
BUCKET_BYTES = 256 << 20


@dataclasses.dataclass(frozen=True)
class Mesh:
    """An ordered list of devices, one generator replica each (serving)."""

    devices: Tuple[torch.device, ...]

    @property
    def size(self) -> int:
        return len(self.devices)


def make_mesh(devices: Sequence) -> Mesh:
    """A ``Mesh`` over ``devices`` in their order (``"cpu"`` may repeat:
    replicas on the CPU); raises for an empty list, and for CUDA without
    CUDA."""
    devs = tuple(resolve_device(d) for d in devices)
    if not devs:
        raise ValueError("make_mesh: no device")
    return Mesh(devs)


@dataclasses.dataclass(frozen=True)
class Ranks:
    """This process's place in the process group: rank ``rank`` of
    ``world``, local rank ``local_rank`` of the ``local_world`` ranks on its
    host, computing on ``device``.  ``control`` is a gloo group of the same
    ranks for agreements made on the host (``any_rank``, ``barrier``),
    which never wait for the device."""

    rank: int
    world: int
    local_rank: int
    local_world: int
    device: torch.device
    control: Any = None

    @property
    def hosts(self) -> int:
        return self.world // self.local_world

    @property
    def is_main(self) -> bool:
        return self.rank == 0

    def host_rows(self, host_batch: int) -> slice:
        """This rank's rows of its host's batch: every rank of a host reads
        the same ``host_batch`` rows from one seeded stream and keeps its
        share, as the JAX package's one process per host shards its batch
        over its devices."""
        if host_batch % self.local_world:
            raise ValueError(f"batchSize {host_batch} not divisible by the "
                             f"{self.local_world} ranks of a host")
        n = host_batch // self.local_world
        return slice(self.local_rank * n, (self.local_rank + 1) * n)

    def global_rows(self, local_batch: int) -> Tuple[int, int]:
        """(this rank's first row, the rows of the global batch): rank r
        holds rows r*b .. (r+1)*b - 1, host after host, as torchrun numbers
        the ranks."""
        return self.rank * local_batch, self.world * local_batch


def put_global_batch(batch: Dict[str, torch.Tensor], ranks: Optional[Ranks]
                     ) -> Dict[str, torch.Tensor]:
    """This rank's rows of a host batch (every value (B, ...)); the batch
    itself without ranks."""
    if ranks is None:
        return batch
    rows = ranks.host_rows(next(iter(batch.values())).shape[0])
    return {k: v[rows] for k, v in batch.items()}


def free_port() -> int:
    """A TCP port of 127.0.0.1 that nothing listens on now."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _join(rank: int, world: int, local_rank: int, local_world: int, device: torch.device,
          init_method: str, backend: Optional[str] = None) -> Ranks:
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(device)
    dist.init_process_group(backend or ("nccl" if device.type == "cuda" else "gloo"),
                            init_method=init_method, rank=rank, world_size=world,
                            timeout=TIMEOUT)
    ranks = Ranks(rank, world, local_rank, local_world, device,
                  dist.new_group(backend="gloo", timeout=TIMEOUT))
    # bring up the transport now, while every rank stands at the same cheap
    # point, rather than at the first step's collective (as the JAX package's
    # ``sync_global_devices`` at the end of its ``init_multihost``)
    all_reduce_([torch.zeros(1, device=device)], ranks)
    barrier(ranks)
    return ranks


def init_multihost(device_type: str = "cuda", coordinator: Optional[str] = None) -> Ranks:
    """Join the process group that torchrun describes in the environment:
    ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK`` and ``LOCAL_WORLD_SIZE`` (one
    rank a host without the last two), at ``tcp://<coordinator>`` or else
    ``tcp://$MASTER_ADDR:$MASTER_PORT``; the counterpart of
    ``jax.distributed.initialize``, which finds the same from its cluster.
    The rank computes on ``cuda:<LOCAL_RANK>`` over NCCL, or with
    ``device_type="cpu"`` on the CPU over gloo."""
    env = os.environ
    missing = [k for k in ("RANK", "WORLD_SIZE") if k not in env]
    if not coordinator:
        if "MASTER_ADDR" in env and "MASTER_PORT" in env:
            coordinator = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
        else:
            missing.append("MASTER_ADDR/MASTER_PORT (or --coordinator_address)")
    if missing:
        raise ValueError(f"--multihost: {', '.join(missing)} unset; launch the ranks with "
                         "torchrun, or set RANK, WORLD_SIZE, LOCAL_RANK, LOCAL_WORLD_SIZE "
                         "and MASTER_ADDR/MASTER_PORT for each")
    rank, world = int(env["RANK"]), int(env["WORLD_SIZE"])
    local_rank = int(env.get("LOCAL_RANK", 0))
    local_world = int(env.get("LOCAL_WORLD_SIZE", 1))
    if world % local_world or not 0 <= local_rank < local_world:
        raise ValueError(f"--multihost: LOCAL_RANK {local_rank} of LOCAL_WORLD_SIZE "
                         f"{local_world} does not divide WORLD_SIZE {world}")
    device = resolve_device("cpu" if device_type == "cpu" else f"cuda:{local_rank}")
    if device.type == "cuda" and local_rank >= torch.cuda.device_count():
        raise ValueError(f"--multihost: LOCAL_RANK {local_rank} but this host has "
                         f"{torch.cuda.device_count()} CUDA device(s)")
    return _join(rank, world, local_rank, local_world, device, f"tcp://{coordinator}")


def _rank_main(fn, args, rank, world, device, init_method, backend, results):
    # the host's cores shared among the ranks, as torchrun's one thread a rank
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    try:
        ranks = _join(rank, world, rank, world, torch.device(device), init_method, backend)
        try:
            value = fn(ranks, *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, value))
    except Exception:
        results.put((rank, False, traceback.format_exc()))


def spawn(fn: Callable, devices: Sequence, args: Sequence = (), backend: Optional[str] = None,
          deadline_s: Optional[float] = None) -> List:
    """Run ``fn(ranks, *args)`` in one process per entry of ``devices``
    (rank i on ``devices[i]``), joined into one group at a free port of
    127.0.0.1, and return what each rank returned, in rank order.  NCCL on
    cards and gloo on the CPU, or ``backend`` (gloo lets two ranks share one
    card).  ``fn``, ``args`` and the results are pickled (``fn`` by its
    import path), and each rank starts from a fresh interpreter: it inherits
    no process-wide switch, ``float32_policy``'s included.  A rank that
    raises or dies fails the call with its traceback, and the other ranks
    are stopped; so does ``deadline_s``, where given.  SIGINT and SIGTERM
    to this process are passed on to the ranks."""
    ctx = torch.multiprocessing.get_context("spawn")
    results = ctx.Queue()
    init_method = f"tcp://127.0.0.1:{free_port()}"
    n = len(devices)
    procs = [ctx.Process(target=_rank_main, args=(fn, tuple(args), i, n, str(dev), init_method,
                                                   backend, results))
             for i, dev in enumerate(devices)]

    def forward(signum, frame):
        for p in procs:
            if p.pid is not None and p.is_alive():
                os.kill(p.pid, signum)

    previous = {}
    if threading.current_thread() is threading.main_thread():
        previous = {s: signal.signal(s, forward) for s in (signal.SIGINT, signal.SIGTERM)}
    out: Dict[int, Any] = {}
    failure = None
    t0 = time.monotonic()
    try:
        for p in procs:
            p.start()
        while len(out) < n and failure is None:
            try:
                rank, ok, value = results.get(timeout=1.0)
            except queue_mod.Empty:
                dead = [(i, p.exitcode) for i, p in enumerate(procs)
                        if p.exitcode is not None and i not in out]
                if dead:
                    failure = "; ".join(f"rank {i} exited with code {c} and no result"
                                        for i, c in dead)
                elif deadline_s is not None and time.monotonic() - t0 > deadline_s:
                    failure = f"the ranks did not finish within {deadline_s} s"
                continue
            if ok:
                out[rank] = value
            else:
                failure = f"rank {rank} failed:\n{value}"
    finally:
        for s, handler in previous.items():
            signal.signal(s, handler)
        for p in procs:
            if p.pid is None:  # never started
                continue
            if failure is not None and p.is_alive():
                p.terminate()
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join()
    if failure is not None:
        raise RuntimeError(f"spawn over {n} rank(s): {failure}")
    return [out[i] for i in range(n)]


@torch.no_grad()
def _bucketed(tensors: Sequence[torch.Tensor], ranks: Ranks, collective) -> None:
    """``collective(flat)`` over ``tensors`` flattened into buffers of at
    most ``BUCKET_BYTES`` of one dtype on the rank's device, the result
    copied back into each tensor wherever it lives."""
    by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for group in by_dtype.values():
        start = 0
        while start < len(group):
            stop, size = start, 0
            while stop < len(group) and (stop == start or size + group[stop].nbytes
                                         <= BUCKET_BYTES):
                size += group[stop].nbytes
                stop += 1
            bucket = group[start:stop]
            flat = torch.cat([t.reshape(-1).to(ranks.device) for t in bucket])
            collective(flat)
            # one fused copy back rather than a launch a tensor: the bf16
            # step is host-bound
            torch._foreach_copy_(bucket, [v.view_as(t) for v, t in zip(
                flat.split([t.numel() for t in bucket]), bucket)])
            start = stop


def all_reduce_(tensors: Sequence[torch.Tensor], ranks: Ranks) -> None:
    """Each tensor summed over the ranks, in place, one ``all_reduce`` a
    bucket (``_bucketed``)."""
    _bucketed(tensors, ranks, dist.all_reduce)


def replicate(tensors: Sequence[torch.Tensor], ranks: Ranks) -> None:
    """Rank 0's value of each tensor on every rank, in place (a broadcast a
    bucket); a tensor may live on the CPU, as an optimizer's step count
    does."""
    _bucketed(tensors, ranks, lambda flat: dist.broadcast(flat, src=0))


def gather_rows(x: torch.Tensor, ranks: Ranks) -> torch.Tensor:
    """Every rank's rows of ``x`` in rank order, on every rank: the sum of
    zero-padded copies, exact, through the one collective every backend
    serves on a card."""
    b = x.shape[0]
    out = x.new_zeros((ranks.world * b, *x.shape[1:]))
    out[ranks.rank * b:(ranks.rank + 1) * b] = x
    all_reduce_([out], ranks)
    return out


class _SumOverRanks(torch.autograd.Function):
    """The sum of ``x`` over the ranks, on every rank.  Each rank's loss is
    its share of the global loss, so a rank's gradient of the sum's input is
    the sum over ranks of their gradients of the output: the backward is the
    same all-reduce."""

    @staticmethod
    def forward(ctx, x):
        y = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(y)
        return y

    @staticmethod
    def backward(ctx, grad):
        g = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g)
        return g


def gather_over_ranks(x: torch.Tensor) -> torch.Tensor:
    """Every rank's ``x`` in rank order, stacked as (world, *x.shape), on
    every rank of the default group, with its gradient: the sum over the
    ranks (``_SumOverRanks``) of zero-padded copies, exact."""
    pick = torch.zeros((dist.get_world_size(),) + (1,) * x.dim(), device=x.device,
                       dtype=x.dtype)
    pick[dist.get_rank()] = 1.0
    return _SumOverRanks.apply(pick * x.unsqueeze(0))


def any_rank(flag: bool, ranks: Ranks) -> bool:
    """Whether ``flag`` holds on any rank: every rank gets the same answer,
    from a MAX on the host (the control group), which waits for no device
    work."""
    t = torch.tensor([int(flag)], dtype=torch.int32)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=ranks.control)
    return bool(t.item())


def barrier(ranks: Ranks) -> None:
    """Every rank waits here for the others (on the host)."""
    dist.barrier(group=ranks.control)
