"""Ring collective matmuls with the ring's protocol owned explicitly.

Port of ``aiko_services_tpu/parallel/rdma_collective.py``.  The TPU
kernels ``rdma_allgather_matmul`` / ``rdma_matmul_reducescatter`` own the
ring's overlap: per step the MXU multiplies the block a chip holds while
its DMA engines move the next block to its right neighbour, fenced by
semaphores (double-buffered comm slots, a capacity handshake, a start
barrier).  On the card each rank has a compute stream and a copy stream on
its device; the step's product is a kernel of ``csrc/ring_matmul.cu``
(``aiko_ring_ag_step`` / ``aiko_ring_rs_step``) on the compute stream, the
move a ``copy_`` on the sender's copy stream into the receiver's slot
(``cudaMemcpyPeerAsync`` between distinct cards), and CUDA events stand
for the semaphores, as the :mod:`.ring` schedule lays out.  Ranks on one
card (``["cuda:0"] * 4``) run concurrently on their own streams, so the
capacity handshake is exercised under real concurrency, which the JAX
package's interpret mode cannot show; the same code runs across distinct
cards when the mesh names them.

On CPU tensors the functions take the plain version
(:func:`.collective_matmul.run_plain`, the same schedule op by op).  On
CUDA tensors they run the ring or raise.

Where the protocol can go wrong on the card, and what guards it:

- **Waiting on an event that is not recorded yet.**
  ``cudaStreamWaitEvent`` on an event never recorded returns at once: a
  silent race.  The host loop enqueues in the schedule's order, which
  records every event before any op that waits on it (each step's
  compute ops for all ranks, then their copies); ``events[...]`` raises a
  ``KeyError`` rather than wait on an event that is not there.
- **The caching allocator across streams.**  Slots, scratch and outputs
  are allocated on the caller's stream and used on the ranks' streams;
  each gets ``record_stream`` for every stream that touches it, so its
  memory is not handed out again while a copy or kernel is in flight.
- **Launching on the right stream and device.**  ``_cuda.launch`` uses
  the current stream of the device; every op runs under
  ``torch.cuda.device(d)`` and ``torch.cuda.stream(rank_stream)``, and
  the caller's stream of every rank's device waits on that rank's last
  compute op before the call returns.
- **In-kernel peer stores with spin-wait flags** are out of scope: on one
  card a rank's CTAs could spin while another rank's CTAs are not
  resident, a deadlock.  That design waits for the four-card path.
- **The decode path's split scratch.**  Its K split's f32 partials and
  arrival counters (:func:`step_scratch`) belong to one rank, kept beside
  its streams and recorded on its compute stream with the slots: the
  ranks of one card run at once on their own streams, so a per-device
  scratch (``_cuda.scratch``) would be raced.

The step kernel takes one of four paths (:data:`STEP_PATHS`): TMA +
``wgmma`` tiles at prefill shapes (bf16, m > 64), the weight streamed with
a K split at decode shapes (bf16, m <= 64), ``mma.sync`` on tiles loaded
element by element where a size or pointer is not aligned for TMA, and f32
FMAs.  The kernel alone holds the rule, the tile sizes and the K split;
the host gives each rank its share of the SMs and a scratch the kernel
sizes, and :func:`step_plan` asks the kernel what a step takes.
"""

from __future__ import annotations

import collections
import ctypes
from typing import (Callable, Dict, List, NamedTuple, Optional, Sequence,
                    Tuple)

import torch

from ..ops import _cuda
from . import ring
from .collective_matmul import (_buffers, check_shards, run_plain, shard,
                                unshard)
from .mesh import Mesh

__all__ = ["rdma_allgather_matmul", "rdma_matmul_reducescatter",
           "rdma_allgather_matmul_sharded",
           "rdma_matmul_reducescatter_sharded", "STEP_PATHS",
           "StepScratch", "step_scratch", "launch_step", "step_plan"]

#: A test hook: called as ``before_step(rank, step)`` with the rank's
#: compute stream current, just before its step kernel is enqueued (the
#: card's tests slow one rank with ``torch.cuda._sleep`` there).
BeforeStep = Optional[Callable[[int, int], None]]

#: (device, rank) -> (compute stream, copy stream); ranks that share a card
#: get streams of their own.
_STREAMS: Dict[Tuple[torch.device, int], Tuple[torch.cuda.Stream,
                                              torch.cuda.Stream]] = {}


def _streams(device: torch.device, rank: int):
    key = (device, rank)
    if key not in _STREAMS:
        with torch.cuda.device(device):
            _STREAMS[key] = (torch.cuda.Stream(device),
                             torch.cuda.Stream(device))
    return _STREAMS[key]


#: The paths of ``csrc/ring_matmul.cu``'s ``matmul()``, indexed by the code
#: its ``aiko_ring_*_plan`` queries return.
STEP_PATHS = ("f32", "mma_sync", "stream", "wgmma")


class StepScratch(NamedTuple):
    """A rank's share of its card's SMs (``ctas``), over which the
    streamed-weight path splits K, and the split's scratch: f32 partials
    and int32 arrival counters (zero; each launch leaves them zero)."""
    ctas: int
    partials: torch.Tensor
    arrivals: torch.Tensor


#: (device, rank) -> that rank's split scratch, grown as a call needs it.
#: Only the rank's compute stream (``_streams``, the same key) runs its
#: steps, in order, so a call reuses it with no zero-fill ahead of the
#: ring; ranks never share one.
_SCRATCH: Dict[Tuple[torch.device, int], StepScratch] = {}


def step_scratch(device: torch.device, ctas: int,
                 rank: Optional[int] = None) -> StepScratch:
    """The split scratch of a rank with ``ctas`` SMs of ``device``, sized
    by the kernel (``aiko_ring_scratch_floats``) to hold any step's split:
    rank ``rank``'s own (kept for its later calls), or a new one when
    ``rank`` is None."""
    kept = _SCRATCH.get((device, rank)) if rank is not None else None
    if kept is not None and kept.ctas >= ctas:
        return kept._replace(ctas=ctas)
    floats = _cuda.entry("aiko_ring_scratch_floats")(ctas)
    scratch = StepScratch(
        ctas, torch.empty(floats, dtype=torch.float32, device=device),
        torch.zeros(ctas, dtype=torch.int32, device=device))
    if rank is not None:
        _SCRATCH[(device, rank)] = scratch
    return scratch


#: SMs of each card the ring has run on.
_SMS: Dict[torch.device, int] = {}


def _ctas(device: torch.device, sharing: int) -> int:
    """A rank's share of ``device``'s SMs when ``sharing`` ranks run on it
    at once."""
    if device not in _SMS:
        _SMS[device] = torch.cuda.get_device_properties(device) \
            .multi_processor_count
    return max(1, _SMS[device] // sharing)


def _step_args(kind: str, a: torch.Tensor, w: torch.Tensor,
               target: torch.Tensor, index: int) -> tuple:
    """The step entries' arguments from ``a`` through the column or row
    offset: all-gather, block ``a`` into rows ``index * m_local ..`` of
    ``target``; reduce-scatter, ``a @`` w's column slice ``index`` into the
    f32 ``target``."""
    if kind == "ag":
        m_local, k = a.shape
        return (m_local, k, w.shape[1], index * m_local)
    m, k_local = a.shape
    n_local = target.shape[1]
    return (m, k_local, w.shape[1], n_local, index * n_local)


def launch_step(kind: str, a: torch.Tensor, w: torch.Tensor,
                target: torch.Tensor, index: int,
                scratch: StepScratch) -> None:
    """Enqueue one step's product (:func:`_step_args`) on the current
    stream of ``a``'s card, K split over ``scratch``'s share of the SMs."""
    _cuda.launch(f"aiko_ring_{kind}_step", a.device, a.data_ptr(),
                 w.data_ptr(), target.data_ptr(), scratch.partials.data_ptr(),
                 scratch.arrivals.data_ptr(),
                 *_step_args(kind, a, w, target, index), scratch.ctas,
                 _cuda.DTYPE_CODES[a.dtype])


def step_plan(kind: str, a: torch.Tensor, w: torch.Tensor,
              target: torch.Tensor, index: int,
              ctas: int) -> Tuple[str, int, int]:
    """(path, K slices, rows a slice) that the kernel takes for
    :func:`launch_step`'s arguments with ``ctas`` SMs: its own answer."""
    plan = (ctypes.c_int * 3)()
    _cuda.entry(f"aiko_ring_{kind}_plan")(
        a.data_ptr(), w.data_ptr(), target.data_ptr(),
        *_step_args(kind, a, w, target, index), ctas,
        _cuda.DTYPE_CODES[a.dtype], ctypes.addressof(plan))
    return STEP_PATHS[plan[0]], plan[1], plan[2]


def _ring_on_card(kind: str, wrapper, x_shards: Sequence[torch.Tensor],
                  w_shards: Sequence[torch.Tensor],
                  before_step: BeforeStep) -> List[torch.Tensor]:
    ranks = len(x_shards)
    dtype = x_shards[0].dtype
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{wrapper.__name__}: the ring kernels take float32 "
                        f"or bfloat16, got {dtype}")
    for tensor in (*x_shards, *w_shards):
        if not tensor.is_contiguous():
            raise ValueError(f"{wrapper.__name__}: shard of shape "
                             f"{tuple(tensor.shape)} is not contiguous")
    devices = [x.device for x in x_shards]
    callers = {d: torch.cuda.current_stream(d) for d in devices}
    buffers = _buffers(kind, x_shards, w_shards)
    sharing = collections.Counter(devices)
    scratch = [step_scratch(d, _ctas(d, sharing[d]), r)
               for r, d in enumerate(devices)]
    for r, split in enumerate(scratch):
        buffers[("partials", r, 0)] = split.partials
        buffers[("arrivals", r, 0)] = split.arrivals
    streams = [_streams(d, r) for r, d in enumerate(devices)]
    for (name, r, _), tensor in buffers.items():
        users = {streams[r][0]}
        if name == "slot":      # read by its copy stream, written by the left
            users |= {streams[r][1], streams[(r - 1) % ranks][1]}
        for stream in users:
            tensor.record_stream(stream)
    for r in range(ranks):
        for tensor in (x_shards[r], w_shards[r]):
            tensor.record_stream(streams[r][0])
    schedule = ring.allgather_schedule(ranks) if kind == "ag" \
        else ring.reducescatter_schedule(ranks)
    events: Dict[ring.Event, torch.cuda.Event] = {}
    for op in schedule:
        device = devices[op.rank]
        stream = streams[op.rank][0 if op.stream == "compute" else 1]
        x, w = x_shards[op.rank], w_shards[op.rank]
        with torch.cuda.device(device), torch.cuda.stream(stream):
            for event in op.waits + op.capacity:
                stream.wait_event(events[event])
            if op.kind == "entry":
                stream.wait_stream(callers[device])
                if kind == "ag":
                    buffers[op.writes[0]].copy_(x)
            elif op.kind == "copy":
                buffers[op.writes[0]].copy_(buffers[op.reads[0]],
                                            non_blocking=True)
                wrapper.copies += 1
            elif op.kind == "product":
                if before_step is not None:
                    before_step(op.rank, op.step)
                launch_step(kind, buffers[op.reads[0]] if kind == "ag"
                            else x, w, buffers[op.writes[0]], op.index,
                            scratch[op.rank])
                wrapper.launches += 1
            else:                                        # "add"
                acc = buffers[op.reads[0]]
                if len(op.reads) == 2:
                    acc += buffers[op.reads[1]]
                if op.writes[0][0] == "out":
                    buffers[op.writes[0]].copy_(acc)
            if op.records is not None:
                event = torch.cuda.Event()
                event.record(stream)
                events[op.records] = event
    for r, event in enumerate(ring.joins(ranks)):
        callers[devices[r]].wait_event(events[event])
    return [buffers[("out", r, 0)] for r in range(ranks)]


def rdma_allgather_matmul(x_shards: Sequence[torch.Tensor],
                          w_shards: Sequence[torch.Tensor],
                          before_step: BeforeStep = None
                          ) -> List[torch.Tensor]:
    """``allgather(x) @ w_shard`` on every rank, the ring run explicitly:
    x_shards ``(m_local, k)``, w_shards ``(k, n_local)`` -> ``(m_local *
    R, n_local)`` a rank, f32 accumulation, in the inputs' type."""
    _, kind = check_shards("rdma_allgather_matmul", x_shards, w_shards)
    if kind == "cpu":
        return run_plain("ag", x_shards, w_shards)
    return _ring_on_card("ag", rdma_allgather_matmul, x_shards, w_shards,
                         before_step)


def rdma_matmul_reducescatter(x_shards: Sequence[torch.Tensor],
                              w_shards: Sequence[torch.Tensor],
                              before_step: BeforeStep = None
                              ) -> List[torch.Tensor]:
    """``reduce_scatter(x_shard @ w_shard)``, the ring run explicitly:
    x_shards ``(m, k_local)``, w_shards ``(k_local, n)`` -> ``(m, n / R)``
    a rank, f32 ring accumulators, in the inputs' type."""
    _, kind = check_shards("rdma_matmul_reducescatter", x_shards, w_shards)
    if kind == "cpu":
        return run_plain("rs", x_shards, w_shards)
    return _ring_on_card("rs", rdma_matmul_reducescatter, x_shards, w_shards,
                         before_step)


#: Kernel launches (step kernels) and slot copies on the CUDA path; the
#: plain version counts neither.
_cuda.counted(rdma_allgather_matmul)
rdma_allgather_matmul.copies = 0
_cuda.counted(rdma_matmul_reducescatter)
rdma_matmul_reducescatter.copies = 0


def rdma_allgather_matmul_sharded(x: torch.Tensor, w: torch.Tensor,
                                  mesh: Mesh, axis: str = "tp",
                                  before_step: BeforeStep = None
                                  ) -> torch.Tensor:
    """x ``P(axis, None)``, w ``P(None, axis)`` -> ``x @ w`` as
    ``P(None, axis)``, gathered on the mesh's first device (the JAX
    wrapper's contract, ``collective_matmul.allgather_matmul_sharded``)."""
    devices = mesh.ring(axis)
    return unshard(rdma_allgather_matmul(shard(x, 0, devices),
                                         shard(w, 1, devices), before_step),
                   1, devices[0])


def rdma_matmul_reducescatter_sharded(x: torch.Tensor, w: torch.Tensor,
                                      mesh: Mesh, axis: str = "tp",
                                      before_step: BeforeStep = None
                                      ) -> torch.Tensor:
    """x ``P(None, axis)``, w ``P(axis, None)`` -> ``x @ w`` summed over
    the shards, ``P(None, axis)``, on the mesh's first device."""
    devices = mesh.ring(axis)
    return unshard(rdma_matmul_reducescatter(shard(x, 1, devices),
                                             shard(w, 0, devices),
                                             before_step), 1, devices[0])
