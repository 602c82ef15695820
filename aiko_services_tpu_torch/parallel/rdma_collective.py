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
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from ..ops import _cuda
from . import ring
from .collective_matmul import (_buffers, check_shards, run_plain, shard,
                                unshard)
from .mesh import Mesh

__all__ = ["rdma_allgather_matmul", "rdma_matmul_reducescatter",
           "rdma_allgather_matmul_sharded",
           "rdma_matmul_reducescatter_sharded"]

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
    code = _cuda.DTYPE_CODES[dtype]
    devices = [x.device for x in x_shards]
    callers = {d: torch.cuda.current_stream(d) for d in devices}
    buffers = _buffers(kind, x_shards, w_shards)
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
                target = buffers[op.writes[0]]
                if kind == "ag":
                    m_local, k = x.shape
                    _cuda.launch("aiko_ring_ag_step", device,
                                 buffers[op.reads[0]].data_ptr(),
                                 w.data_ptr(), target.data_ptr(), m_local, k,
                                 w.shape[1], op.index * m_local, code)
                else:
                    m, k_local = x.shape
                    n_local = target.shape[1]
                    _cuda.launch("aiko_ring_rs_step", device, x.data_ptr(),
                                 w.data_ptr(), target.data_ptr(), m, k_local,
                                 w.shape[1], n_local, op.index * n_local,
                                 code)
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
