"""The ring collective matmuls' protocol, as one schedule.

The TPU kernels (``aiko_services_tpu/parallel/rdma_collective.py``) run a
ring of R ranks: rank r multiplies what it holds while its DMA engine
moves it on to its right neighbour (r + 1) mod R, into one of two comm
slots, fenced by semaphores.  This module says, for every step and rank,
what runs, on which of the rank's two streams, what it reads and writes,
which events it waits on and which event it records.  Both executors
follow it in its host order:

* the plain version (``collective_matmul.run_plain``) runs the ops one
  after the other on any device (the CPU tests run it), ignoring the
  events;
* the card's ring (``rdma_collective``) enqueues each op on its rank's
  compute or copy stream and turns the events into CUDA events.

So the CPU tests check the protocol the card runs.  The TPU's semaphores
map to events:

* ``send_sem``/``recv_sem``: ``("copied", r, s)``, recorded on the
  sender's copy stream after the copy of step s; the receiver's next step
  waits on it;
* ``capacity_sem``: the copy into a slot waits on the events of every op
  that read the slot's previous content on the receiver (its step and its
  own outgoing copy), ``Op.capacity``;
* the start barrier: ``("entry", r)``, recorded on rank r's compute stream
  once it has joined the caller's stream (and, all-gather, staged its
  shard into slot 0); every rank's first copy waits on its neighbour's.

Events are one-shot: each is recorded once and every copy is waited on by
its receiver's next op, so a call leaves nothing to drain (the TPU kernels
end by waiting out their capacity semaphore's last credit, JAX :159-165,
:262).  The host order records every event before anything waits on it:
each step enqueues all ranks' compute ops, then all ranks' copies.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

__all__ = ["Op", "allgather_schedule", "reducescatter_schedule", "joins"]

#: ("entry", rank, 0) | ("computed", rank, step) | ("copied", rank, step)
Event = Tuple[str, int, int]
#: ("slot", rank, 0 or 1) | ("scratch", rank, 0) | ("out", rank, 0)
Buffer = Tuple[str, int, int]


@dataclasses.dataclass(frozen=True)
class Op:
    """One op of the ring.  ``kind``: "entry" (join the caller; all-gather:
    stage the shard into slot 0), "product" (a step kernel: all-gather
    ``out[index * m_local:] = slot @ w``; reduce-scatter the partial of
    owner ``index`` into ``writes``), "add" (reduce-scatter: ``slot +=
    scratch``, at the last step into ``out``, cast; a ring of one rank
    only casts its slot) or "copy" (``writes`` on
    rank ``peer`` := ``reads[0]`` on ``rank``)."""

    kind: str
    step: int
    rank: int
    stream: str                       # "compute" or "copy" of ``rank``
    reads: Tuple[Buffer, ...] = ()
    writes: Tuple[Buffer, ...] = ()
    index: int = -1                   # all-gather src, reduce-scatter owner
    peer: int = -1                    # copy: the receiving rank
    waits: Tuple[Event, ...] = ()     # data this op needs
    capacity: Tuple[Event, ...] = ()  # copy: the receiver's slot is free
    records: Optional[Event] = None


def _ring(ranks: int, rank: int) -> Tuple[int, int]:
    return (rank + 1) % ranks, (rank - 1) % ranks


def _capacity(right: int, step: int) -> Tuple[Event, ...]:
    """The copy of ``step`` overwrites slot (step + 1) % 2 on ``right``:
    last read there by the receiver's compute op and its outgoing copy of
    step - 1 (at step 0: unused since the receiver's entry)."""
    if step == 0:
        return (("entry", right, 0),)
    return ("computed", right, step - 1), ("copied", right, step - 1)


def allgather_schedule(ranks: int) -> List[Op]:
    """``allgather(x) @ w_shard`` on every rank (JAX ``_ag_kernel``): at
    step s rank r multiplies the block in slot s % 2, which came from rank
    (r - s) mod R, into those rows of its output, while its copy stream
    sends that block on to slot (s + 1) % 2 of its right neighbour."""
    if ranks < 1:
        raise ValueError(f"a ring needs at least one rank, got {ranks}")
    ops = [Op("entry", 0, r, "compute", writes=(("slot", r, 0),),
              records=("entry", r, 0)) for r in range(ranks)]
    for step in range(ranks):
        slot = step % 2
        for r in range(ranks):
            _, left = _ring(ranks, r)
            ops.append(Op(
                "product", step, r, "compute", reads=(("slot", r, slot),),
                writes=(("out", r, 0),), index=(r - step) % ranks,
                waits=() if step == 0 else (("copied", left, step - 1),),
                records=("computed", r, step)))
        if step == ranks - 1:
            break
        for r in range(ranks):
            right, left = _ring(ranks, r)
            ready = ("entry", r, 0) if step == 0 else \
                ("copied", left, step - 1)
            ops.append(Op(
                "copy", step, r, "copy", reads=(("slot", r, slot),),
                writes=(("slot", right, 1 - slot),), peer=right,
                waits=(ready,), capacity=_capacity(right, step),
                records=("copied", r, step)))
    return ops


def reducescatter_schedule(ranks: int) -> List[Op]:
    """``reduce_scatter(x_shard @ w_shard)`` (JAX ``_rs_kernel``): the
    accumulator rank r holds at step s travels towards owner (r + R - 1 -
    s) mod R.  Step 0 computes that owner's partial into slot 0; at every
    later step the next owner's partial is computed into the scratch
    while the accumulator is in flight, and added once it has arrived; the
    last step adds into the output, cast to the inputs' type."""
    if ranks < 1:
        raise ValueError(f"a ring needs at least one rank, got {ranks}")
    ops = [Op("entry", 0, r, "compute", records=("entry", r, 0))
           for r in range(ranks)]
    for step in range(ranks):
        slot = step % 2
        last = step == ranks - 1
        for r in range(ranks):
            owner = (r + ranks - 1 - step) % ranks
            if step == 0:
                ops.append(Op("product", 0, r, "compute",
                              writes=(("slot", r, 0),), index=owner,
                              records=None if last else ("computed", r, 0)))
            else:
                ops.append(Op("product", step, r, "compute",
                              writes=(("scratch", r, 0),), index=owner))
        if step == 0 and last:     # one rank: the cast alone
            ops += [Op("add", 0, r, "compute", reads=(("slot", r, 0),),
                       writes=(("out", r, 0),), records=("computed", r, 0))
                    for r in range(ranks)]
        elif step:
            for r in range(ranks):
                _, left = _ring(ranks, r)
                ops.append(Op(
                    "add", step, r, "compute",
                    reads=(("slot", r, slot), ("scratch", r, 0)),
                    writes=(("out", r, 0),) if last else (("slot", r, slot),),
                    waits=(("copied", left, step - 1),),
                    records=("computed", r, step)))
        if last:
            break
        for r in range(ranks):
            right, _ = _ring(ranks, r)
            ops.append(Op(
                "copy", step, r, "copy", reads=(("slot", r, slot),),
                writes=(("slot", right, 1 - slot),), peer=right,
                waits=(("computed", r, step),),
                capacity=_capacity(right, step),
                records=("copied", r, step)))
    return ops


def joins(ranks: int) -> List[Event]:
    """What the caller's stream waits on before the result is its: each
    rank's last compute op (every copy is waited on by its receiver)."""
    return [("computed", r, ranks - 1) for r in range(ranks)]
