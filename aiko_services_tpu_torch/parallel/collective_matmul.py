"""Collective matmuls: the ring's plain version.

Port of ``aiko_services_tpu/parallel/collective_matmul.py``.  The JAX
package writes them as ``shard_map`` bodies: ``ppermute`` moves a block
round the ring while ``jnp.dot`` multiplies the block a device holds, and
XLA schedules the two.  The port has no ``shard_map``: a per-rank function
takes ONE LIST of shards per operand, rank i's shard on rank i's device,
and returns the list of per-rank results.  It runs the schedule of
:mod:`.ring` op by op on the caller's stream: ``torch.mm`` in f32 for a
step's product (bf16 blocks are exact in f32; the result is cast as the
JAX ``preferred_element_type=f32`` dot's is), ``copy_`` for a move.  The
same code is the plain version of the card's ring
(:mod:`.rdma_collective`), which the CPU tests and the card's checks hold
it against.

- ``allgather_matmul(x_shards, w_shards)``: ``allgather(x) @ w_shard`` on
  every rank (column-parallel layer: x sharded on rows, w on columns);
- ``matmul_reducescatter(x_shards, w_shards)``: ``reduce_scatter(x_shard
  @ w_shard)`` (row-parallel layer), summed in f32 in ring order.

The ``*_sharded`` wrappers take global tensors and a :class:`.mesh.Mesh`,
split them exactly as ``shard_map`` does with the JAX ``P`` specs, and
return the global result on the mesh's first device.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch

from . import ring
from .mesh import Mesh

__all__ = ["allgather_matmul", "matmul_reducescatter",
           "allgather_matmul_sharded", "matmul_reducescatter_sharded",
           "run_plain", "shard", "unshard", "check_shards"]


def check_shards(name: str, x_shards: Sequence[torch.Tensor],
                 w_shards: Sequence[torch.Tensor]) -> Tuple[int, str]:
    """(ranks, device type) of a per-rank call; raises on a mismatch."""
    ranks = len(x_shards)
    if not ranks or len(w_shards) != ranks:
        raise ValueError(f"{name}: {len(x_shards)} x shards and "
                         f"{len(w_shards)} w shards; one of each a rank")
    kinds = {t.device.type for t in (*x_shards, *w_shards)}
    if len(kinds) != 1:
        raise ValueError(f"{name}: shards on {sorted(kinds)}")
    for r, (x, w) in enumerate(zip(x_shards, w_shards)):
        if x.device != w.device:
            raise ValueError(f"{name}: rank {r}'s x on {x.device}, w on "
                             f"{w.device}")
        if x.ndim != 2 or w.ndim != 2 or x.shape[1] != w.shape[0]:
            raise ValueError(f"{name}: rank {r}: x {tuple(x.shape)} @ w "
                             f"{tuple(w.shape)}")
        if x.shape != x_shards[0].shape or w.shape != w_shards[0].shape:
            raise ValueError(f"{name}: shards of unequal shapes")
        if x.dtype != x_shards[0].dtype or w.dtype != x.dtype:
            raise TypeError(f"{name}: x and w shards of one dtype")
    return ranks, kinds.pop()


def _buffers(kind: str, x_shards, w_shards) -> Dict[tuple, torch.Tensor]:
    """Every rank's comm slots, scratch and output (``kind`` "ag" or
    "rs"), allocated on its device before anything is enqueued: the ring's
    start barrier needs no more than that (see :mod:`.ring`)."""
    ranks = len(x_shards)
    dtype = x_shards[0].dtype
    buffers = {}
    for r, (x, w) in enumerate(zip(x_shards, w_shards)):
        if kind == "ag":
            m_local, k = x.shape
            slots = torch.empty((2, m_local, k), dtype=dtype, device=x.device)
            out = torch.empty((ranks * m_local, w.shape[1]), dtype=dtype,
                              device=x.device)
        else:
            n = w.shape[1]
            if n % ranks:
                raise ValueError(f"matmul_reducescatter: {n} output columns "
                                 f"do not divide over {ranks} ranks")
            shape = (x.shape[0], n // ranks)
            slots = torch.empty((2, *shape), dtype=torch.float32,
                                device=x.device)
            buffers[("scratch", r, 0)] = torch.empty(
                shape, dtype=torch.float32, device=x.device)
            out = torch.empty(shape, dtype=dtype, device=x.device)
        buffers[("slot", r, 0)], buffers[("slot", r, 1)] = slots[0], slots[1]
        buffers[("out", r, 0)] = out
    return buffers


def _product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.mm(a.to(torch.float32), b.to(torch.float32))


def run_plain(kind: str, x_shards: Sequence[torch.Tensor],
              w_shards: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Run the :mod:`.ring` schedule of ``kind`` ("ag": all-gather matmul,
    "rs": matmul reduce-scatter) op by op on the caller's stream."""
    ranks = len(x_shards)
    buffers = _buffers(kind, x_shards, w_shards)
    schedule = ring.allgather_schedule(ranks) if kind == "ag" \
        else ring.reducescatter_schedule(ranks)
    for op in schedule:
        x, w = x_shards[op.rank], w_shards[op.rank]
        if op.kind == "entry":
            if kind == "ag":
                buffers[op.writes[0]].copy_(x)
        elif op.kind == "copy":
            buffers[op.writes[0]].copy_(buffers[op.reads[0]])
        elif op.kind == "product" and kind == "ag":
            m_local = x.shape[0]
            rows = slice(op.index * m_local, (op.index + 1) * m_local)
            buffers[op.writes[0]][rows] = _product(
                buffers[op.reads[0]], w).to(x.dtype)
        elif op.kind == "product":
            n_local = buffers[op.writes[0]].shape[1]
            cols = slice(op.index * n_local, (op.index + 1) * n_local)
            buffers[op.writes[0]].copy_(_product(x, w[:, cols]))
        else:                                            # "add"
            acc = buffers[op.reads[0]]
            if len(op.reads) == 2:
                acc += buffers[op.reads[1]]
            if op.writes[0][0] == "out":
                buffers[op.writes[0]].copy_(acc)
    return [buffers[("out", r, 0)] for r in range(ranks)]


def allgather_matmul(x_shards: Sequence[torch.Tensor],
                     w_shards: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """``allgather(x) @ w_shard`` on every rank: x_shards ``(m_local, k)``,
    w_shards ``(k, n_local)`` -> ``(m_local * R, n_local)`` a rank."""
    check_shards("allgather_matmul", x_shards, w_shards)
    return run_plain("ag", x_shards, w_shards)


def matmul_reducescatter(x_shards: Sequence[torch.Tensor],
                         w_shards: Sequence[torch.Tensor]
                         ) -> List[torch.Tensor]:
    """``reduce_scatter(x_shard @ w_shard)``: x_shards ``(m, k_local)``,
    w_shards ``(k_local, n)`` -> ``(m, n / R)`` a rank, rank r's the sum
    over ranks of its column slice r."""
    check_shards("matmul_reducescatter", x_shards, w_shards)
    return run_plain("rs", x_shards, w_shards)


def shard(tensor: torch.Tensor, dim: int,
          devices: Sequence[torch.device]) -> List[torch.Tensor]:
    """``tensor`` cut into ``len(devices)`` equal contiguous pieces along
    ``dim`` (a ``P`` spec naming the axis there), piece i on device i."""
    ranks = len(devices)
    if tensor.shape[dim] % ranks:
        raise ValueError(f"dimension {dim} of shape {tuple(tensor.shape)} "
                         f"does not divide over {ranks} ranks")
    return [piece.to(device).contiguous()
            for piece, device in zip(tensor.chunk(ranks, dim), devices)]


def unshard(pieces: Sequence[torch.Tensor], dim: int,
            device: torch.device) -> torch.Tensor:
    return torch.cat([piece.to(device) for piece in pieces], dim=dim)


def allgather_matmul_sharded(x: torch.Tensor, w: torch.Tensor, mesh: Mesh,
                             axis: str = "tp") -> torch.Tensor:
    """x ``P(axis, None)``, w ``P(None, axis)`` -> ``x @ w`` as
    ``P(None, axis)``, gathered on the mesh's first device."""
    devices = mesh.ring(axis)
    return unshard(allgather_matmul(shard(x, 0, devices),
                                    shard(w, 1, devices)), 1, devices[0])


def matmul_reducescatter_sharded(x: torch.Tensor, w: torch.Tensor,
                                 mesh: Mesh, axis: str = "tp"
                                 ) -> torch.Tensor:
    """x ``P(None, axis)``, w ``P(axis, None)`` -> ``x @ w`` summed over
    the shards, ``P(None, axis)``, gathered on the mesh's first device."""
    devices = mesh.ring(axis)
    return unshard(matmul_reducescatter(shard(x, 1, devices),
                                        shard(w, 0, devices)), 1, devices[0])
