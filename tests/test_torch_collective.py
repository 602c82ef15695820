"""Port parity for the ring collective matmuls:
``aiko_services_tpu_torch.parallel`` against ``aiko_services_tpu.parallel``
on the same numpy inputs.

The JAX side runs as ``tests/test_rdma_collective.py`` runs it: the raw
RDMA kernels in interpret mode and the ``shard_map`` + ``ppermute`` twins,
on the virtual CPU mesh ``Mesh(jax.devices()[:R], ("tp",))``.  The port
runs on ``["cpu"] * R``, where both its ring (``rdma_*``) and its twins
take the plain version: the ring's schedule (``parallel/ring.py``) op by
op.  The card runs the same schedule on streams and events
(tests/test_torch_cuda.py, chip_smoke.py phase 7), so the schedule's
invariants are checked here as well: every block reaches every rank once,
every output block is written once, no slot is overwritten before the op
that reads it is done, and every wait names an event recorded earlier.

Tolerances: f32 ``rtol = atol = 1e-5`` for the all-gather and ``1e-4``
for the reduce-scatter (the JAX tests' own: the products sum in another
order than XLA's), ``2e-2`` for bf16 (one bf16 rounding of results of
magnitude ~5).
"""

import collections

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

from aiko_services_tpu.parallel.collective_matmul import (
    allgather_matmul_sharded as jax_allgather_twin,
    matmul_reducescatter_sharded as jax_reducescatter_twin)
from aiko_services_tpu.parallel.rdma_collective import (
    rdma_allgather_matmul_sharded as jax_rdma_allgather,
    rdma_matmul_reducescatter_sharded as jax_rdma_reducescatter)
from aiko_services_tpu_torch.parallel import (
    Mesh, MeshSpec, allgather_matmul, allgather_matmul_sharded, make_mesh,
    matmul_reducescatter_sharded, rdma_allgather_matmul,
    rdma_allgather_matmul_sharded, rdma_matmul_reducescatter,
    rdma_matmul_reducescatter_sharded, ring)

RANKS = [1, 2, 4, 8]
#: name -> (kind, x shape, w shape, dtype, seed, tolerance)
CASES = {
    "ag_f32": ("ag", (16, 32), (32, 24), "float32", 0, 1e-5),
    "rs_f32": ("rs", (8, 64), (64, 40), "float32", 1, 1e-4),
    "ag_bf16": ("ag", (16, 32), (32, 16), "bfloat16", 2, 2e-2),
    "rs_bf16": ("rs", (8, 64), (64, 40), "bfloat16", 3, 2e-2),
}


@pytest.fixture(scope="module", autouse=True)
def _leave_jax_caches_cold():
    """Later test modules in the same worker count their own JAX
    compiles; drop what this module compiled once it is done."""
    yield
    jax.clear_caches()


def _operands(case):
    kind, xs, ws, dtype, seed, _ = CASES[case]
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(xs).astype(np.float32)
    w = rng.standard_normal(ws).astype(np.float32)
    if dtype == "bfloat16":   # values exact in bf16 on both sides
        x = np.asarray(jnp.asarray(x, jnp.bfloat16), np.float32)
        w = np.asarray(jnp.asarray(w, jnp.bfloat16), np.float32)
    return kind, x, w, dtype


_JAX = {}


def _jax_results(case, ranks):
    """(rdma kernel, ppermute twin) outputs of the JAX package, f32."""
    key = (case, ranks)
    if key not in _JAX:
        kind, x, w, dtype = _operands(case)
        mesh = JaxMesh(np.array(jax.devices()[:ranks]), ("tp",))
        jdtype = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
        xj, wj = jnp.asarray(x, jdtype), jnp.asarray(w, jdtype)
        rdma, twin = (jax_rdma_allgather, jax_allgather_twin) \
            if kind == "ag" else (jax_rdma_reducescatter,
                                  jax_reducescatter_twin)
        _JAX[key] = tuple(np.asarray(fn(xj, wj, mesh), np.float32)
                          for fn in (rdma, twin))
    return _JAX[key]


def _port(fn, case, ranks):
    _, x, w, dtype = _operands(case)
    mesh = make_mesh(["cpu"] * ranks, tp=ranks)
    tdtype = getattr(torch, dtype)
    out = fn(torch.from_numpy(x).to(tdtype), torch.from_numpy(w).to(tdtype),
             mesh)
    assert out.dtype == tdtype
    return out.float().numpy()


@pytest.mark.parametrize("ranks", RANKS)
@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("port", ["rdma", "twin"])
def test_port_equals_the_jax_kernels_and_twins(port, case, ranks):
    """The port's ring and its twin against the JAX raw-RDMA kernel, the
    JAX ppermute twin and the dense product."""
    if jax.device_count() < ranks:
        pytest.skip(f"needs {ranks} JAX CPU devices")
    kind = CASES[case][0]
    fn = {("rdma", "ag"): rdma_allgather_matmul_sharded,
          ("rdma", "rs"): rdma_matmul_reducescatter_sharded,
          ("twin", "ag"): allgather_matmul_sharded,
          ("twin", "rs"): matmul_reducescatter_sharded}[(port, kind)]
    got = _port(fn, case, ranks)
    tol = CASES[case][5]
    _, x, w, _ = _operands(case)
    for want in (*_jax_results(case, ranks), x @ w):
        np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


@pytest.mark.parametrize("ranks", RANKS)
@pytest.mark.parametrize("case", sorted(CASES))
def test_ring_on_cpu_is_its_plain_version(case, ranks):
    """On CPU tensors the ring takes the plain version: bit-equal to the
    twin."""
    kind = CASES[case][0]
    ring_fn, twin = (rdma_allgather_matmul_sharded, allgather_matmul_sharded) \
        if kind == "ag" else (rdma_matmul_reducescatter_sharded,
                              matmul_reducescatter_sharded)
    np.testing.assert_array_equal(_port(ring_fn, case, ranks),
                                  _port(twin, case, ranks))


def test_per_rank_functions_take_one_list_per_operand():
    """Rank r's output of the per-rank all-gather is allgather(x) @ w_r."""
    rng = np.random.default_rng(9)
    x = torch.from_numpy(rng.standard_normal((12, 8)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((8, 6)).astype(np.float32))
    xs, ws = list(x.chunk(3, 0)), [c.contiguous() for c in w.chunk(3, 1)]
    for outs in (allgather_matmul(xs, ws), rdma_allgather_matmul(xs, ws)):
        assert len(outs) == 3
        for r, out in enumerate(outs):
            torch.testing.assert_close(out, x @ ws[r], rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError):
        rdma_allgather_matmul(xs, ws[:2])
    with pytest.raises(ValueError):
        rdma_matmul_reducescatter([x[:, :4], x[:, 4:]],
                                  [w[:4, :5].contiguous(),
                                   w[4:, :5].contiguous()])   # 5 over 2


# --------------------------------------------------------------------------- #
# The schedule's invariants

SCHEDULES = {"ag": ring.allgather_schedule, "rs": ring.reducescatter_schedule}


def _happens_before(schedule):
    """Vector clocks over the schedule in host order: per op, its clock;
    per event, the clock it captured.  An op waits on events and follows
    every earlier op of its stream."""
    streams = collections.defaultdict(dict)
    clocks, events = [], {}
    for op in schedule:
        key = (op.rank, op.stream)
        clock = streams[key]
        for event in op.waits + op.capacity:
            assert event in events, f"{op} waits on {event}, not recorded"
            for stream, seq in events[event].items():
                clock[stream] = max(clock.get(stream, 0), seq)
        clock[key] = clock.get(key, 0) + 1
        clocks.append((key, dict(clock)))
        if op.records is not None:
            assert op.records not in events, f"{op.records} recorded twice"
            events[op.records] = dict(clock)
    return clocks, events


def _before(earlier, later):
    (key, clock), (_, other) = earlier, later
    return other.get(key, 0) >= clock[key]


@pytest.mark.parametrize("ranks", [1, 2, 3, 4, 5, 8])
@pytest.mark.parametrize("kind", ["ag", "rs"])
def test_schedule_orders_every_slot_access(kind, ranks):
    """Every read sees its buffer's last write done; no write (a copy into
    a neighbour's slot above all) starts before every read of the old
    content and the last write are done; every wait names an event
    recorded earlier in host order, each event once; the caller's join
    covers every write of every output."""
    schedule = SCHEDULES[kind](ranks)
    clocks, events = _happens_before(schedule)
    writer, readers = {}, collections.defaultdict(list)
    outs = collections.defaultdict(list)
    for index, op in enumerate(schedule):
        me = clocks[index]
        for buffer in op.reads:
            assert _before(clocks[writer[buffer]], me), (op, buffer)
        for buffer in op.writes:
            for reader in readers[buffer]:
                assert _before(clocks[reader], me), (op, buffer)
            if buffer in writer:
                assert _before(clocks[writer[buffer]], me), (op, buffer)
        for buffer in op.reads:
            readers[buffer].append(index)
        for buffer in op.writes:
            writer[buffer], readers[buffer] = index, []
            if buffer[0] == "out":
                outs[buffer].append(index)
    join = {}
    for event in ring.joins(ranks):
        for stream, seq in events[event].items():
            join[stream] = max(join.get(stream, 0), seq)
    for buffer, writes in outs.items():
        for index in writes:
            assert _before(clocks[index], (None, join)), buffer


@pytest.mark.parametrize("ranks", [1, 2, 3, 4, 5, 8])
def test_allgather_schedule_moves_every_block_to_every_rank_once(ranks):
    """Following the blocks through the slots: rank r's step s multiplies
    block (r - s) mod R, each rank multiplies every block once and writes
    each output row block once; R^2 step kernels, R(R - 1) copies."""
    held, seen = {}, collections.defaultdict(list)
    counts = collections.Counter(op.kind for op in
                                 ring.allgather_schedule(ranks))
    assert counts["product"] == ranks ** 2
    assert counts["copy"] == ranks * (ranks - 1)
    for op in ring.allgather_schedule(ranks):
        if op.kind == "entry":
            held[op.writes[0]] = op.rank
        elif op.kind == "copy":
            assert op.peer == (op.rank + 1) % ranks
            held[op.writes[0]] = held[op.reads[0]]
        else:
            block = held[op.reads[0]]
            assert block == op.index == (op.rank - op.step) % ranks
            seen[op.rank].append(block)
    for r in range(ranks):
        assert sorted(seen[r]) == list(range(ranks))


@pytest.mark.parametrize("ranks", [1, 2, 3, 4, 5, 8])
def test_reducescatter_schedule_sums_every_partial_once(ranks):
    """Following the partials: rank r's output is the sum of every rank's
    partial of owner r, each once; R^2 step kernels, R(R - 1) copies."""
    held = {}
    schedule = ring.reducescatter_schedule(ranks)
    counts = collections.Counter(op.kind for op in schedule)
    assert counts["product"] == ranks ** 2
    assert counts["copy"] == ranks * (ranks - 1)
    for op in schedule:
        if op.kind == "product":
            held[op.writes[0]] = [(op.rank, op.index)]
        elif op.kind == "copy":
            held[op.writes[0]] = list(held[op.reads[0]])
        elif op.kind == "add":
            total = [item for buffer in op.reads for item in held[buffer]]
            assert len({owner for _, owner in total}) == 1
            held[op.writes[0]] = total
    for r in range(ranks):
        assert sorted(held[("out", r, 0)]) == [(c, r) for c in range(ranks)]


# --------------------------------------------------------------------------- #
# Meshes

def test_mesh_over_an_explicit_device_list():
    mesh = make_mesh(["cpu"] * 4, tp=4)
    assert isinstance(mesh, Mesh) and mesh.size == 4
    assert mesh.ring("tp") == (torch.device("cpu"),) * 4
    assert make_mesh(["cpu"] * 8, dp=2, tp=-1).axes == {"dp": 2, "tp": 4}
    assert MeshSpec().resolve(3) == {"dp": 3}
    with pytest.raises(ValueError):          # the ring needs dp == 1
        make_mesh(["cpu"] * 8, dp=2, tp=4).ring("tp")
    with pytest.raises(ValueError):
        mesh.ring("sp")


def test_mesh_refuses_what_it_cannot_hold():
    with pytest.raises(ValueError):          # more ranks than devices
        make_mesh(["cpu"] * 2, tp=4)
    with pytest.raises(ValueError):          # fewer
        make_mesh(["cpu"] * 8, tp=4)
    with pytest.raises(ValueError):          # CPU and CUDA mixed
        make_mesh(["cpu", "cuda:0"], tp=2)
    with pytest.raises(ValueError):          # two wildcards
        make_mesh(["cpu"] * 4, dp=-1, tp=-1)
    with pytest.raises(ValueError):
        make_mesh([], tp=1)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):    # every card: there is none
            make_mesh(tp=1)
        with pytest.raises(ValueError):      # a card that is not there
            make_mesh(["cuda:0"] * 2, tp=2)
    else:
        with pytest.raises(ValueError):      # more ranks than cards
            make_mesh(tp=torch.cuda.device_count() + 1)
