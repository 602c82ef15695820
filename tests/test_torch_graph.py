"""Port parity for the graphed decode chunk's host side, and the decode
K/V write past the end of the cache, on the CPU.

* The decode write at positions ``max_seq - 1``, ``max_seq`` and
  ``max_seq + 3``: the port's plain path (the one a CPU tensor takes)
  against JAX ``models/llama.py`` ``_cache_write_rows`` (a contiguous
  cache: the row clamps to the last one) and ``_paged_write_rows`` (a
  pool: a row past the table is dropped), bf16 and int8 KV, every cache
  and pool byte equal, inputs from a numpy seed.
* The static state's in-place merge, ``llama.scatter_state_rows_``,
  against JAX ``scatter_state_rows``, padding rows that repeat the last
  dirty row included, written into the same tensors.
* The capture ledger's fence against JAX ``obs/compiles.py``
  ``CompileLedger`` on scripted sequences.
* A CPU server never captures; a ``ChunkGraph`` on CPU tensors raises at
  its capture rather than run eagerly.
* The servers' graph wiring (static state adopted after eager rounds,
  dirty rows merged in place, a replay's outputs packed before the next
  one) with the capture stood in for by a replay of the eager program:
  the tokens of the eager chunks, with staggered admissions, retirements,
  mixed steps and speculation rounds between graphed chunks; with adapter
  rows too, a load that widens the stack releasing the older stack's
  graphs.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aiko_services_tpu.models import llama as jax_llama
from aiko_services_tpu.obs.compiles import CompileLedger
from aiko_services_tpu.obs.metrics import MetricsRegistry
from aiko_services_tpu_torch.models import llama, lora
from aiko_services_tpu_torch.obs.compiles import CaptureLedger
from aiko_services_tpu_torch.ops import _cuda, quant
from aiko_services_tpu_torch.ops import paged_prefill as pp
from aiko_services_tpu_torch.orchestration.continuous import (
    ContinuousBatchingServer, DecodeRequest)
from aiko_services_tpu_torch.orchestration.paged import (
    PagedContinuousServer)
from aiko_services_tpu_torch.tools import loadgen


@pytest.fixture(scope="module", autouse=True)
def _leave_jax_caches_cold():
    """Later test modules in the same worker count their own JAX
    compiles; drop what this module compiled once it is done."""
    yield
    jax.clear_caches()


# --------------------------------------------------------------------------- #
# The decode write past the end

#: (max_seq - 1, max_seq, max_seq + 3): the last row, and two past it.
PAST = {"last": -1, "end": 0, "past": 3}


def _configs():
    """tiny (kv 2, head_dim 32) in bf16, both packages."""
    return jax_llama.CONFIGS["tiny"], llama.CONFIGS["tiny"]


def _rows(seed, batch):
    rng = np.random.default_rng(seed)
    k = rng.standard_normal((batch, 1, 2, 32)).astype(np.float32)
    v = rng.standard_normal((batch, 1, 2, 32)).astype(np.float32)
    return ((torch.from_numpy(k).to(torch.bfloat16),
             torch.from_numpy(v).to(torch.bfloat16)),
            (jnp.asarray(k).astype(jnp.bfloat16),
             jnp.asarray(v).astype(jnp.bfloat16)))


def _assert_bytes_equal(got, want):
    assert set(got) == set(want)
    for key, buf in got.items():
        have = buf.float().numpy() if buf.dtype == torch.bfloat16 \
            else buf.numpy()
        ref = np.asarray(want[key])
        ref = ref.astype(np.float32) if ref.dtype == jnp.bfloat16 else ref
        np.testing.assert_array_equal(have, ref, err_msg=key)


@pytest.mark.parametrize("where", sorted(PAST))
@pytest.mark.parametrize("quantize_kv", [False, True])
def test_cache_write_past_the_end_matches_jax(quantize_kv, where):
    """Three slots of a 40-row contiguous cache: slot 0 at ``40 +
    PAST[where]``, the others inside.  JAX's ``dynamic_update_slice``
    clamps slot 0's row to 39; the port's plain write does too (never
    row 0, the first prompt token's)."""
    jax_config, config = _configs()
    max_seq = 40
    jax_cache = jax_llama.init_cache(jax_config, 3, max_seq,
                                     quantize_kv=quantize_kv)[0]
    cache = llama.init_cache(config, 3, max_seq, quantize_kv=quantize_kv,
                             device="cpu")[0]
    (k, v), (jk, jv) = _rows(11, 3)
    positions = np.array([max_seq + PAST[where], 17, 0], np.int32)
    want = jax_llama._cache_write_rows(jax_cache, jk, jv,
                                       jnp.asarray(positions))
    rows = llama._cache_rows(torch.from_numpy(positions))
    assert rows.clamp
    assert llama._cache_write_rows(cache, k, v, rows) is cache
    _assert_bytes_equal(cache, want)
    assert bool(cache["k"][0, max_seq - 1].any())
    assert not bool(cache["k"][0, 0].any())
    plain = llama.init_cache(config, 3, max_seq, quantize_kv=quantize_kv,
                             device="cpu")[0]
    pp.write_kv_rows(k, v, plain, rows.tables, rows.positions, clamp=True)
    _assert_bytes_equal(plain, want)


@pytest.mark.parametrize("where", sorted(PAST))
@pytest.mark.parametrize("quantize_kv", [False, True])
def test_paged_write_past_the_end_matches_jax(quantize_kv, where):
    """Three slots of two-entry tables over a 9-block pool of 16-row
    blocks (32 rows a slot): slot 0 at ``32 + PAST[where]``, the others
    inside.  JAX's gather out of the table yields no block and its scatter
    drops the row; the port's plain write drops it too (never a live row
    of the slot's last block)."""
    jax_config, config = _configs()
    max_seq = 32
    jax_pool = jax_llama.init_paged_cache(jax_config, 9, 16,
                                          quantize_kv=quantize_kv)[0]
    pool = llama.init_paged_cache(config, 9, 16, quantize_kv=quantize_kv,
                                  device="cpu")[0]
    (k, v), (jk, jv) = _rows(12, 3)
    tables = np.array([[3, 7], [5, 2], [1, 4]], np.int32)
    positions = np.array([max_seq + PAST[where], 20, 4], np.int32)
    want = jax_llama._paged_write_rows(jax_pool, jk, jv, jnp.asarray(tables),
                                       jnp.asarray(positions))
    rows = pp.DecodeRows(torch.from_numpy(tables),
                         torch.from_numpy(positions))
    assert not rows.clamp
    assert llama._paged_write_rows(pool, k, v, rows) is pool
    _assert_bytes_equal(pool, want)
    written = bool(pool["k"][7, 15].any())
    assert written == (where == "last")
    assert not bool(pool["k"][7, :15].any())


# --------------------------------------------------------------------------- #
# The static state's in-place merge

#: Dirty rows as the server pads them (repeating the last one).
MERGES = {"one": [3], "padded": [0, 5, 6, 6], "all": list(range(8))}


def _state(seed, slots=8, max_blocks=4):
    rng = np.random.default_rng(seed)
    return dict(
        token=rng.integers(0, 1024, (slots, 1)).astype(np.int32),
        positions=rng.integers(0, 60, slots).astype(np.int32),
        active=rng.random(slots) < 0.5,
        remaining=rng.integers(0, 30, slots).astype(np.int32),
        temps=rng.random(slots).astype(np.float32),
        tops=rng.random(slots).astype(np.float32),
        tables=rng.integers(0, 9, (slots, max_blocks)).astype(np.int32))


@pytest.mark.parametrize("leaves", ["structural", "sampling"])
@pytest.mark.parametrize("merge", sorted(MERGES))
def test_in_place_state_merge_matches_jax(merge, leaves):
    """The in-place merge writes JAX's values into the same tensors (a
    sampling edit only the temps and tops); the out-of-place port merge
    agrees."""
    state, update = _state(1), _state(2)
    rows = np.asarray(MERGES[merge], np.int64)
    keys = sorted(state) if leaves == "structural" else ["temps", "tops"]
    packet = {key: update[key][rows] for key in keys}
    # JAX merges a packet into the leaves it carries (a sampling edit
    # into a state of temps and tops).
    want = dict(state, **jax_llama.scatter_state_rows(
        {key: jnp.asarray(state[key]) for key in keys},
        jnp.asarray(rows), {key: jnp.asarray(value)
                            for key, value in packet.items()}))
    tensors = {key: torch.from_numpy(value.copy())
               for key, value in state.items()}
    ids = {key: id(value) for key, value in tensors.items()}
    got = llama.scatter_state_rows_(
        tensors, torch.from_numpy(rows),
        {key: torch.from_numpy(value) for key, value in packet.items()})
    assert got is tensors
    assert {key: id(value) for key, value in got.items()} == ids
    out_of_place = llama.scatter_state_rows(
        {key: torch.from_numpy(value) for key, value in state.items()},
        torch.from_numpy(rows),
        {key: torch.from_numpy(value) for key, value in packet.items()})
    for key in state:
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]),
                                      err_msg=key)
        np.testing.assert_array_equal(out_of_place[key].numpy(),
                                      got[key].numpy(), err_msg=key)


# --------------------------------------------------------------------------- #
# The capture ledger

SCRIPTS = {
    "warm_then_steady": ["c", "c", "fence", "c", "c"],
    "fence_twice_and_lift": ["fence", "c", "fence", "lift", "c", "c",
                             "fence", "c"],
    "never_fenced": ["c", "lift", "c"],
}


@pytest.mark.parametrize("script", sorted(SCRIPTS))
def test_capture_ledger_fence_matches_compile_ledger(script):
    """Each capture is a compile: captures and steady captures equal the
    JAX ledger's compiles and steady compiles after every event."""
    reference = CompileLedger(service="test", registry=MetricsRegistry())
    ledger = CaptureLedger()
    for event in SCRIPTS[script]:
        if event == "c":
            reference.record_compile(1.0, program="serve_chunk")
            ledger.record_capture()
            ledger.record_replay()
        elif event == "fence":
            reference.fence()
            ledger.fence()
        else:
            reference.lift_fence()
            ledger.lift_fence()
        assert (ledger.captures, ledger.steady_captures, ledger.fenced) == (
            reference.compiles, reference.steady_compiles, reference.fenced)
    counters = ledger.counters()
    assert counters == dict(graph_captures=reference.compiles,
                            graph_replays=ledger.replays,
                            graph_captures_steady_state=(
                                reference.steady_compiles))


def test_take_back_and_add_launches():
    """A capture's launch increments are taken back and added once a
    replay, on the wrappers' own counters."""
    assert quant.int8_matmul in _cuda.COUNTED
    assert pp.write_kv_rows in _cuda.COUNTED
    saved = _cuda.launch_counts()
    try:
        before = _cuda.launch_counts()
        quant.int8_matmul.launches += 7
        pp.write_kv_rows.launches += 2
        delta = _cuda.take_back(before)
        assert delta == {quant.int8_matmul: 7, pp.write_kv_rows: 2}
        assert _cuda.launch_counts() == before
        _cuda.add_launches(delta)
        _cuda.add_launches(delta)
        assert quant.int8_matmul.launches == before[quant.int8_matmul] + 14
        assert pp.write_kv_rows.launches == before[pp.write_kv_rows] + 4
    finally:
        for wrapper, count in saved.items():
            wrapper.launches = count


# --------------------------------------------------------------------------- #
# The servers

LAYOUTS = {
    "contiguous": (ContinuousBatchingServer, dict(max_seq=96)),
    "paged": (PagedContinuousServer,
              dict(max_seq=96, block_size=16, enable_prefix_cache=True,
                   chunk_prefill_tokens=16)),
    "paged_spec": (PagedContinuousServer,
                   dict(max_seq=96, block_size=16, chunk_prefill_tokens=16,
                        draft_mode="ngram", spec_k=2, spec_adaptive=True)),
}
SPECS = [(5, 9), (40, 4), (3, 12), (33, 6), (12, 3), (21, 8)]


def _traffic(server, seed, eos_id=None):
    """Three waves of two requests, the next wave after two steps:
    admissions, retirements and (paged) mixed steps between chunks."""
    rng = np.random.default_rng(seed)
    requests = [DecodeRequest(f"r{i}", rng.integers(1, 1024, plen)
                              .astype(np.int32), new)
                for i, (plen, new) in enumerate(SPECS)]
    for start in range(0, len(requests), 2):
        for request in requests[start:start + 2]:
            server.submit(request)
        for _ in range(2):
            server.step()
    server.run_until_drained()
    return requests


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_cpu_servers_never_capture(layout):
    """On CPU tensors the servers run the eager chunk: no static state,
    no graph, no capture or replay counted."""
    cls, kwargs = LAYOUTS[layout]
    server = cls(config_name="tiny", slots=2, chunk_steps=3, seed=3,
                 device="cpu", **kwargs)
    assert server._static_state is None and not server._graphs_on
    requests = _traffic(server, 4)
    assert all(len(r.tokens) == r.max_new_tokens for r in requests)
    assert server._chunk_graph is None
    stats = server.stats()
    assert (stats["graph_captures"], stats["graph_replays"],
            stats["graph_captures_steady_state"]) == (0, 0, 0)


def test_chunk_graph_on_the_cpu_raises_at_capture():
    """The first chunk of a key runs eagerly (its warm-up); the second
    would capture, and on CPU tensors it raises instead of running
    eagerly again."""
    server = ContinuousBatchingServer(config_name="tiny", slots=2,
                                      max_seq=64, chunk_steps=2, seed=3,
                                      device="cpu")
    ledger = CaptureLedger()
    graph = llama.ChunkGraph(server.params, server.config, server.cache,
                             server._state, False, ledger)
    assert graph.key(2, -1) == ("contiguous", 2, 2, "torch.bfloat16", -1,
                                str(torch.bfloat16))
    tokens, counts = graph.run(2)
    assert tokens.shape == (2, 2) and counts.shape == (2,)
    with pytest.raises(ValueError, match="card"):
        graph.run(2)
    assert (ledger.captures, ledger.replays) == (0, 0)


class _EagerReplay:
    """Stands in for a captured graph on the CPU: a replay runs the eager
    program into the output buffers made at the capture, which, like a
    real capture, ran nothing."""

    def __init__(self, program, outputs):
        self.program, self.outputs = program, outputs

    def replay(self):
        tokens, counts = self.program()
        self.outputs[0].copy_(tokens)
        self.outputs[1].copy_(counts)


def _replayed_capture(self, num_steps, eos_id, lora_shared=None):
    slots = self.state["token"].shape[0]
    outputs = (torch.full((slots, num_steps), -7, dtype=torch.int32),
               torch.full((slots,), -7, dtype=torch.int32))
    self.ledger.record_capture()
    return (_EagerReplay(lambda: self._program(num_steps, eos_id,
                                               lora_shared), outputs),
            outputs, {}, ())


@pytest.mark.parametrize("eos", [None, 17])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_server_graph_wiring_keeps_the_eager_tokens(monkeypatch, layout,
                                                    eos):
    """Greedy chunks through the servers' graph path (the capture stood in
    for by a replay of the eager program, the state's tensors made the
    static buffers) give the eager server's tokens, under staggered
    admissions, retirements, mixed steps and speculation rounds; each key
    warms up once eagerly, captures once and replays after."""
    monkeypatch.setattr(llama.ChunkGraph, "_capture", _replayed_capture)
    cls, kwargs = LAYOUTS[layout]
    kwargs = dict(kwargs, config_name="tiny", slots=2, chunk_steps=3,
                  seed=3, device="cpu", eos_id=eos)
    eager = cls(**kwargs)
    want = _traffic(eager, 4)
    graphed = cls(**kwargs)
    graphed._static_state = graphed._state
    graphed._graphs_on = True
    static = {key: id(value) for key, value in graphed._state.items()}
    got = _traffic(graphed, 4)
    assert [r.tokens for r in got] == [r.tokens for r in want]
    assert {key: id(value)
            for key, value in graphed._static_state.items()} == static
    stats = graphed.stats()
    keys = graphed._chunk_graph._graphs
    assert stats["graph_captures"] == sum(v is not None
                                          for v in keys.values())
    assert stats["graph_replays"] > 0
    assert stats["graph_captures_steady_state"] == 0
    assert stats["decode_steps"] == eager.stats()["decode_steps"]
    if layout == "paged":
        assert stats["prefill_slices_mixed"] > 0
    if layout == "paged_spec":
        assert stats["spec_rounds"] > 0
    if eos is not None:
        assert all(k[4] == eos for k in keys)


def _tenant_traffic(server, tenant, seed):
    """Two waves of two requests on one tenant's adapter, as _traffic."""
    rng = np.random.default_rng(seed)
    requests = [DecodeRequest(f"{tenant}{i}", rng.integers(1, 1024, plen)
                              .astype(np.int32), new, adapter=tenant)
                for i, (plen, new) in enumerate(SPECS[:4])]
    for start in range(0, len(requests), 2):
        for request in requests[start:start + 2]:
            server.submit(request)
        for _ in range(2):
            server.step()
    server.run_until_drained()
    return requests


@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_graph_wiring_with_adapters_releases_the_older_stacks_graphs(
        monkeypatch, layout):
    """Adapter rows through the servers' graph path (the capture stood in
    for as above) give the eager server's tokens; a load that widens the
    stack gives the chunks a new ``lora_key``, and the graphs captured
    under the older stack are released while the new key warms up,
    captures and replays."""
    monkeypatch.setattr(llama.ChunkGraph, "_capture", _replayed_capture)
    cls, kwargs = LAYOUTS[layout]
    kwargs = dict(kwargs, config_name="tiny", slots=2, chunk_steps=3,
                  seed=3, device="cpu")
    config = llama.CONFIGS["tiny"]
    lc = lora.LoRAConfig(rank=4, alpha=8.0, targets=("wq", "wv"))
    factors = [loadgen._noisy_loadgen_adapter(config, lc, 100 + i)
               for i in range(2)]
    runs = []
    for graphs in (False, True):
        server = cls(**kwargs)
        if graphs:
            server._static_state = server._state
            server._graphs_on = True
        server.load_adapter("t0", factors[0], lc)
        first = _tenant_traffic(server, "t0", 5)
        keys = {} if not graphs else dict(server._chunk_graph._graphs)
        captures = server.stats()["graph_captures"]
        server.load_adapter("t1", factors[1], lc)
        second = _tenant_traffic(server, "t1", 6)
        runs.append((server, first + second, keys, captures))
    (eager, want, _, _), (graphed, got, old, captures) = runs
    assert [r.tokens for r in got] == [r.tokens for r in want]
    assert all(len(r.tokens) == r.max_new_tokens for r in got)
    old_keys = {key for key in old if len(key) == 7}
    assert old_keys and captures > 0
    keys = graphed._chunk_graph._graphs
    new_keys = {key for key in keys if len(key) == 7}
    assert new_keys and not new_keys & old_keys
    assert {key[-1] for key in new_keys} == {
        graphed._lora_graph_key(graphed._lora_shared)}
    assert graphed.stats()["graph_captures"] > captures
