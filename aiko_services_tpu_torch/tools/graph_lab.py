"""Graph lab: a server's serving run with its chunk graphs on and off, in
turns, on one card.

Each turn builds a fresh server on the same random llama3_8b weights (int8,
or int4 with ``--int4``; 8 slots, 2-step chunks, bf16 KV; the contiguous
server with a 1,024-row cache, or with ``--paged`` the paged server with
4,096-row tables of 16-row blocks, the prefix cache and 256-token slices)
and serves ``chip_smoke.py``'s phase-3 traffic: ten requests of 64-700
prompt tokens, 32 new tokens each, in three waves three steps apart.  The
arms:

* ``graphs``: the chunk graphs on (the servers' default on the card);
* ``eager``: off, through the private switch ``_graphs_on``;
* ``bare`` (with ``--bare``): on, each capture made by
  ``CUDAGraph.capture_begin`` / ``capture_end`` on a side stream after a
  synchronise, without the ``gc.collect()`` and
  ``torch.cuda.empty_cache()`` that ``torch.cuda.graph`` runs first.

A turn prints TTFT p50 and max, served tok/s, decode steps, dispatches,
graph captures and replays, and the host ms spent capturing; the arms run
in turns (the list, then reversed, ``--turns`` times), after one warm-up
request on a server of their own.

    python -m aiko_services_tpu_torch.tools.graph_lab [--paged] [--int4]
        [--bare] [--turns N]

Needs an NVIDIA card and nvcc.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import subprocess
import time

import numpy as np
import torch

from ..models import llama
from ..ops import _cuda
from ..orchestration.continuous import ContinuousBatchingServer, DecodeRequest
from ..orchestration.paged import PagedContinuousServer

#: chip_smoke.py's phase-3 traffic.
PROMPTS = [64, 700, 128, 333, 512, 97, 640, 250, 180, 420]
NEW_TOKENS, SLOTS, CHUNK_STEPS = 32, 8, 2


def make_server(params, paged: bool, device):
    kwargs = dict(config_name="llama3_8b", slots=SLOTS,
                  chunk_steps=CHUNK_STEPS, params=params, quantize=True,
                  device=device)
    if paged:
        return PagedContinuousServer(max_seq=4096, block_size=16,
                                     enable_prefix_cache=True,
                                     chunk_prefill_tokens=256, **kwargs)
    return ContinuousBatchingServer(max_seq=1024, **kwargs)


def bare_capture(self, num_steps, eos_id):
    """``ChunkGraph._capture`` without ``torch.cuda.graph``'s collection
    and cache release: a synchronise, then the capture on a side stream."""
    device = self.state["token"].device
    before = _cuda.launch_counts()
    graph = torch.cuda.CUDAGraph()
    torch.cuda.synchronize()
    stream = torch.cuda.Stream(device)
    try:
        with torch.cuda.stream(stream):
            graph.capture_begin()
            try:
                outputs = self._program(num_steps, eos_id)
            finally:
                graph.capture_end()
    finally:
        launches = _cuda.take_back(before)
    torch.cuda.current_stream(device).wait_stream(stream)
    self.ledger.record_capture()
    return graph, outputs, launches, _cuda.scratch_buffers(device)


@contextlib.contextmanager
def timed_captures(arm: str, capture_ms):
    """Every capture of the turn timed on the host (the ``bare`` arm's by
    :func:`bare_capture`)."""
    original = llama.ChunkGraph._capture
    inner = bare_capture if arm == "bare" else original

    def timed(self, num_steps, eos_id):
        began = time.perf_counter()
        out = inner(self, num_steps, eos_id)
        capture_ms.append((time.perf_counter() - began) * 1e3)
        return out
    llama.ChunkGraph._capture = timed
    try:
        yield
    finally:
        llama.ChunkGraph._capture = original


def serve_turn(server, arm: str, vocab: int):
    server._graphs_on = arm != "eager"
    rng = np.random.default_rng(7)
    requests = [DecodeRequest(f"r{i}", rng.integers(1, vocab, plen)
                              .astype(np.int32), NEW_TOKENS)
                for i, plen in enumerate(PROMPTS)]
    capture_ms = []
    with timed_captures(arm, capture_ms):
        torch.cuda.synchronize()
        began = time.monotonic()
        for batch in (requests[:5], requests[5:8], requests[8:]):
            for request in batch:
                server.submit(request)
            for _ in range(3):
                server.step()
        server.run_until_drained()
        torch.cuda.synchronize()
        wall = time.monotonic() - began
    ttfts = sorted((r.first_token_ts - r.submitted_ts) * 1e3
                   for r in requests)
    stats = server.stats()
    return dict(arm=arm, ttft_ms_p50=ttfts[len(ttfts) // 2],
                ttft_ms_max=ttfts[-1],
                served_tok_s=sum(len(r.tokens) for r in requests) / wall,
                wall_s=wall, decode_steps=stats["decode_steps"],
                dispatches=stats["dispatches"],
                graph_captures=stats["graph_captures"],
                graph_replays=stats["graph_replays"],
                capture_host_ms=capture_ms)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--paged", action="store_true",
                        help="the paged server (default: contiguous)")
    parser.add_argument("--int4", action="store_true",
                        help="int4 weights (default: int8)")
    parser.add_argument("--bare", action="store_true",
                        help="add the arm that captures without "
                             "torch.cuda.graph's gc and cache release")
    parser.add_argument("--turns", type=int, default=1,
                        help="repeat the arms (list, then reversed)")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    device = torch.device("cuda", 0)
    config = llama.CONFIGS["llama3_8b"]
    params = llama.random_quantized_params(config, seed=0,
                                           bits=4 if args.int4 else 8,
                                           device=device)
    warm = make_server(params, args.paged, device)
    warm.submit(DecodeRequest("warm", np.arange(1, 101, dtype=np.int32), 4))
    warm.run_until_drained()
    del warm
    arms = ["graphs", "eager"] + (["bare"] if args.bare else [])
    rows = []
    for arm in (arms + arms[::-1]) * args.turns:
        row = serve_turn(make_server(params, args.paged, device), arm,
                         config.vocab_size)
        row.update(layout="paged" if args.paged else "contiguous",
                   weights="int4" if args.int4 else "int8")
        print("TURN " + json.dumps(row), flush=True)
        rows.append(row)
    for arm in arms:
        mine = [row for row in rows if row["arm"] == arm]
        print(f"{arm}: TTFT p50 ms "
              f"{[round(r['ttft_ms_p50'], 1) for r in mine]}, served tok/s "
              f"{[round(r['served_tok_s'], 1) for r in mine]}", flush=True)


if __name__ == "__main__":
    main()
