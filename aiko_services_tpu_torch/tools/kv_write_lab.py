"""Kernel lab: race the KV writer (``csrc/kv_write.cu``) on the card.

Every mode is timed at ``chip_smoke.py``'s phase-2 shapes (llama3_8b: 8
kv heads, head_dim 128, 16-row blocks): the aligned writer (``append_kv``)
at T 256 after 1,024 cached tokens and T 16 after 1,792, the ragged writer
(``append_kv_ragged``) on eight verify windows of T 5, and the row writer
(``write_kv_rows``) at 8 and 64 slots, bf16 and int8 pools.  Times are
CUDA events around back-to-back calls of the port's own wrappers queued
behind a device-side sleep.  Each build is a copy of a kernel source
compiled alone with the port's nvcc flags into ``_build/lab/kv_<label>``;
the wrappers reach it through a library that routes each C entry to the
build under test, so the host path is the port's.

* ``kernel``: this tree's writer.
* ``--compare DIR``: ``other``, the aligned and ragged writers of another
  ``csrc`` tree (``paged_append.cu`` and ``paged_append_ragged.cu``, the
  one-warp-a-vector kernels before the writer was redesigned); the decode
  write there is the eager scatter, the row writer's plain version.
* ``floor`` (and ``other_floor``): an empty kernel launched on the grid
  and block of each design, the back-to-back launch floor of that grid.
* ``--pdl``: the writer followed by the attention kernel that reads the
  pool next (the row writer and ``paged_decode_attention`` a decode layer,
  the aligned writer and ``chunk_attention`` a prefill slice), 32 pairs a
  call, with the sources' programmatic dependent launch (the writer
  triggers its dependents on entry; the attention kernel, launched with
  ``cudaLaunchAttributeProgrammaticStreamSerialization``, waits with
  ``griddepcontrol.wait`` before its first global read) against builds
  with it taken out (:data:`PLAIN_EDITS`), in turns.
* ``--sass``: the 128-bit global loads and stores (``LDG.E.128``,
  ``STG.E.128``) of each writer kernel (``cuobjdump -sass``).
* ``--steps ROOT ...``: the steady 8-slot decode step of this tree and of
  each other repository root, in turns (each in its own process, the
  root's package measured by this tree's ``chip_smoke.steady_decode``):
  llama3_8b with random int8 weights through the contiguous and the paged
  server, bf16 and int8 KV: ms a step unprofiled; under cProfile the host
  microseconds a call of llama's K/V write function; under torch.profiler
  the kernels a step, ``aten::index_put_`` ops a step and the device busy
  share.
* ``--host [ROOT ...]``: the decode write's host microseconds a call
  (:data:`HOST_PROBE`: one step's writes over 32 layers, bare and under
  cProfile) of this tree and each other root, in turns, each in its own
  process.

    python -m aiko_services_tpu_torch.tools.kv_write_lab [--compare DIR]
        [--pdl] [--sass] [--host [ROOT ...]] [--steps ROOT ...]

Needs an NVIDIA card and nvcc.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import json
import pathlib
import re
import shutil
import subprocess
import sys
from typing import Callable, Dict, List

import torch

from ..models import llama
from ..ops import _cuda, paged_attention
from ..ops import paged_prefill as pp

KV, HD, BLOCK, TABLE = 8, 128, 16, 4096
#: The C entries a race routes, by source.  The aligned and ragged
#: writers' entries take the same arguments in the compared tree.
ENTRIES = {"aiko_append_kv": "kv_write.cu",
           "aiko_append_kv_ragged": "kv_write.cu",
           "aiko_write_kv_rows": "kv_write.cu",
           "aiko_paged_decode": "paged_decode.cu",
           "aiko_chunk_attention": "paged_prefill.cu"}
OTHER_SOURCES = {"aiko_append_kv": "paged_append.cu",
                 "aiko_append_kv_ragged": "paged_append_ragged.cu"}
EMPTY_SOURCE = r"""
#include <cuda_runtime.h>
__global__ void empty_kernel() {}
extern "C" int lab_empty(int grid_x, int grid_y, int threads, void* stream) {
  empty_kernel<<<dim3(grid_x, grid_y), threads, 0,
                 static_cast<cudaStream_t>(stream)>>>();
  return cudaGetLastError();
}
"""
#: The plain-launch builds of ``--pdl``: the sources' programmatic
#: dependent launch (common.cuh) taken out, file -> (text, replacement).
PLAIN_EDITS = {"common.cuh": [
    ("  asm volatile(\"griddepcontrol.launch_dependents;\\n\" ::: "
     "\"memory\");\n", ""),
    ("  asm volatile(\"griddepcontrol.wait;\\n\" ::: \"memory\");\n", ""),
    ("attribute[0].val.programmaticStreamSerializationAllowed = 1;",
     "attribute[0].val.programmaticStreamSerializationAllowed = 0;")]}


def build(label: str, csrc: pathlib.Path, source: str, edits=None,
          text: str = None) -> pathlib.Path:
    """``source`` of ``csrc`` (or ``text``) with ``csrc``'s headers and the
    ``edits`` (file name -> (text, replacement) pairs, each text once in
    its file), built alone with the port's nvcc flags into
    ``_build/lab/kv_<label>``; returns the library."""
    work = _cuda.BUILD_DIR / "lab" / f"kv_{label}"
    work.mkdir(parents=True, exist_ok=True)
    texts = {header.name: header.read_text()
             for header in pathlib.Path(csrc).glob("*.cuh")}
    texts[source] = text if text is not None \
        else (pathlib.Path(csrc) / source).read_text()
    for name, pairs in (edits or {}).items():
        for old, new in pairs:
            if texts[name].count(old) != 1:
                raise SystemExit(f"{label}: the edited text is not in {name}")
            texts[name] = texts[name].replace(old, new)
    for name, body in texts.items():
        (work / name).write_text(body)
    built = subprocess.run(
        [_cuda._nvcc(), *_cuda.COMPILE_FLAGS, "-shared", "-I", str(work),
         str(work / source), "-o", str(work / "lib.so")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if built.returncode:
        raise SystemExit(f"{label}: nvcc failed\n{built.stdout}")
    for line in built.stdout.splitlines():
        if "spill" in line and " 0 bytes" not in line:
            print(f"{label}: {line.strip()}", flush=True)
    return work / "lib.so"


class Routed:
    """A stand-in for the port's kernel library: each C entry from the
    library it is routed to, everything else from the port's own."""

    def __init__(self, routes: Dict[str, pathlib.Path]):
        self._base = _cuda.library()
        self._fns = {}
        for entry, path in routes.items():
            fn = getattr(ctypes.CDLL(str(path)), entry)
            fn.argtypes = _cuda.SIGNATURES[entry]
            fn.restype = ctypes.c_int
            self._fns[entry] = fn

    def __getattr__(self, name):
        return self._fns.get(name) or getattr(self._base, name)


@contextlib.contextmanager
def routed(routes: Dict[str, pathlib.Path]):
    """The port's wrappers launch the routed builds while inside."""
    saved = _cuda.library()
    _cuda._LIBRARY = Routed(routes)
    try:
        yield
    finally:
        _cuda._LIBRARY = saved


def device_us(fn: Callable[[], object], reps: int) -> float:
    """Card microseconds of one ``fn()``: CUDA events around ``reps``
    calls queued behind a ~50 ms device-side sleep."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(100_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) * 1e3 / reps


def _pool(gen, device, n_blocks, quant):
    k = torch.randn((n_blocks, BLOCK, KV, HD), generator=gen, device=device)
    v = torch.randn((n_blocks, BLOCK, KV, HD), generator=gen, device=device)
    if quant:
        (k, ks), (v, vs) = llama._kv_quantize(k), llama._kv_quantize(v)
        return dict(k=k, v=v, ks=ks, vs=vs)
    return dict(k=k.to(torch.bfloat16), v=v.to(torch.bfloat16))


def _tables(gen, device, n_blocks, rows, entries):
    ids = torch.randperm(n_blocks - 1, generator=gen,
                         device=device)[:rows * entries] + 1
    return ids.to(torch.int32).reshape(rows, entries).contiguous()


def _ints(values, device):
    return torch.tensor(values, dtype=torch.int32, device=device)


def cases(device) -> List[dict]:
    """The timed cases: name, the call, and the (grid, threads) of each
    design's launch (new, old) for the floors."""
    gen = torch.Generator(device=device).manual_seed(3)
    out = []
    entries = TABLE // BLOCK
    for quant in (False, True):
        label = "int8" if quant else "bf16"
        pool = _pool(gen, device, 4 * entries + 1, quant)
        tables = _tables(gen, device, 4 * entries + 1, 1, entries)
        for cached, T in ((1024, 256), (1792, 16)):
            k, v = (torch.randn((1, T, KV, HD), generator=gen, device=device)
                    .to(torch.bfloat16) for _ in range(2))
            meta = (_ints([cached], device), _ints([T], device))
            out.append(dict(
                name=f"append_kv T={T} after {cached} {label}",
                fn=lambda k=k, v=v, pool=pool, tables=tables, meta=meta:
                pp.append_kv(k, v, pool, tables, *meta),
                grids=((T, 1, KV * 16), (-(-T * KV // 8), 1, 256))))
        starts = (0, 15, 16, 17, 1023, 1030, 40, 5)
        lens = (5, 5, 4, 5, 5, 1, 5, 0)
        ragged_tables = _tables(gen, device, 4 * entries + 1, 8, 67)
        k, v = (torch.randn((8, 5, KV, HD), generator=gen, device=device)
                .to(torch.bfloat16) for _ in range(2))
        meta = (_ints(starts, device), _ints(lens, device))
        out.append(dict(
            name=f"append_kv_ragged 8 rows T=5 {label}",
            fn=lambda k=k, v=v, pool=pool, tables=ragged_tables, meta=meta:
            pp.append_kv_ragged(k, v, pool, tables, *meta),
            grids=((40, 1, KV * 16), (40, 1, 256))))
        for slots in (8, 64):
            n_blocks = slots * entries + 1
            rows_pool = _pool(gen, device, n_blocks, quant)
            rows_tables = _tables(gen, device, n_blocks, slots, entries)
            positions = torch.randint(0, TABLE, (slots,), generator=gen,
                                      device=device, dtype=torch.int32)
            fused = torch.randn((slots, 1, 5 * KV, HD), generator=gen,
                                device=device).to(torch.bfloat16)
            k, v = fused[:, :, 4 * KV:], fused[:, :, :KV].contiguous()
            args = (k, v, rows_pool, rows_tables, positions)
            out.append(dict(
                name=f"write_kv_rows {slots} slots {label}",
                fn=lambda args=args: pp.write_kv_rows(*args),
                plain=lambda args=args: pp.write_kv_rows_reference(*args),
                grids=((slots, 1, KV * 16), None)))
    return out


def run_race(args) -> None:
    device = torch.device("cuda", 0)
    csrc = _cuda.CSRC_DIR
    empty = ctypes.CDLL(str(build("empty", csrc, "empty.cu",
                                  text=EMPTY_SOURCE))).lab_empty
    empty.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int,
                      ctypes.c_void_p]
    stream = torch.cuda.current_stream().cuda_stream
    writer = build("kernel", csrc, "kv_write.cu")
    plans = {"kernel": {entry: writer for entry, source in ENTRIES.items()
                        if source == "kv_write.cu"}}
    if args.compare:
        plans["other"] = {entry: build(f"other_{entry}", args.compare,
                                       source)
                          for entry, source in OTHER_SOURCES.items()}
    timed = cases(device)
    results: Dict[str, Dict[str, List[float]]] = {}
    labels = list(plans) + ["floor"] + (["other_floor"] if args.compare
                                        else []) + ["plain"]
    for turn, order in enumerate((labels, labels[::-1])):
        for label in order:
            for case in timed:
                key = case["name"]
                if label == "plain":
                    fn = case.get("plain")
                elif label.endswith("floor"):
                    grid = case["grids"][label == "other_floor"]
                    fn = grid and (lambda grid=grid: empty(
                        grid[0], grid[1], grid[2], stream))
                elif label == "other" and "plain" in case:
                    fn = None             # no row writer there
                else:
                    fn = case["fn"]
                if fn is None:
                    continue
                with routed(plans.get(label, plans["kernel"])):
                    us = device_us(fn, 200 if label != "plain" else 20)
                results.setdefault(key, {}).setdefault(label, []).append(us)
    print(f"--- µs a call, in turns ({' '.join(labels)}, then reversed); "
          "each cell: turn 1, turn 2")
    for case in timed:
        row = results[case["name"]]
        cells = "  ".join(f"{label} {', '.join(f'{t:.2f}' for t in times)}"
                          for label, times in row.items())
        print(f"  {case['name']}: {cells}", flush=True)
    print("RESULTS " + json.dumps(results), flush=True)


def run_pdl(reps: int = 20) -> None:
    """32 (writer, attention) pairs a call, plain against PDL, in turns."""
    device = torch.device("cuda", 0)
    csrc = _cuda.CSRC_DIR
    builds = {}
    for variant, edits in (("plain", PLAIN_EDITS), ("pdl", None)):
        libraries = {source: build(f"{variant}_{source.split('.')[0]}",
                                   csrc, source, edits)
                     for source in set(ENTRIES.values())}
        builds[variant] = {entry: libraries[source]
                           for entry, source in ENTRIES.items()}
    gen = torch.Generator(device=device).manual_seed(4)
    entries = TABLE // BLOCK
    pairs = {}
    for quant in (False, True):
        label = "int8" if quant else "bf16"
        pool = _pool(gen, device, 8 * entries + 1, quant)
        tables = _tables(gen, device, 8 * entries + 1, 8, entries)
        positions = 1024 + torch.randint(0, 64, (8,), generator=gen,
                                         device=device, dtype=torch.int32)
        k, v = (torch.randn((8, 1, KV, HD), generator=gen, device=device)
                .to(torch.bfloat16) for _ in range(2))
        q = torch.randn((8, KV, 4, HD), generator=gen, device=device) \
            .to(torch.bfloat16)

        def decode(k=k, v=v, pool=pool, tables=tables, positions=positions,
                   q=q):
            for _ in range(32):
                pp.write_kv_rows(k, v, pool, tables, positions)
                paged_attention.paged_decode_attention(
                    q, pool["k"], pool["v"], tables, positions,
                    ks=pool.get("ks"), vs=pool.get("vs"))
        pairs[f"decode layer, 8 slots, {label}"] = decode
        chunk_tables = tables[:1]
        kc, vc = (torch.randn((1, 256, KV, HD), generator=gen, device=device)
                  .to(torch.bfloat16) for _ in range(2))
        qc = torch.randn((1, 256, KV, 4, HD), generator=gen,
                         device=device).to(torch.bfloat16)
        meta = (_ints([1024], device), _ints([256], device))

        def prefill(k=kc, v=vc, pool=pool, tables=chunk_tables, meta=meta,
                    q=qc):
            for _ in range(32):
                pp.append_kv(k, v, pool, tables, *meta)
                pp.chunk_attention(q, pool, tables, *meta, kv_limit=80)
        pairs[f"prefill slice T=256 after 1024, {label}"] = prefill
    times: Dict[str, Dict[str, List[float]]] = {}
    outputs = {}
    for order in (("plain", "pdl"), ("pdl", "plain")):
        for variant in order:
            with routed(builds[variant]):
                for name, fn in pairs.items():
                    us = device_us(fn, reps) / 32
                    times.setdefault(name, {}).setdefault(variant,
                                                          []).append(us)
    # The same bits: one decode layer's attention output, plain and PDL.
    for variant in ("plain", "pdl"):
        with routed(builds[variant]):
            gen.manual_seed(9)
            pool = _pool(gen, device, 4 * entries + 1, True)
            tables = _tables(gen, device, 4 * entries + 1, 2, entries)
            positions = _ints([1030, 77], device)
            k, v = (torch.randn((2, 1, KV, HD), generator=gen,
                                device=device).to(torch.bfloat16)
                    for _ in range(2))
            q = torch.randn((2, KV, 4, HD), generator=gen,
                            device=device).to(torch.bfloat16)
            pp.write_kv_rows(k, v, pool, tables, positions)
            outputs[variant] = paged_attention.paged_decode_attention(
                q, pool["k"], pool["v"], tables, positions, ks=pool["ks"],
                vs=pool["vs"])
    torch.cuda.synchronize()
    same = torch.equal(outputs["plain"], outputs["pdl"])
    print("--- writer + attention, µs a pair (32 pairs a call), in turns "
          f"(plain, pdl, pdl, plain); PDL output bit-equal: {same}")
    for name, row in times.items():
        print(f"  {name}: " + "  ".join(
            f"{variant} {', '.join(f'{t:.2f}' for t in values)}"
            for variant, values in row.items()), flush=True)
    print("PDL " + json.dumps(times), flush=True)
    if not same:
        raise SystemExit("the PDL build changed the attention output")


_SASS_OP = re.compile(r"^\s+/\*[0-9a-f]{4}\*/\s+(.*?)\s*;")


def run_sass() -> None:
    """128-bit global loads and stores of each writer kernel."""
    library = build("kernel", _cuda.CSRC_DIR, "kv_write.cu")
    tool = shutil.which("cuobjdump") or str(
        pathlib.Path(_cuda._nvcc()).parent / "cuobjdump")
    text = subprocess.run([tool, "-sass", str(library)], check=True,
                          capture_output=True, text=True).stdout
    print("--- SASS of the KV writer: LDG.E.128 / STG.E.128 / all LDG, "
          "per kernel")
    for block in text.split("Function : ")[1:]:
        name, body = block.split("\n", 1)
        ops = [m.group(1).split()[0] if not m.group(1).startswith("@")
               else m.group(1).split()[1]
               for m in map(_SASS_OP.match, body.splitlines()) if m]
        ldg128 = sum(op.startswith("LDG.E.128") for op in ops)
        stg128 = sum(op.startswith("STG.E.128") for op in ops)
        ldg = sum(op.startswith("LDG") for op in ops)
        print(f"  {name.strip()}: {ldg128} / {stg128} / {ldg}", flush=True)


#: The steady-step probe one process runs: the package from the root in
#: ``sys.argv[1]``, the measurement from this tree's smoke
#: (``chip_smoke.steady_decode``, at ``sys.argv[2]``): 8 slots, 32
#: steps bare, 16 under cProfile, 16 under torch.profiler.  The smoke's
#: check that no per-layer ``index_put_`` is left in the step is a note
#: here: the tree before the writer has one a layer.
STEP_PROBE = r"""
import importlib.util, json, sys
sys.path.insert(0, sys.argv[1])
spec = importlib.util.spec_from_file_location("chip_smoke", sys.argv[2])
smoke = importlib.util.module_from_spec(spec)
spec.loader.exec_module(smoke)
smoke.fail = lambda message: print("note: " + message, flush=True)
import numpy as np
import torch
from aiko_services_tpu_torch.models import llama
from aiko_services_tpu_torch.ops import quant
from aiko_services_tpu_torch.orchestration.continuous import (
    ContinuousBatchingServer, DecodeRequest)
from aiko_services_tpu_torch.orchestration.paged import PagedContinuousServer
device = torch.device("cuda", 0)
config = llama.CONFIGS["llama3_8b"]
params = llama.random_quantized_params(config, seed=0, device=device)
for layout in ("contiguous", "paged"):
    for quantize_kv in (False, True):
        kwargs = dict(config_name="llama3_8b", slots=8, chunk_steps=2,
                      params=params, quantize=True, quantize_kv=quantize_kv,
                      device=device)
        if layout == "paged":
            make = lambda: PagedContinuousServer(
                max_seq=4096, block_size=16, enable_prefix_cache=True,
                chunk_prefill_tokens=256, **kwargs)
            prompt_len = 1023
        else:
            make = lambda: ContinuousBatchingServer(max_seq=1024, **kwargs)
            prompt_len = 128
        steady = smoke.steady_decode(
            torch, np, smoke.Weights(quant, 8), make, DecodeRequest,
            quantize_kv, config, prompt_len=prompt_len, new_tokens=120)
        print("STEP " + json.dumps(dict(
            root=sys.argv[1], layout=layout,
            kv="int8" if quantize_kv else "bf16", **steady)), flush=True)
        torch.cuda.empty_cache()
"""


#: The decode write's host time, run in a fresh process from a repository
#: root (argv[1]): one 8-slot decode step's K/V writes, llama's write
#: function once for each of 32 layers of llama3_8b's shape (contiguous
#: caches of 1,024 rows, paged pools of 16-row blocks; bf16 and int8 KV;
#: ``k`` a slice of the fused q/k tensor), the step's ``DecodeRows`` made
#: once a step where the tree has them.  Forty windows of one step, each
#: queued behind a device-side sleep so that no call waits on the card
#: (one step of the eager int8-KV write queues ~600 launches, inside the
#: launch queue's depth), in turns bare and under cProfile.  Microseconds
#: a call: the least bare window, and the write function's cumulative
#: time under cProfile over its calls.
HOST_PROBE = r"""
import cProfile, pstats, sys, time
sys.path.insert(0, sys.argv[1])
import torch
from aiko_services_tpu_torch.models import llama
device = torch.device("cuda", 0)
config = llama.CONFIGS["llama3_8b"]
kv, hd, heads = config.n_kv_heads, config.head_dim, config.n_heads
gen = torch.Generator(device=device).manual_seed(0)
fused = torch.randn((8, 1, heads + kv, hd), generator=gen,
                    device=device).to(torch.bfloat16)
k, v = fused[:, :, heads:], fused[:, :, :kv].contiguous()
positions = torch.arange(8, dtype=torch.int32, device=device) * 100 + 5
tables = (torch.arange(8 * 64, dtype=torch.int32, device=device)
          + 1).reshape(8, 64)
rows_api = hasattr(llama, "DecodeRows")
for layout in ("contiguous", "paged"):
    for quantize_kv in (False, True):
        if layout == "contiguous":
            layers = llama.init_cache(config, 8, 1024, quantize_kv=quantize_kv,
                                      device=device)
            write, name = llama._cache_write_rows, "_cache_write_rows"
            if rows_api:
                def step():
                    rows = llama._cache_rows(positions)
                    for layer in layers:
                        write(layer, k, v, rows)
            else:
                def step():
                    for layer in layers:
                        write(layer, k, v, positions)
        else:
            layers = llama.init_paged_cache(config, 8 * 64 + 1, 16,
                                            quantize_kv=quantize_kv,
                                            device=device)
            write, name = llama._paged_write_rows, "_paged_write_rows"
            if rows_api:
                def step():
                    rows = llama.DecodeRows(tables, positions)
                    for layer in layers:
                        write(layer, k, v, rows)
            else:
                def step():
                    for layer in layers:
                        write(layer, k, v, tables, positions)
        for _ in range(5):
            step()
        torch.cuda.synchronize()
        best, profiler = None, cProfile.Profile()
        for window in range(40):
            torch.cuda._sleep(50_000_000)
            start = time.perf_counter()
            if window % 2:
                profiler.enable()
            step()
            if window % 2:
                profiler.disable()
            else:
                host = (time.perf_counter() - start) / len(layers) * 1e6
                best = host if best is None else min(best, host)
            torch.cuda.synchronize()
        calls, cumulative = [(nc, ct) for (_, _, fn), (_, nc, _, ct, _)
                             in pstats.Stats(profiler).stats.items()
                             if fn == name][0]
        print(f"host {sys.argv[1]} {layout} "
              f"{'int8' if quantize_kv else 'bf16'} KV: {best:.2f} us a "
              f"call bare, {cumulative / calls * 1e6:.2f} under cProfile",
              flush=True)
        del layers
        torch.cuda.empty_cache()
"""


def run_host(roots) -> None:
    """``--host``: the decode write's host microseconds a call
    (:data:`HOST_PROBE`) of this tree and each other root, in turns (the
    list, then reversed, twice)."""
    order = [_cuda.PACKAGE_DIR.parent] + [pathlib.Path(root).resolve()
                                          for root in roots]
    for root in (order + order[::-1]) * 2:
        subprocess.run([sys.executable, "-c", HOST_PROBE, str(root)],
                       check=True)


def run_steps(roots) -> None:
    """This tree and each other root in turns (the list, then reversed)."""
    here = _cuda.PACKAGE_DIR.parent
    order = [here] + [pathlib.Path(root).resolve() for root in roots]
    smoke = here / "chip_smoke.py"
    for root in order + order[::-1]:
        subprocess.run([sys.executable, "-c", STEP_PROBE, str(root),
                        str(smoke)], check=True)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--compare", type=pathlib.Path, metavar="DIR",
                        help="a csrc directory with the one-warp-a-vector "
                             "writers (paged_append.cu, "
                             "paged_append_ragged.cu)")
    parser.add_argument("--pdl", action="store_true",
                        help="race writer + attention pairs, plain "
                             "against a programmatic dependent launch")
    parser.add_argument("--sass", action="store_true",
                        help="count the writer kernels' 128-bit accesses")
    parser.add_argument("--steps", nargs="+", metavar="ROOT",
                        help="the steady decode step of this tree and of "
                             "these repository roots, in turns")
    parser.add_argument("--host", nargs="*", metavar="ROOT",
                        help="the decode write's host microseconds a "
                             "call, this tree and these roots in turns")
    parser.add_argument("--no-race", action="store_true",
                        help="skip the writer race")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    if args.sass:
        run_sass()
    if not args.no_race:
        run_race(args)
    if args.pdl:
        run_pdl()
    if args.host is not None:
        run_host(args.host)
    if args.steps:
        run_steps(args.steps)


if __name__ == "__main__":
    main()
