#!/usr/bin/env python3
"""Time the S-expression codec's canonical-form test on a KV export
message: the port's ``sexpr._needs_canonical`` (``in`` scans on ASCII
symbols) against the single character-class regular expression
(``sexpr._DELIMITER.search``) it stands in for.

The message is a ``(kv_export_response …)`` as a replica sends it: an
export payload of ``--blocks`` blocks of llama3_8b's KV (32 layers, 8 KV
heads of 128, 16-row blocks, bf16 K and V as uint16 bit patterns, random
normal values from ``--seed``) through ``encode_swag``.  Host only; needs
numpy and the port's package, no card.

    python3 scripts/codec_scan.py [--blocks 64] [--repeats 3]

Prints one JSON line: the message's bytes, the best time of each scan
over all of its symbols, and of ``generate`` with each, in ms, and the
host's CPU model.
"""

import argparse
import json
import pathlib
import sys
import time

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

from aiko_services_tpu_torch.pipeline.codec import encode_swag  # noqa: E402
from aiko_services_tpu_torch.utils import sexpr  # noqa: E402


def export_payload(blocks, layers, kv_heads, head_dim, block_size, seed):
    rng = np.random.default_rng(seed)
    payload = {"kv_keys": ["%064x" % key for key in range(blocks)],
               "kv_parent": "", "kv_start_depth": 0,
               "kv_block_size": block_size,
               "kv_sig": f"{layers}:{kv_heads}:{head_dim}:0:bfloat16",
               "kv_dtype": "bfloat16"}
    shape = (blocks, block_size, kv_heads, head_dim)
    for layer in range(layers):
        for name in ("k", "v"):
            values = rng.standard_normal(shape, dtype=np.float32)
            payload[f"kv_l{layer}_{name}"] = (
                values.view(np.uint32) >> 16).astype(np.uint16)
    return payload


def regex_only(symbol):
    if symbol[:1] in ("'", '"') or symbol.endswith(":") \
            or sexpr._LENGTH_PREFIX.match(symbol) is not None:
        return True
    return sexpr._DELIMITER.search(symbol) is not None


def best_ms(function, repeats):
    times = []
    for _ in range(repeats):
        began = time.perf_counter()
        function()
        times.append((time.perf_counter() - began) * 1e3)
    return min(times)


def cpu_model():
    try:
        for line in open("/proc/cpuinfo"):
            if line.startswith("model name"):
                return line.split(":", 1)[1].strip()
    except OSError:
        pass
    return "unknown"


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--blocks", type=int, default=64)
    parser.add_argument("--layers", type=int, default=32)
    parser.add_argument("--repeats", type=int, default=3)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()
    payload = export_payload(args.blocks, args.layers, 8, 128, 16, args.seed)
    swag = encode_swag(payload)
    symbols = list(swag.values())
    scans = {}
    for name, test in (("in_scans", sexpr._needs_canonical),
                       ("regex", regex_only)):
        answers = [test(symbol) for symbol in symbols]
        scans[name] = (answers, best_ms(
            lambda test=test: [test(symbol) for symbol in symbols],
            args.repeats))
    if scans["in_scans"][0] != scans["regex"][0]:
        raise SystemExit("the two scans disagree")
    message = sexpr.generate("kv_export_response", ["t", swag])
    generate_ms = {}
    kept = sexpr._needs_canonical
    try:
        for name, test in (("in_scans", kept), ("regex", regex_only)):
            sexpr._needs_canonical = test
            if sexpr.generate("kv_export_response", ["t", swag]) != message:
                raise SystemExit(f"{name}: another message")
            generate_ms[name] = best_ms(
                lambda: sexpr.generate("kv_export_response", ["t", swag]),
                args.repeats)
    finally:
        sexpr._needs_canonical = kept
    print(json.dumps(dict(
        blocks=args.blocks, layers=args.layers,
        payload_bytes=int(sum(value.nbytes for value in payload.values()
                              if isinstance(value, np.ndarray))),
        message_bytes=len(message),
        scan_ms={name: value[1] for name, value in scans.items()},
        generate_ms=generate_ms, repeats=args.repeats, cpu=cpu_model())))


if __name__ == "__main__":
    main()
