#!/usr/bin/env python3
"""Race versions of the ring step kernels at the smoke's ring shapes.

    python3 scripts/ring_step_lab.py [--turns N] [--ctas C ...]
                                     [--parent DIR] [NAME ...]

Each named variant is a copy of ``aiko_services_tpu_torch`` under
``_build/ring_lab/NAME`` with one edit (VARIANTS); ``change`` is the tree
as it stands; ``--parent DIR`` adds the package of another checkout (an
unpacked ``git archive`` of an earlier commit, whose step kernels take no
split scratch).  Every tree runs in a process of its own, in turns (the
parent, change, the variants, then the same in reverse, ``--turns``
times), and prints for every case of ``chip_smoke.RING_CASES`` (first
llama3_8b's TP-4 MLP calls, w_gate all-gather and w_down reduce-scatter at
m = 2048 and 64, four ranks on one card; then the JAX tests' shapes on
eight) the whole call's ms under two windows, both from this tree's
``chip_smoke.device_ms``: phase 7's (ten calls behind a ~0.2 s device
sleep, after a window that warms the allocator) and the window phase 7
used before it (ten calls behind a ~50 ms sleep, no warm-up window); each
``(host)`` where the sleep ended before the host had enqueued the ten
calls, so the window timed the host.  For the four main calls also rank
0's step kernel alone on one stream and the call's max abs error against
``torch.mm`` in f32.  ``--ctas`` also runs the tree as it stands with each
given share of the SMs for a rank (the streamed-weight path splits K over
it) in place of the card's SMs over the ranks.  Needs an NVIDIA card and
nvcc.
"""

import argparse
import importlib.util
import pathlib
import shutil
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
RING = "aiko_services_tpu_torch/csrc/ring_matmul.cu"
RING_HOST = "aiko_services_tpu_torch/parallel/rdma_collective.py"
#: name -> (source, text replaced, replacement)
VARIANTS = {
    # The streamed-weight path's 64-row instance on mma.sync, as the
    # instances below 64 rows.
    "mma_sync_at_64": (
        RING, "constexpr bool uses_wgmma(int mr) { return mr == 64; }",
        "constexpr bool uses_wgmma(int mr) { return false; }"),
    # A new split scratch every call (zero-filled on the caller's stream
    # ahead of the ring) instead of each rank's kept one.
    "scratch_per_call": (
        RING_HOST, "_ctas(d, sharing[d]), r)", "_ctas(d, sharing[d]))"),
}


def make_copy(name: str, workdir: pathlib.Path) -> pathlib.Path:
    copy = workdir / name
    shutil.rmtree(copy, ignore_errors=True)
    shutil.copytree(ROOT / "aiko_services_tpu_torch",
                    copy / "aiko_services_tpu_torch",
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    source, old, new = VARIANTS[name]
    text = (copy / source).read_text()
    if text.count(old) != 1:
        raise SystemExit(f"{name}: the edited line is not in {source}")
    (copy / source).write_text(text.replace(old, new))
    return copy


def _chip_smoke():
    """This tree's chip_smoke.py, whichever tree's package is measured."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _step(torch, rc, _cuda, kind, a, w, target, ranks, device):
    """A function that enqueues step 1 of rank 0 alone: through
    ``launch_step`` with a rank's split scratch where the tree has one,
    else through the step entries as they were before the split."""
    if hasattr(rc, "launch_step"):
        scratch = rc.step_scratch(device, rc._ctas(device, ranks))
        return lambda: rc.launch_step(kind, a, w, target, 1, scratch)
    code = _cuda.DTYPE_CODES[a.dtype]
    if kind == "ag":
        m_local, k = a.shape
        args = (m_local, k, w.shape[1], m_local, code)
    else:
        m, k_local = a.shape
        n_local = target.shape[1]
        args = (m, k_local, w.shape[1], n_local, n_local, code)
    return lambda: _cuda.launch(f"aiko_ring_{kind}_step", device,
                                a.data_ptr(), w.data_ptr(),
                                target.data_ptr(), *args)


def measure(ctas) -> str:
    """Run in a tree's root: every ring case, one line."""
    sys.path.insert(0, str(pathlib.Path.cwd()))
    import torch

    chip_smoke = _chip_smoke()
    from aiko_services_tpu_torch import parallel
    from aiko_services_tpu_torch.ops import _cuda
    from aiko_services_tpu_torch.parallel import collective_matmul as cm
    from aiko_services_tpu_torch.parallel import rdma_collective as rc
    _cuda.build()
    torch.backends.cuda.matmul.allow_tf32 = False
    if ctas:
        rc._ctas = lambda device, sharing: ctas
    device = torch.device("cuda", 0)
    cells = []
    for index, (kind, label, ranks, m, k, n, dtype) in enumerate(
            chip_smoke.RING_CASES):
        devices = parallel.make_mesh([device] * ranks, tp=ranks).ring("tp")
        x, w = chip_smoke.ring_operands(torch, device, m, k, n,
                                        getattr(torch, dtype), 0)
        x_dim, w_dim = (0, 1) if kind == "ag" else (1, 0)
        xs, ws = cm.shard(x, x_dim, devices), cm.shard(w, w_dim, devices)
        fn = rc.rdma_allgather_matmul if kind == "ag" \
            else rc.rdma_matmul_reducescatter
        got = cm.unshard(fn(xs, ws), 1, device).float()
        err = float((got - x.float() @ w.float()).abs().max())
        windows = []
        now = {}
        for _ in range(2):                   # the first warms the allocator
            call = chip_smoke.device_ms(torch, lambda: fn(xs, ws), 10,
                                        chip_smoke.RING_SLEEP_CYCLES, now)
        windows.append((call, now["host_bound"]))
        before = {}
        call = chip_smoke.device_ms(torch, lambda: fn(xs, ws), 10,
                                    timing=before)
        windows.append((call, before["host_bound"]))
        cell = f"{kind} {label} R={ranks} m={m}: call " + " / ".join(
            f"{ms:.4f}" + (" (host)" if bound else "")
            for ms, bound in windows)
        if index < 4:
            dt = getattr(torch, dtype) if kind == "ag" else torch.float32
            target = torch.empty((m, n // ranks), dtype=dt, device=device)
            step = chip_smoke.device_ms(
                torch, _step(torch, rc, _cuda, kind, xs[0], ws[0], target,
                             ranks, device), 20)
            cell += f" step {step:.4f} err {err:.4f}"
        cells.append(cell)
    return " | ".join(cells)


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("names", nargs="*", choices=[[], *sorted(VARIANTS)],
                        metavar="NAME", help="variants (none by default)")
    parser.add_argument("--turns", type=int, default=1)
    parser.add_argument("--ctas", type=int, nargs="*", default=[])
    parser.add_argument("--parent", type=pathlib.Path,
                        help="the root of another checkout to race")
    parser.add_argument("--child", action="store_true",
                        help=argparse.SUPPRESS)
    parser.add_argument("--child-ctas", type=int, default=0,
                        help=argparse.SUPPRESS)
    args = parser.parse_args()
    if args.child:
        print(measure(args.child_ctas), flush=True)
        return
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    print("each case: whole call ms under phase 7's window / the window "
          "before it, (host) where it timed the host", flush=True)
    workdir = ROOT / "_build" / "ring_lab"
    trees = [("parent", args.parent.resolve(), 0)] if args.parent else []
    trees += [("change", ROOT, 0)]
    trees += [(name, make_copy(name, workdir), 0) for name in args.names]
    trees += [(f"change, ctas {c}", ROOT, c) for c in args.ctas]
    order = []
    for _ in range(args.turns):
        order += trees + trees[::-1]
    failed = False
    for label, tree, ctas in order:
        run = subprocess.run(
            [sys.executable, str(pathlib.Path(__file__).resolve()), "--child",
             "--child-ctas", str(ctas)], cwd=tree, capture_output=True,
            text=True)
        failed |= run.returncode != 0
        line = (run.stdout.strip().splitlines() or [run.stderr[-400:]])[-1]
        print(f"{label}: {line}", flush=True)
    sys.exit(1 if failed else 0)


if __name__ == "__main__":
    main()
