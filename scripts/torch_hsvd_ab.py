#!/usr/bin/env python3
"""The 2-pass ``hsvd_rank`` of heat_tpu_torch checkouts side by side on one
NVIDIA card, with its host and device time apart::

    python3 scripts/torch_hsvd_ab.py OLD NEW NEW OLD

Each argument is the root of a checkout (the directory that holds its
``heat_tpu_torch/``). Each runs in a process of its own, in the order
given, so that two trees are compared in turns on the same card. A
process builds the tree's kernels into that tree's ``build/``, makes the
north-star operand (``ht.random.randn(65536, 8192, split=0)`` after
``ht.random.seed(0)``), calls ``ht.linalg.hsvd_rank(A, 10,
compute_sv=True)`` three times to warm up and then ``--reps`` times, and
prints one JSON line:

- ``call_ms``: the median CUDA-event time of a call;
- ``host_ms``: the median host time from the call to its return, without a
  sync (the time the host takes to submit the call's work);
- ``wall_ms``: the median host time of a call with its sync;
- ``busy_ms``: device time a call (torch.profiler, every kernel and copy),
  and ``k1_ms`` the part of it in the row sketch's launches (K1: the
  kernel, g's split where it has one, and the sums of its partials);
- ``k1_launches``: K1 launches a call; ``top``: the device time of the
  largest kernels.

The last two lines are the card's name and power limit (``nvidia-smi``)
and a JSON list of the per-process lines. Without CUDA it exits with 2.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

M, N, MAXRANK = 65536, 8192, 10
K1_KERNELS = ("sketch", "split_kernel", "sum_parts_kernel", "sum_norm_kernel")


def one(tree: str, reps: int) -> dict:
    """Time the 2-pass hsvd_rank of the checkout at ``tree`` (this process
    imports its heat_tpu_torch)."""
    sys.path.insert(0, os.path.abspath(tree))
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import heat_tpu_torch as ht
    from heat_tpu_torch.core.linalg import _cuda_sketch as cs

    where = os.path.dirname(os.path.abspath(ht.__file__))
    if os.path.dirname(where) != os.path.abspath(tree):
        raise RuntimeError(f"imported heat_tpu_torch from {where}, not from {tree}")
    ht.random.seed(0)
    A = ht.random.randn(M, N, split=0)
    call = lambda: ht.linalg.hsvd_rank(A, MAXRANK, compute_sv=True)
    for _ in range(3):
        call()
    torch.cuda.synchronize()
    before = cs.SKETCH_LAUNCHES
    ms, host, wall = [], [], []
    for _ in range(reps):
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        t0 = time.perf_counter()
        call()
        host.append((time.perf_counter() - t0) * 1e3)
        stop.record()
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - t0) * 1e3)
        ms.append(start.elapsed_time(stop))
    launches = (cs.SKETCH_LAUNCHES - before) / reps
    prof_reps = 5
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(prof_reps):
            call()
        torch.cuda.synchronize()
    rows = sorted(
        ((e.self_device_time_total / 1e3 / prof_reps, e.key) for e in prof.key_averages()
         if e.device_type == DeviceType.CUDA),
        reverse=True,
    )
    return {
        "tree": tree,
        "call_ms": statistics.median(ms),
        "host_ms": statistics.median(host),
        "wall_ms": statistics.median(wall),
        "busy_ms": sum(t for t, _ in rows),
        "k1_ms": sum(t for t, key in rows if any(s in key for s in K1_KERNELS)),
        "k1_launches": launches,
        "reps": reps,
        "top": [[key[:80], round(t, 4)] for t, key in rows[:6]],
    }


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("trees", nargs="+", help="checkout roots, run in this order (OLD NEW NEW OLD)")
    p.add_argument("--reps", type=int, default=10, help="timed calls a process")
    p.add_argument("--one", action="store_true", help=argparse.SUPPRESS)
    args = p.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_hsvd_ab: CUDA is not available; this run needs an NVIDIA card", file=sys.stderr)
        return 2
    if args.one:
        print(json.dumps(one(args.trees[0], args.reps)), flush=True)
        return 0
    results = []
    for tree in args.trees:
        out = subprocess.run([sys.executable, os.path.abspath(__file__), "--one", "--reps", str(args.reps), tree],
                             capture_output=True, text=True)
        sys.stderr.write(out.stderr[-4000:])
        if out.returncode != 0:
            print(f"torch_hsvd_ab: {tree} failed with code {out.returncode}", file=sys.stderr)
            return 1
        line = json.loads(out.stdout.strip().splitlines()[-1])
        print(json.dumps(line), flush=True)
        results.append(line)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(card)
    print(json.dumps(results))
    return 0


if __name__ == "__main__":
    sys.exit(main())
