#!/usr/bin/env python3
"""Kernel R1 (the Threefry draw, ``csrc/threefry.cu``) of heat_tpu_torch
checkouts side by side on one NVIDIA card::

    python3 scripts/torch_r1_ab.py OLD NEW NEW OLD

Each argument is the root of a checkout (the directory that holds its
``heat_tpu_torch/``). Each runs in a process of its own, in the order
given, so that two trees are compared in turns on the same card. A process
builds the tree's ``threefry.cu`` into that tree's ``build/`` and, for every
draw of ``_r1_draws()`` in this checkout's ``chip_smoke.py`` (the main
paths' draws at full size), calls the tree's ``kernels.threefry.draw`` and
prints one JSON line with, for each draw:

- ``ms``: the median CUDA-event time of a lone call (``_median_ms``, 10
  calls: the wrapper's host work and the launch included);
- ``device_ms``: the device time of a call among 10 queued behind a spin
  kernel (``_device_ms``: the host's submission left out);
- ``digest``: the sum of the output's 32-bit words (64-bit words for
  8-byte types), so that two trees are seen to draw the same bits.

Then a table of each draw's medians over the processes of each tree beside
the draw's bound (``r1_bound`` of this checkout's ``chip_smoke.py``: the
function's operations, the same for every tree, at the card's maximum SM
clock) and each median's share of it, the card's name and power limit
(``nvidia-smi``) and the JSON list of the per-process lines. Without CUDA it
exits with 2.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

REPS = 10
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _chip_smoke():
    """This checkout's chip_smoke.py as a module (its draws, timers and
    bound)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def one(tree: str) -> dict:
    """Time R1 of the checkout at ``tree`` on every draw (this process
    imports its heat_tpu_torch, and this checkout's chip_smoke.py)."""
    sys.path.insert(0, os.path.abspath(tree))
    import torch

    cs = _chip_smoke()
    import heat_tpu_torch
    from heat_tpu_torch.kernels import _build
    from heat_tpu_torch.kernels import threefry as kt

    where = os.path.dirname(os.path.abspath(heat_tpu_torch.__file__))
    if os.path.dirname(where) != os.path.abspath(tree):
        raise RuntimeError(f"imported heat_tpu_torch from {where}, not from {tree}")
    dev = torch.device("cuda", 0)
    _build.build_all(["threefry"])
    rows = {}
    for label, mode, key, chunk, dtype, args in cs._r1_draws():
        call = lambda: kt.draw(mode, key, chunk, dtype, dev, args)  # noqa: E731
        out = call()
        word = torch.int64 if out.element_size() == 8 else torch.int32
        flat = out.reshape(-1)
        digest = int(flat.view(word).sum(dtype=torch.int64)) if out.element_size() in (4, 8) else \
            int(flat.view(torch.uint8).sum(dtype=torch.int64))
        del out, flat
        ms = cs._median_ms(call, REPS)
        device_ms = cs._device_ms(call, REPS)
        rows[label] = {"ms": ms, "device_ms": device_ms, "digest": digest}
        torch.cuda.empty_cache()
    return {"tree": tree, "reps": REPS, "rows": rows}


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("trees", nargs="+", help="checkout roots, run in this order (OLD NEW NEW OLD)")
    p.add_argument("--one", action="store_true", help=argparse.SUPPRESS)
    args = p.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_r1_ab: CUDA is not available; this run needs an NVIDIA card", file=sys.stderr)
        return 2
    if args.one:
        print(json.dumps(one(args.trees[0])), flush=True)
        return 0
    results = []
    for tree in args.trees:
        out = subprocess.run([sys.executable, os.path.abspath(__file__), "--one", tree], capture_output=True, text=True)
        sys.stderr.write(out.stderr[-4000:])
        if out.returncode != 0:
            print(f"torch_r1_ab: {tree} failed with code {out.returncode}", file=sys.stderr)
            return 1
        line = json.loads(out.stdout.strip().splitlines()[-1])
        print(json.dumps(line), flush=True)
        results.append(line)
    trees = list(dict.fromkeys(args.trees))
    sys.path.insert(0, ROOT)
    cs = _chip_smoke()
    clock = cs._sm_clock_hz()
    for label, mode, _, chunk, dtype, _ in cs._r1_draws():
        bound_ms, _, pipe, _, _, count = cs.r1_bound(mode, chunk, dtype, clock)
        cells = []
        for tree in trees:
            mine = [r["rows"][label] for r in results if r["tree"] == tree]
            device_ms = statistics.median(m["device_ms"] for m in mine)
            cells.append(
                f"{tree}: {statistics.median(m['ms'] for m in mine):.4f} ms, device {device_ms:.4f} ms "
                f"({bound_ms / device_ms:.1%} of the bound), digest {mine[0]['digest']}")
        same = len({r["rows"][label]["digest"] for r in results}) == 1
        print(f"{label}: bound {bound_ms:.4f} ms ({pipe}, {count['operations']:g} operations an element at "
              f"{clock / 1e6:.0f} MHz) | " + " | ".join(cells) + f" | digests {'equal' if same else 'DIFFER'}",
              flush=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(card)
    print(json.dumps(results))
    return 0


if __name__ == "__main__":
    sys.exit(main())
