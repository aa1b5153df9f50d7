"""Smoke run of heat_tpu_torch on one NVIDIA card: ``python3 chip_smoke.py``.

Phases, each of which fails the run by raising:

1. the card: torch version, name and power limit (``nvidia-smi``), the TF32
   switches; float32 products must run in full FP32, so matmul TF32 on is
   a failure;
2. the build of every CUDA kernel from ``heat_tpu_torch/csrc`` (one
   ``nvcc`` per source, all started together), with its time;
3. each kernel against its plain PyTorch version on the card, at the main
   path's shapes and at a ragged one, and against itself on a rerun
   (its cross-block sums run in a fixed order);
4. the main path at full size: ``ht.random.randn(65536, 8192, split=0)``
   (the 2.1 GB float32 per-chip shard of the north-star operation), then
   ``ht.linalg.hsvd_rank(A, 10, compute_sv=True)`` in the 2-pass form and
   with ``single_pass=True``; every kernel count is set to 0 just before
   each call and read just after. The factors must be orthonormal, and an
   exactly rank-8 operand of the same size, and a small one held against
   numpy's SVD, must give their singular values back;
5. times as medians of CUDA-event readings, each beside its bound: the
   larger of the bytes that must move over 3.35 TB/s and the operations
   over 67 TFLOP/s (FP32 outside the tensor cores), the H100 SXM data-sheet
   peaks.

The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``. Without CUDA the script
exits with an error and prints no result.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12

M, N = 65536, 8192  # the north-star per-chip shard, float32
MAXRANK = 10
RAGGED = (1000, 777)
RANK8_SIGMA = [8.0, 7.0, 6.0, 5.0, 4.0, 3.0, 2.0, 1.0]

# kernel against plain version, both float32 with other summation orders
# over up to 65536 terms: relative Frobenius error of w and y, relative
# error of the norm
TOL_W = 1e-5
TOL_NORM = 1e-6


def _require(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: {what}")


def _median_ms(fn, reps: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


def _bound(nbytes: float, flops: float):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / FP32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _rel(x, ref) -> float:
    return float((x.double() - ref.double()).norm() / ref.double().norm().clamp_min(1e-300))


def card_report() -> str:
    import torch

    print(f"torch {torch.__version__} (CUDA {torch.version.cuda})", flush=True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    tf32_mm = torch.backends.cuda.matmul.allow_tf32
    tf32_cudnn = torch.backends.cudnn.allow_tf32
    print(f"allow_tf32: matmul={tf32_mm} cudnn={tf32_cudnn}", flush=True)
    _require(not tf32_mm, "matmul TF32 is on; float32 products must run in full FP32")
    return card


def build_kernels() -> None:
    from heat_tpu_torch.kernels import _build

    t0 = time.perf_counter()
    _build.build_all()
    print(f"kernel build: {time.perf_counter() - t0:.1f} s for {_build.sources()}", flush=True)
    for name in _build.sources():
        log = _build._library_path(name).with_suffix(".log")
        lines = log.read_text().splitlines() if log.exists() else []
        # register use of the main path's instantiations (K1 l=25, K2 ℓ=59)
        for i, line in enumerate(lines):
            if "Compiling entry function" in line and ("ILi25ELb0E" in line or "ILi59ELb1E" in line):
                detail = " | ".join(s.split(":", 1)[-1].strip() for s in lines[i + 1 : i + 4])
                print(f"ptxas {line.split(chr(39))[1][:48]}: {detail}", flush=True)


def check_kernels(dev) -> dict:
    """Each kernel against its plain version; returns the main-shape errors."""
    import torch

    from heat_tpu_torch.core.linalg import _cuda_sketch as cs

    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    errs = {}
    for m, n in (RAGGED, (M, N)):
        a = torch.randn(m, n, device=dev, generator=gen)
        for l in (7, 25):
            g = torch.randn(l, m, device=dev, generator=gen)
            w, norm = cs.sketch_with_norm(g, a)
            pw, pnorm = cs.sketch_with_norm_plain(g, a)
            torch.cuda.synchronize()
            ew, en = _rel(w, pw), abs(float(norm) - float(pnorm)) / float(pnorm)
            print(f"K1 ({m}x{n}, l={l}): w rel {ew:.3e} (tol {TOL_W}), norm rel {en:.3e} (tol {TOL_NORM})", flush=True)
            _require(ew <= TOL_W and en <= TOL_NORM, f"K1 disagrees with its plain version at {m}x{n}, l={l}")
            if (m, n, l) == (M, N, 25):
                errs["sketch_with_norm"] = float((w - pw).abs().max())
                # partials are summed in a fixed order: a rerun gives the same bits
                _require(all(map(torch.equal, (w, norm), cs.sketch_with_norm(g, a))), "K1 is not repeatable")
        g = torch.randn(59, m, device=dev, generator=gen)
        omega = torch.randn(n, 24, device=dev, generator=gen)
        w, y, norm = cs.dual_sketch_with_norm(g, omega, a)
        pw, py, pnorm = cs.dual_sketch_with_norm_plain(g, omega, a)
        torch.cuda.synchronize()
        ew, ey, en = _rel(w, pw), _rel(y, py), abs(float(norm) - float(pnorm)) / float(pnorm)
        print(
            f"K2 ({m}x{n}, l=59, k=24): w rel {ew:.3e}, y rel {ey:.3e} (tol {TOL_W}), "
            f"norm rel {en:.3e} (tol {TOL_NORM})", flush=True,
        )
        _require(ew <= TOL_W and ey <= TOL_W and en <= TOL_NORM, f"K2 disagrees with its plain version at {m}x{n}")
        if (m, n) == (M, N):
            errs["dual_sketch_with_norm"] = max(float((w - pw).abs().max()), float((y - py).abs().max()))
            _require(all(map(torch.equal, (w, y, norm), cs.dual_sketch_with_norm(g, omega, a))), "K2 is not repeatable")
        del a
    return errs


def _orthonormal_err(x) -> float:
    import torch

    x = x.double()
    return float((x.T @ x - torch.eye(x.shape[1], dtype=x.dtype, device=x.device)).abs().max())


# (σ relative error, error estimate) bounds for an exactly rank-8 operand.
# The 2-pass form is exact up to float32 rounding. The one-view form is
# exact only in exact arithmetic: in float32 its Gram orthonormalization
# turns the null directions of Y = AΩ into near-zero columns of Q, the
# solve (ΨQ)⁺W amplifies rounding there, and the loss grows with the size
# of A. heat_tpu's one-view does the same; its small-size tolerance holds
# at 1000 x 777 only.
RANK8_TOL = {False: (1e-4, 1e-3), True: (2e-2, 0.25)}


def _check_rank8(ht, A, sigma_ref, what: str, tol=None) -> None:
    import torch

    ref = torch.tensor(sigma_ref, dtype=torch.float64)
    for single_pass in (False, True):
        s_tol, e_tol = (tol or RANK8_TOL)[single_pass]
        U, sigma, V, err = ht.linalg.hsvd_rank(A, MAXRANK, compute_sv=True, single_pass=single_pass)
        s = sigma.larray.double().cpu()
        rel = float(((s[: len(ref)] - ref).abs() / ref).max())
        print(
            f"{what} single_pass={single_pass}: sigma rel err {rel:.3e} (tol {s_tol}), "
            f"err {float(err):.3e} (tol {e_tol})", flush=True,
        )
        _require(rel <= s_tol, f"{what}: singular values off (single_pass={single_pass})")
        _require(0.0 <= float(err) <= e_tol, f"{what}: error estimate {float(err)} (single_pass={single_pass})")
        # columns past the rank carry σ ≈ 0 and may be zero: check the first 8
        _require(
            max(_orthonormal_err(U.larray[:, :8]), _orthonormal_err(V.larray[:, :8])) <= 1e-4,
            f"{what}: factors not orthonormal",
        )


def main_path(dev) -> dict:
    """The port's main path through its public entry points; returns the
    kernel launch counts of the full-size calls."""
    import numpy as np
    import torch

    import heat_tpu_torch as ht
    from heat_tpu_torch.core.linalg import _cuda_sketch as cs

    ht.random.seed(0)
    A = ht.random.randn(M, N, split=0)
    _require(A.larray.device == dev and A.dtype is ht.float32 and A.split == 0, "A is not a float32 split-0 array on the card")
    launches = {}
    for single_pass, kernel in ((False, "sketch_with_norm"), (True, "dual_sketch_with_norm")):
        cs.SKETCH_LAUNCHES = cs.DUAL_LAUNCHES = 0
        U, sigma, V, err = ht.linalg.hsvd_rank(A, MAXRANK, compute_sv=True, single_pass=single_pass)
        torch.cuda.synchronize()
        counts = {"sketch_with_norm": cs.SKETCH_LAUNCHES, "dual_sketch_with_norm": cs.DUAL_LAUNCHES}
        launches[kernel] = counts[kernel]
        s = sigma.larray
        ou, ov = _orthonormal_err(U.larray), _orthonormal_err(V.larray)
        print(
            f"hsvd_rank({M}x{N}, {MAXRANK}, single_pass={single_pass}): launches {counts}, "
            f"U {tuple(U.shape)} V {tuple(V.shape)}, orthonormality {ou:.2e}/{ov:.2e} (tol 1e-4), "
            f"sigma[0]={float(s[0]):.4f} sigma[-1]={float(s[-1]):.4f}, err={float(err):.6f}", flush=True,
        )
        _require(counts[kernel] > 0, f"the main path ran without kernel {kernel}")
        _require(U.shape == (M, MAXRANK) and V.shape == (N, MAXRANK) and sigma.shape == (MAXRANK,), "factor shapes")
        _require(bool(torch.isfinite(U.larray).all() and torch.isfinite(V.larray).all() and torch.isfinite(s).all()), "non-finite factors")
        # the 2-pass estimate is exact, so at most 1; the one-view one is a
        # sampled estimate and can exceed 1 on flat spectra such as this
        _require(bool((s[:-1] >= s[1:]).all() and s[-1] > 0), "spectrum not positive and descending")
        _require(0.0 < float(err) <= (float("inf") if single_pass else 1.0), f"error estimate {float(err)} out of range")
        _require(max(ou, ov) <= 1e-4, "factors not orthonormal")
    del A, U, V

    # an exactly rank-8 operand of the same size, L @ R built on the card
    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    left, _ = torch.linalg.qr(torch.randn(M, 8, device=dev, generator=gen))
    right, _ = torch.linalg.qr(torch.randn(N, 8, device=dev, generator=gen))
    sig = torch.tensor(RANK8_SIGMA, device=dev)
    _check_rank8(ht, ht.array((left * sig) @ right.T, split=0), RANK8_SIGMA, f"rank-8 {M}x{N}")

    # a small input against numpy's SVD
    rng = np.random.default_rng(3)
    small = (rng.standard_normal((RAGGED[0], 8)) * RANK8_SIGMA) @ rng.standard_normal((8, RAGGED[1]))
    sigma_np = np.linalg.svd(small, compute_uv=False)[:8]
    small_tol = {sp: RANK8_TOL[False] for sp in (False, True)}
    _check_rank8(ht, ht.array(small.astype(np.float32), split=0), list(sigma_np), f"rank-8 {RAGGED[0]}x{RAGGED[1]} vs numpy", small_tol)
    return launches


def timings(dev, launches: dict, errs: dict) -> list:
    import torch

    import heat_tpu_torch as ht
    from heat_tpu_torch.core.linalg import _cuda_sketch as cs

    gen = torch.Generator(device=dev)
    gen.manual_seed(4)
    a = torch.randn(M, N, device=dev, generator=gen)
    g1 = torch.randn(25, M, device=dev, generator=gen)
    g2 = torch.randn(59, M, device=dev, generator=gen)
    omega = torch.randn(N, 24, device=dev, generator=gen)
    mn = float(M) * N
    rows = []
    specs = (
        ("sketch_with_norm", "heat_tpu/core/linalg/_pallas_sketch.py:56",
         lambda: cs.sketch_with_norm(g1, a), lambda: cs.sketch_with_norm_plain(g1, a),
         lambda: torch.matmul(g1, a),
         4 * (mn + 25 * M + 25 * N + 1), 2 * 25 * mn + 2 * mn),
        ("dual_sketch_with_norm", "heat_tpu/core/linalg/_pallas_sketch.py:105",
         lambda: cs.dual_sketch_with_norm(g2, omega, a), lambda: cs.dual_sketch_with_norm_plain(g2, omega, a),
         None,
         4 * (mn + 59 * M + 24 * N + 59 * N + 24 * M + 1), 2 * (59 + 24) * mn + 2 * mn),
    )
    for name, replaces, kernel, plain, library, nbytes, flops in specs:
        ms = _median_ms(kernel, 10)
        plain_ms = _median_ms(plain, 5)
        library_ms = _median_ms(library, 10) if library is not None else None
        bound_ms, bound_by = _bound(nbytes, flops)
        print(
            f"{name}: {ms:.4f} ms, plain {plain_ms:.4f} ms, library "
            f"{'n/a' if library_ms is None else f'{library_ms:.4f} ms'}, bound {bound_ms:.4f} ms ({bound_by})",
            flush=True,
        )
        rows.append({
            "name": name, "route": "cuda", "source": "heat_tpu_torch/csrc/sketch.cu",
            "replaces": replaces, "launches": launches[name], "max_abs_err": errs[name],
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms,
        })
    A = ht.array(a, split=0)
    for single_pass, passes in ((False, 2), (True, 1)):
        t0 = time.perf_counter()
        ms = _median_ms(lambda: ht.linalg.hsvd_rank(A, MAXRANK, compute_sv=True, single_pass=single_pass), 5)
        print(
            f"hsvd_rank(single_pass={single_pass}): {ms:.4f} ms (median of 5, CUDA events), "
            f"bound {passes * 4 * mn / HBM_BYTES_PER_S * 1e3:.4f} ms ({passes} read(s) of A); "
            f"{(time.perf_counter() - t0) / 6 * 1e3:.1f} ms host time per call with its sync", flush=True,
        )
    profile_breakdown(ht, A)
    return rows


def profile_breakdown(ht, A) -> None:
    """Device time by kernel for one call of each form, from torch.profiler
    (device-side events only; the wall time includes the profiler's own
    cost)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for single_pass in (False, True):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            ht.linalg.hsvd_rank(A, MAXRANK, compute_sv=True, single_pass=single_pass)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        rows = sorted(
            (e.self_device_time_total / 1e3, e.count, e.key)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
        )[::-1]
        busy_ms = sum(r[0] for r in rows)
        top = "; ".join(f"{key[:100]} x{count} {t:.3f} ms" for t, count, key in rows[:8] if t > 0)
        print(
            f"profile hsvd_rank(single_pass={single_pass}): wall {wall_ms:.3f} ms, device busy "
            f"{busy_ms:.3f} ms ({busy_ms / wall_ms:.1%}); by kernel: {top}", flush=True,
        )


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this run needs an NVIDIA card", file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    dev = torch.device("cuda", 0)
    card = card_report()
    build_kernels()
    errs = check_kernels(dev)
    launches = main_path(dev)
    rows = timings(dev, launches, errs)
    print(f"total {time.perf_counter() - t0:.1f} s", flush=True)
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
