"""Smoke run of heat_tpu_torch on one NVIDIA card: ``python3 chip_smoke.py``.

Phases, each of which fails the run by raising:

1. the card: torch version, name and power limit (``nvidia-smi``), the TF32
   switches; float32 products must run in full FP32, so matmul TF32 on is
   a failure;
2. the build of every CUDA kernel from ``heat_tpu_torch/csrc`` (one
   ``nvcc`` per source, all started together), with its time and the
   register line of each main-path instantiation;
3. each kernel against its plain PyTorch version on the card, at the main
   path's shapes and at ragged ones, and against itself on a rerun
   (its cross-block sums run in a fixed order);
4. the main paths at full size, each kernel count set to 0 just before
   each call and read just after:
   - hSVD: ``ht.random.randn(65536, 8192, split=0)`` (the 2.1 GB float32
     per-chip shard of the north-star operation), then
     ``ht.linalg.hsvd_rank(A, 10, compute_sv=True)`` in the 2-pass form
     and with ``single_pass=True``. The factors must be orthonormal, and
     an exactly rank-8 operand of the same size, and a small one held
     against numpy's SVD, must give their singular values back;
   - KMeans: ``ht.random.randn(15_625_000, 64, split=0)`` (the 4.0 GB
     per-chip shard of BASELINE's 1B x 64 over 64 chips), then 20 Lloyd
     iterations of ``KMeans(8, init="kmeans++")`` and ``predict``. Eight
     well-separated blobs of the same size must be recovered, and a fit
     from one point per blob must equal a Lloyd loop on the plain
     assignment; the reference benchmark's configuration (four spherical
     clusters of 5000 3-D points, k = 4) must be recovered by KMeans,
     KMedians and KMedoids;
   - sort: ``ht.random.randn(134_217_728, split=0)`` (bench.py's
     ``sort_1gb`` size), ``ht.sort`` ascending and descending, whose
     indices must equal torch's stable argsort exactly; ``ht.sort`` of
     262,144 x 512 along axis 1 (the TPU kernel's own 512-element blocks);
     ``ht.unique`` of ``ht.random.randint(0, 1000, ...)`` of the same
     length, with its inverse, and of the float32 array; ``ht.topk(x,
     1000)`` both ways, which must equal the prefix of the sort. Each call
     must launch K4;
5. times as medians of CUDA-event readings, each beside its bound: the
   larger of the bytes that must move over 3.35 TB/s and the operations
   over 67 TFLOP/s (FP32 outside the tensor cores), the H100 SXM data-sheet
   peaks; and a profile of one call or fit of each main path. K4 is
   checked for exact equality with its plain version (it moves integers)
   at both regimes' main shapes, ragged and boundary segment lengths,
   adversarial float32 keys and n = 1, and on a rerun.

The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``. Without CUDA the script
exits with an error and prints no result.
"""

from __future__ import annotations

import json
import math
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

KM_N, KM_D, KM_K = 15_625_000, 64, 8  # the KMeans per-chip shard (bench.py:114)
KM_ITERS = 20
# K3 against its plain version: cluster sums within relative Frobenius
# error 1e-5 and inertia within relative error 1e-5 (float32 sums in two
# orders); counts exactly equal on well-separated blobs; on Gaussian data
# near-ties may flip labels between the two orders, so Σ|Δcount| ≤ 1e-5·n
TOL_SUMS = 1e-5
TOL_INERTIA = 1e-5
TOL_FLIPS = 1e-5
# (n, d, k) of phase 3: main, the reference benchmark, ragged, and the
# largest k and d the kernel's predicate admits
K3_SHAPES = ((KM_N, KM_D, KM_K), (20000, 3, 4), (1003, 16, 4), (100_003, 124, 64))

SORT_N = 134_217_728  # float32 elements of the sort_1gb row (bench.py:111)
SORT_ROWS, SORT_SEG = 262_144, 512  # 512-element rows: the TPU kernel's own blocks
TOPK_K = 1000
ADV_N = 1 << 22  # adversarial keys, as one segment and as rows of 512


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
    ready = _build.build_all()
    each = ", ".join(f"{name} ready after {sec:.1f} s" for name, sec in ready.items())
    print(f"kernel build: {time.perf_counter() - t0:.1f} s for {_build.sources()} ({each})", flush=True)
    for name in _build.sources():
        log = _build._library_path(name).with_suffix(".log")
        lines = log.read_text().splitlines() if log.exists() else []
        # register use of the main paths' instantiations (K1 l=25, K2 ℓ=59,
        # K3 k ≤ 8, and K4's kernels of both regimes)
        for i, line in enumerate(lines):
            main = ("ILi25ELb0E", "ILi59ELb1E", "assign_kernelILi8E", "segment_sort_kernel",
                    "tile_hist_kernel", "scan_rows_kernel", "tile_scatter_kernel")
            tags = [tag for tag in main if tag in line]
            if "Compiling entry function" in line and tags:
                detail = " | ".join(s.split(":", 1)[-1].strip() for s in lines[i + 1 : i + 4])
                print(f"ptxas {line.split(chr(39))[1][:48]} ({tags[0]}): {detail}", flush=True)


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


def _blobs(gen, n: int, means):
    """Blobs of n // k rows each around the k ``means`` (n divisible by k),
    with unit-variance Gaussian noise, built on the card."""
    import torch

    x = torch.randn(n, means.shape[1], device=means.device, generator=gen)
    x += means.repeat_interleave(n // means.shape[0], dim=0)
    return x


def _axis_means(dev, d: int, k: int, scale: float = 8.0):
    """k ≤ 2d means ±scale·e_j: every pair at least scale·√2 apart, 5.7
    noise deviations from their bisector, at a magnitude that keeps the
    float32 quadratic expansion from cancelling."""
    import torch

    idx = torch.arange(k, device=dev)
    means = torch.zeros(k, d, device=dev)
    means[idx, idx % d] = scale * (1.0 - 2.0 * (idx >= d).float())
    return means


def check_assign(dev) -> float:
    """K3 against its plain version on Gaussian data (centers drawn from
    X) and on well-separated blobs; returns the largest absolute error of
    the sums at the main shape."""
    import torch

    from heat_tpu_torch.cluster import _cuda_assign as ca

    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    main_err = None
    for n, d, k in K3_SHAPES:
        n_blob = n - n % k
        for data in ("gaussian", "blobs"):
            if data == "gaussian":
                x = torch.randn(n, d, device=dev, generator=gen)
                c = x[torch.randperm(n, device=dev, generator=gen)[:k]].contiguous()
            else:
                c = _axis_means(dev, d, k)
                x = _blobs(gen, n_blob, c)
            sums, counts, inertia = ca.fused_assign(x, c)
            psums, pcounts, pinertia = ca.fused_assign_plain(x, c)
            torch.cuda.synchronize()
            es = _rel(sums, psums)
            ei = abs(float(inertia) - float(pinertia)) / float(pinertia)
            flips = float((counts - pcounts).abs().sum())
            limit = TOL_FLIPS * x.shape[0] if data == "gaussian" else 0.0
            print(
                f"K3 ({x.shape[0]}x{d}, k={k}, {data}): sums rel {es:.3e} (tol {TOL_SUMS}), inertia rel "
                f"{ei:.3e} (tol {TOL_INERTIA}), sum |count diff| {flips:.0f} (limit {limit:.0f})", flush=True,
            )
            _require(es <= TOL_SUMS and ei <= TOL_INERTIA and flips <= limit,
                     f"K3 disagrees with its plain version at {x.shape[0]}x{d}, k={k} ({data})")
            _require(all(map(torch.equal, (sums, counts, inertia), ca.fused_assign(x, c))), "K3 is not repeatable")
            if (n, d, k, data) == (KM_N, KM_D, KM_K, "gaussian"):
                main_err = float((sums - psums).abs().max())
            del x
    return main_err


def _random_words(gen, n: int, dev, high: int = None):
    """n random u32 words (int32 bit patterns), or values in [0, high)."""
    import torch

    if high is None:
        return torch.randint(-(2**31), 2**31, (n,), device=dev, generator=gen, dtype=torch.int32)
    return torch.randint(0, high, (n,), device=dev, generator=gen, dtype=torch.int32)


def _unsigned(words):
    return words.long() & 0xFFFFFFFF


def _adversarial_f32(kind: str, gen, dev):
    """float32 keys of the kinds of tests/test_kernels_sort.py, and one of
    special values: ±0, ±inf, ±max, NaNs of both signs, subnormals."""
    import torch

    x = torch.randn(ADV_N, device=dev, generator=gen)
    if kind == "sorted":
        x = torch.sort(x).values
    elif kind == "reverse":
        x = torch.sort(x, descending=True).values
    elif kind == "const":
        x = torch.full_like(x, float(x[0]))
    elif kind == "fewuniq":
        x = x[torch.randint(0, 7, (ADV_N,), device=dev, generator=gen)]
    elif kind == "nan":
        x[torch.rand(ADV_N, device=dev, generator=gen) < 0.15] = float("nan")
    elif kind == "specials":
        bits = torch.tensor(
            [0x00000000, 0x80000000, 0x7F800000, 0xFF800000, 0x7F7FFFFF, 0xFF7FFFFF, 0x7FC00000,
             0xFFC00000, 0x7FFFFFFF, 0xFFFFFFFF, 0x00000001, 0x807FFFFF, 0x3F800000],
            device=dev, dtype=torch.int64,
        )
        pick = bits[torch.randint(0, len(bits), (ADV_N,), device=dev, generator=gen)]
        x = torch.where(pick >= 2**31, pick - 2**32, pick).to(torch.int32).view(torch.float32)
    return x


def _k4_case(ks, label: str, keys, pays=None, seg_len=None, pay_bytes=0) -> int:
    """K4 against its plain version and against itself on a rerun, exactly;
    where the payload is the position, the payloads must also be torch's
    stable argsort of the keys. Returns the largest absolute difference."""
    import torch

    got = ks.pair_sort(keys, pays, seg_len, pay_bytes)
    ref = ks.pair_sort_plain(keys, pays, seg_len, pay_bytes)
    again = ks.pair_sort(keys, pays, seg_len, pay_bytes)
    torch.cuda.synchronize()
    err = max(int((g.long() - r.long()).abs().max()) for g, r in zip(got, ref))
    rerun = all(map(torch.equal, got, again))
    argsort = "n/a"
    if pays is None:
        rows = keys.numel() // (seg_len or keys.numel())
        expect = torch.sort(_unsigned(keys).reshape(rows, -1), dim=1, stable=True).indices
        argsort = torch.equal(got[1].long().reshape(rows, -1), expect)
        _require(argsort, f"K4 ({label}) is not torch's stable argsort")
    print(
        f"K4 ({label}): max |difference| from the plain version {err} (tol 0), rerun identical {rerun}, "
        f"payload equals torch's stable argsort {argsort}", flush=True,
    )
    _require(err == 0 and rerun, f"K4 disagrees with its plain version or itself ({label})")
    return err


def check_sort(dev) -> dict:
    """K4 against its plain version at the listed shapes; returns the
    largest error of each regime's main shape."""
    import torch

    from heat_tpu_torch.kernels import sort as ks

    gen = torch.Generator(device=dev)
    gen.manual_seed(8)
    errs = {}
    keys = _random_words(gen, SORT_N, dev)
    errs["pair_sort_one_segment"] = _k4_case(ks, f"n={SORT_N}, one segment", keys)
    del keys
    keys, pays = _random_words(gen, SORT_N, dev, 1000), _random_words(gen, SORT_N, dev)
    _k4_case(ks, f"n={SORT_N}, 1000 key values, pay_bytes=4", keys, pays, pay_bytes=4)
    del keys, pays
    keys = _random_words(gen, SORT_ROWS * SORT_SEG, dev)
    errs["pair_sort_segments"] = _k4_case(ks, f"{SORT_ROWS} segments of {SORT_SEG}", keys, seg_len=SORT_SEG)
    del keys
    for rows, seg in ((10_007, 777), (2048, ks.SEG_MAX), (1, ks.SEG_MAX + 1), (1, 1)):
        _k4_case(ks, f"{rows} segment(s) of {seg}", _random_words(gen, rows * seg, dev, 3000), seg_len=seg)
    for kind in ("sorted", "reverse", "const", "fewuniq", "nan", "specials"):
        u = ks.to_sortable(_adversarial_f32(kind, gen, dev))
        _k4_case(ks, f"{kind} float32 keys, one segment of {ADV_N}", u)
        _k4_case(ks, f"{kind} float32 keys, segments of {SORT_SEG}", u, seg_len=SORT_SEG)
    return errs


def sort_path(dev) -> dict:
    """The sort family's main path through the public entry points; returns
    K4's launches in the one-segment calls and in the row sort."""
    import torch

    import heat_tpu_torch as ht
    from heat_tpu_torch.kernels import sort as ks

    def run(label: str, call):
        ks.SORT_LAUNCHES = 0
        out = call()
        torch.cuda.synchronize()
        launches = ks.SORT_LAUNCHES
        print(f"{label}: K4 launches {launches}", flush=True)
        _require(launches > 0, f"{label} ran without K4")
        return out, launches

    ht.random.seed(0)
    x = ht.random.randn(SORT_N, split=0)
    xt = x.larray
    _require(xt.device == dev and x.dtype is ht.float32 and x.split == 0, "x is not a float32 split-0 array on the card")
    one = 0
    (v, i), n = run(f"ht.sort(x), x = randn({SORT_N})", lambda: ht.sort(x))
    one += n
    _require(v.split == 0 and i.dtype is ht.int64 and v.shape == i.shape == (SORT_N,), "sort result types")
    _require(torch.equal(i.larray, torch.sort(xt, stable=True).indices), "ht.sort indices differ from the stable argsort")
    _require(torch.equal(v.larray, xt[i.larray]) and bool((v.larray[1:] >= v.larray[:-1]).all()), "ht.sort values not sorted")
    (vd, idd), n = run("ht.sort(x, descending=True)", lambda: ht.sort(x, descending=True))
    one += n
    flipped = torch.sort(~ks.to_sortable(xt).long() & 0xFFFFFFFF, stable=True).indices
    _require(torch.equal(idd.larray, flipped), "descending indices differ from the stable argsort of the complement")
    _require(bool((vd.larray[1:] <= vd.larray[:-1]).all()), "descending values not sorted")

    (tv, ti), n = run(f"ht.topk(x, {TOPK_K})", lambda: ht.topk(x, TOPK_K))
    one += n
    _require(torch.equal(ti.larray, idd.larray[:TOPK_K]) and torch.equal(tv.larray, vd.larray[:TOPK_K]),
             "topk differs from the prefix of the descending sort")
    (tv, ti), n = run(f"ht.topk(x, {TOPK_K}, largest=False)", lambda: ht.topk(x, TOPK_K, largest=False))
    one += n
    _require(torch.equal(ti.larray, i.larray[:TOPK_K]) and torch.equal(tv.larray, v.larray[:TOPK_K]),
             "topk(largest=False) differs from the prefix of the sort")
    del vd, idd, i

    uf, n = run("ht.unique(x)", lambda: ht.unique(x))
    one += n
    _require(torch.equal(uf.larray, torch.unique_consecutive(v.larray)), "ht.unique(x) is not x's sorted distinct values")
    del v, uf
    ints = ht.random.randint(0, 1000, (SORT_N,), split=0)
    _require(ints.dtype is ht.int32, "randint did not give int32")
    u, n = run("ht.unique(randint(0, 1000))", lambda: ht.unique(ints))
    one += n
    _require(torch.equal(u.larray, torch.arange(1000, device=dev, dtype=torch.int32)), "unique of randint(0, 1000) is not 0..999")
    (u, inv), n = run("ht.unique(randint(0, 1000), return_inverse=True)", lambda: ht.unique(ints, return_inverse=True))
    one += n
    _require(inv.shape == (SORT_N,) and torch.equal(u.larray[inv.larray], ints.larray), "values[inverse] does not rebuild the input")
    del ints, u, inv, x, xt

    X = ht.random.randn(SORT_ROWS, SORT_SEG, split=0)
    (V, I), rows = run(f"ht.sort(X, axis=1), X = randn({SORT_ROWS}, {SORT_SEG})", lambda: ht.sort(X, axis=1))
    _require(torch.equal(I.larray, torch.sort(X.larray, dim=1, stable=True).indices), "row sort indices differ from the stable argsort")
    _require(bool((V.larray[:, 1:] >= V.larray[:, :-1]).all()), "row sort values not sorted")
    return {"one_segment": one, "segments": rows}


def sort_timings(dev, launches: dict, errs: dict) -> list:
    """K4 in both regimes beside its plain version and torch.sort, then the
    public calls end to end and a profile of ht.sort; returns K4's rows."""
    import torch

    import heat_tpu_torch as ht
    from heat_tpu_torch.kernels import sort as ks

    gen = torch.Generator(device=dev)
    gen.manual_seed(9)
    x = torch.randn(SORT_N, device=dev, generator=gen)
    X = torch.randn(SORT_ROWS, SORT_SEG, device=dev, generator=gen)
    rows = []
    for name, key, seg, library in (
        ("pair_sort_one_segment", "one_segment", None, lambda: torch.sort(x, stable=True)),
        ("pair_sort_segments", "segments", SORT_SEG, lambda: torch.sort(X, dim=1, stable=True)),
    ):
        words = ks.to_sortable(x if seg is None else X.reshape(-1))
        plan = ks.sort_plan(SORT_N, seg_len=seg)
        ms = _median_ms(lambda: ks.pair_sort(words, seg_len=seg), 10)
        plain_ms = _median_ms(lambda: ks.pair_sort_plain(words, seg_len=seg), 2)
        library_ms = _median_ms(library, 10)
        # with a generated payload: read each key once, write each key and payload once
        bound_ms, bound_by = _bound(12.0 * SORT_N, 0.0)
        model_ms = plan["hbm_bytes"] / HBM_BYTES_PER_S * 1e3
        print(
            f"{name} (K4, {plan['path']}, n={SORT_N}{'' if seg is None else f' in segments of {seg}'}): {ms:.4f} ms, "
            f"plain {plain_ms:.4f} ms, torch.sort {library_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}, 12 B a pair); "
            f"pass model {plan['passes']} passes, {plan['hbm_bytes'] / 1e9:.4f} GB, {model_ms:.4f} ms at 3.35 TB/s "
            f"({plan['hbm_bytes'] / (ms * 1e-3) / 1e9:.1f} GB/s of model bytes achieved)", flush=True,
        )
        rows.append({
            "name": name, "route": "cuda", "source": "heat_tpu_torch/csrc/radix_sort.cu",
            "replaces": "heat_tpu/kernels/sort.py:253", "launches": launches[key], "max_abs_err": errs[name],
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms,
        })
        del words
    A = ht.array(x, split=0)
    floor_ms = ks.sort_plan(SORT_N)["floor_bytes"] / HBM_BYTES_PER_S * 1e3
    sort_ms = _median_ms(lambda: ht.sort(A), 5)
    unique_ms = _median_ms(lambda: ht.unique(A), 5)
    topk_ms = _median_ms(lambda: ht.topk(A, TOPK_K), 5)
    torch_topk_ms = _median_ms(lambda: torch.topk(x, TOPK_K), 5)
    rows_ms = _median_ms(lambda: ht.sort(ht.array(X, split=0), axis=1), 5)
    print(
        f"ht.sort(randn({SORT_N})): {sort_ms:.4f} ms (median of 5, CUDA events), floor {floor_ms:.4f} ms "
        f"(read 4, write 4 + 8 B an element); ht.sort(randn({SORT_ROWS}, {SORT_SEG}), axis=1): {rows_ms:.4f} ms; "
        f"ht.unique: {unique_ms:.4f} ms; ht.topk(x, {TOPK_K}): {topk_ms:.4f} ms beside torch.topk {torch_topk_ms:.4f} ms",
        flush=True,
    )
    profile_breakdown(f"ht.sort(randn({SORT_N}))", lambda: ht.sort(A))
    return rows


def _recovered(labels, k: int) -> bool:
    """Every one of k equal blocks of ``labels`` holds one label, and the k
    labels differ."""
    import torch

    blocks = labels.reshape(k, -1)
    firsts = blocks[:, 0]
    return bool((blocks == firsts[:, None]).all()) and len(torch.unique(firsts)) == k


def kmeans_path(dev) -> int:
    """The KMeans main path through the public entry points; returns K3's
    launches in the full-size fit."""
    import torch

    import heat_tpu_torch as ht
    from heat_tpu_torch.cluster import _cuda_assign as ca

    ht.random.seed(0)
    X = ht.random.randn(KM_N, KM_D, split=0)
    _require(X.larray.device == dev and X.dtype is ht.float32 and X.split == 0, "X is not a float32 split-0 array on the card")
    ca.ASSIGN_LAUNCHES = 0
    km = ht.cluster.KMeans(n_clusters=KM_K, init="kmeans++", max_iter=KM_ITERS, tol=-1.0, random_state=0).fit(X)
    torch.cuda.synchronize()
    launches = ca.ASSIGN_LAUNCHES
    centers, labels = km.cluster_centers_.larray, km.labels_.larray
    print(
        f"KMeans({KM_N}x{KM_D}, k={KM_K}, kmeans++).fit: n_iter {km.n_iter_}, K3 launches {launches}, "
        f"inertia {km.inertia_:.6e}, labels split {km.labels_.split} dtype {km.labels_.dtype.__name__}", flush=True,
    )
    _require(km.n_iter_ == KM_ITERS and launches == km.n_iter_, "the fit did not run every Lloyd step through K3")
    _require(tuple(centers.shape) == (KM_K, KM_D) and tuple(labels.shape) == (KM_N,), "fit result shapes")
    _require(bool(torch.isfinite(centers).all()) and math.isfinite(km.inertia_), "non-finite centers or inertia")
    _require(int(labels.min()) >= 0 and int(labels.max()) < KM_K, "labels out of range")
    _require(torch.equal(km.predict(X).larray, labels), "predict(X) differs from labels_")
    del X, km, labels

    # eight well-separated blobs of the same size, with known means
    gen = torch.Generator(device=dev)
    gen.manual_seed(6)
    # means 8·sqrt(2·64) apart against a spread of sqrt(64): k-means++ seeding
    # finds each blob, where the axis layout of phase 3 is too tight for it
    x = _blobs(gen, KM_N, torch.randn(KM_K, KM_D, device=dev, generator=gen) * 8.0)
    B = ht.array(x, split=0)
    km = ht.cluster.KMeans(n_clusters=KM_K, init="kmeans++", random_state=1).fit(B)
    ok = _recovered(km.labels_.larray, KM_K)
    print(f"blobs, kmeans++: n_iter {km.n_iter_}, every blob one distinct cluster: {ok}", flush=True)
    _require(ok, "kmeans++ did not recover the eight blobs")
    init = x[:: KM_N // KM_K].contiguous()
    km = ht.cluster.KMeans(n_clusters=KM_K, init=ht.array(init)).fit(B)
    c = init
    for _ in range(km.n_iter_):
        sums, counts, inertia = ca.fused_assign_plain(x, c)
        c = torch.where(counts[:, None] > 0, sums / torch.clamp_min(counts[:, None], 1), c)
    ec = _rel(km.cluster_centers_.larray, c)
    ei = abs(km.inertia_ - float(inertia)) / float(inertia)
    print(
        f"blobs, one point per blob: n_iter {km.n_iter_}; against a plain Lloyd loop: centers rel "
        f"{ec:.3e} (tol {TOL_SUMS}), inertia rel {ei:.3e} (tol {TOL_INERTIA})", flush=True,
    )
    _require(ec <= TOL_SUMS and ei <= TOL_INERTIA, "the fit disagrees with a Lloyd loop on the plain assignment")
    _require(_recovered(km.labels_.larray, KM_K), "the fit from one point per blob did not recover the blobs")
    del x, B, km

    # the reference benchmark's configuration (BASELINE.md, heat benchmarks/cb/cluster.py)
    data = ht.utils.data.create_spherical_dataset(5000, radius=0.5, offset=6.0, random_state=1)
    _require(tuple(data.shape) == (20000, 3) and data.larray.device == dev, "spherical data shape or device")
    for cls in (ht.cluster.KMeans, ht.cluster.KMedians, ht.cluster.KMedoids):
        ca.ASSIGN_LAUNCHES = 0
        est = cls(n_clusters=4, init="kmeans++", random_state=0).fit(data)
        ok = _recovered(est.labels_.larray, 4)
        print(
            f"reference config 4x5000x3, {cls.__name__}: n_iter {est.n_iter_}, K3 launches "
            f"{ca.ASSIGN_LAUNCHES}, every cluster recovered: {ok}", flush=True,
        )
        _require(ok, f"{cls.__name__} did not recover the four spherical clusters")
        _require(cls is not ht.cluster.KMeans or ca.ASSIGN_LAUNCHES == est.n_iter_, "KMeans ran without K3")
    return launches


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
    for single_pass in (False, True):
        profile_breakdown(
            f"hsvd_rank(single_pass={single_pass})",
            lambda: ht.linalg.hsvd_rank(A, MAXRANK, compute_sv=True, single_pass=single_pass),
        )
    return rows


def kmeans_timings(dev, launches: int, err: float) -> dict:
    """K3, its plain version and the one library product at the main
    shape, then the KMeans fit: per Lloyd iteration, its seeding and its
    final assignment, and a profile of one fit. Returns K3's row."""
    import torch

    import heat_tpu_torch as ht
    from heat_tpu_torch.cluster import _cuda_assign as ca
    from heat_tpu_torch.cluster._kcluster import _kmeanspp, _predict, make_fit_loop
    from heat_tpu_torch.cluster.kmeans import _lloyd_step

    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    x = torch.randn(KM_N, KM_D, device=dev, generator=gen)
    c = x[torch.randperm(KM_N, device=dev, generator=gen)[:KM_K]].contiguous()
    ms = _median_ms(lambda: ca.fused_assign(x, c), 10)
    plain_ms = _median_ms(lambda: ca.fused_assign_plain(x, c), 5)
    library_ms = _median_ms(lambda: torch.matmul(x, c.T), 10)
    n, d, k = float(KM_N), KM_D, KM_K
    nbytes = 4 * (n * d + k * d + k * d + k + 1)
    flops = 2 * n * k * d + 2 * n * k * (d + 2)
    bound_ms, bound_by = _bound(nbytes, flops)
    print(
        f"fused_assign: {ms:.4f} ms, plain {plain_ms:.4f} ms, library (x @ c.T) {library_ms:.4f} ms, "
        f"bound {bound_ms:.4f} ms ({bound_by})", flush=True,
    )
    row = {
        "name": "fused_assign", "route": "cuda", "source": "heat_tpu_torch/csrc/kmeans_assign.cu",
        "replaces": "heat_tpu/cluster/_pallas.py:66", "launches": launches, "max_abs_err": err,
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": library_ms,
    }

    X = ht.array(x, split=0)

    def fit():
        return ht.cluster.KMeans(
            n_clusters=KM_K, init="kmeans++", max_iter=KM_ITERS, tol=-1.0, random_state=0
        ).fit(X)

    fit_ms = _median_ms(fit, 3)
    seed_ms = _median_ms(lambda: _kmeanspp(x, KM_K, ht.random._next_generator(KM_K, dev)), 3)
    loop = make_fit_loop(_lloyd_step, -1.0, KM_ITERS, True)
    loop_ms = _median_ms(lambda: loop(x, c), 3)
    final_ms = _median_ms(lambda: _predict(x, c, "euclidean", True), 3)
    per_iter = loop_ms / KM_ITERS
    print(
        f"KMeans.fit({KM_N}x{KM_D}, k={KM_K}, kmeans++, {KM_ITERS} iterations): {fit_ms:.4f} ms "
        f"(median of 3, CUDA events); Lloyd loop {loop_ms:.4f} ms = {per_iter:.4f} ms per iteration, "
        f"{1e3 / per_iter:.2f} iterations per second (bound {row['bound_ms']:.4f} ms per iteration, one "
        f"read of X); seeding {seed_ms:.4f} ms; final assignment {final_ms:.4f} ms", flush=True,
    )
    profile_breakdown(f"KMeans.fit({KM_ITERS} iterations)", fit)
    return row


def profile_breakdown(label: str, call) -> None:
    """Device time by kernel for one ``call()``, from torch.profiler
    (device-side events only; the wall time includes the profiler's own
    cost)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        call()
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
        f"profile {label}: wall {wall_ms:.3f} ms, device busy "
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
    assign_err = check_assign(dev)
    sort_errs = check_sort(dev)
    launches = main_path(dev)
    assign_launches = kmeans_path(dev)
    sort_launches = sort_path(dev)
    rows = timings(dev, launches, errs)
    rows.append(kmeans_timings(dev, assign_launches, assign_err))
    rows.extend(sort_timings(dev, sort_launches, sort_errs))
    print(f"total {time.perf_counter() - t0:.1f} s", flush=True)
    print(json.dumps({"kernels": rows}))
    print(card)
    # every phase runs on cuda:0, so the run used one card
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": 1},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
