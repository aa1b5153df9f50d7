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
   (its cross-block sums run in a fixed order). K2 and K8 run on their
   Hopper kernels (``sketch_sm90.cu``, ``sddmm_sm90.cu``: 3xTF32 ``wgmma``,
   TMA-fed) wherever their predicates admit the shape, and there the
   kernels they replace (``sketch.cu``, ``spmm.cu``) run on the same inputs
   under the same limits; K2 at 1000 x 777 (n % 4 != 0) stays on
   ``sketch.cu``, at 1000 x 776 and 65536 x 8192 takes its Hopper kernel
   (also at ℓ = 64, k̂ = 32 and at ℓ = k̂ = 1 on inputs x 1e3); K8 takes
   d = 4, 60, 64, 72 and 128 on its Hopper kernel and d = 1 and 30 on
   ``spmm.cu``;
4. the main paths at full size, each kernel count set to 0 just before
   each call and read just after:
   - hSVD: ``ht.random.randn(65536, 8192, split=0)`` (the 2.1 GB float32
     per-chip shard of the north-star operation), then
     ``ht.linalg.hsvd_rank(A, 10, compute_sv=True)`` in the 2-pass form
     and with ``single_pass=True`` (K2 on its Hopper kernel, counted
     apart). The factors must be orthonormal, and
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
     must launch K4, and a float32 ``ht.sort`` must run nothing on the card
     but K4's kernels and memsets (profiled);
   - sparse: bench.py's ``spmm_1gb`` (16384^2, 16,384 full (8, 128)
     bricks, seed 0x18): ``ht.sparse.sparse_dbcsr_matrix(bsr, split=0) @
     x`` with k = 4 (K7 once), ``ht.sparse.sddmm(S, u, v)`` with d = 64
     (K8 once, on its Hopper kernel, counted apart) and the DCSR form ``sparse_csr_matrix(...) @ x``, each
     against a float64 reference; a card-scale matrix (131072^2,
     1,048,576 bricks, built on the card through the raw constructor),
     ``S @ x`` with k = 1 and 4 and ``sddmm`` with d = 64; bench.py's
     ``pagerank_2m`` (8192 nodes, ~2M edges) through ``ht.graph.pagerank``
     with tol 1e-8, K7 once per iteration, ranks within 1e-6 of a float64
     scipy power iteration;
   - attention: ``ht.nn.ring_attention(q, k, v, causal=True)`` on
     ``ht.random.randn(..., split=2)`` at bench.py's RA rows (4, 8, 4096,
     64) float32 and bf16 and its RAB row (1, 8, 16384, 128) bf16;
     ``ht.nn.functional.scaled_dot_product_attention`` on raw float32
     tensors at RA, not causal, and on bf16 heads of 256 (1, 8, 4096,
     256), causal; ``ht.nn.MultiheadAttention(1024, 8, causal=True,
     dtype=bf16)`` on x (1, 16384, 1024), 8 heads of 128. Each call must
     launch K9 exactly once, every one of them on its Hopper path
     (``attention_sm90.cu``: bf16 at D = 64, 128 and 256, float32 at D =
     64 in 3xTF32), and agree with the plain route (MultiheadAttention: K9
     on its strided heads against the plain version, and its output
     against that o through out_proj);
   - relayout: the packed pivot of bench.py's 1 GB reshape row, (1000,
     250000) float32 split 1 -> (10,000,000, 25) new_split=1 and back,
     planned by the port's planner as heat_tpu plans them at 8 ranks
     (packed-pivot, 9 all-to-alls each), with the executor's per-rank
     bodies of all 8 ranks run in this one process (8 ranks emulated; the
     exchange is a device copy, not NCCL, so the wall time is not a
     distributed timing). Both moves must equal torch.reshape bit for bit,
     issue the plan's collectives, and launch K5 8 times (forward) and K6 8
     times (reverse). Then world size 1 through the public entry points:
     ht.arange(2**27, split=0).sum() equal to its closed form in int64,
     and resplit and reshape(new_split=) of the 1 GB array against
     torch.reshape;
5. times as medians of CUDA-event readings, each beside its bound: the
   larger of the bytes that must move over 3.35 TB/s and the operations
   over 67 TFLOP/s (FP32 outside the tensor cores), the H100 SXM data-sheet
   peaks; and a profile of one call or fit of each main path. K4 is
   checked for exact equality with its plain version (it moves integers)
   at both regimes' main shapes, ragged and boundary segment lengths, the
   one-sweep tile boundaries and an odd size of 3,000,017, adversarial
   float32 keys, int32 extremes, constant digit places (all-equal keys,
   keys differing only in the top byte, randint(0, 1000)) and n = 1, and
   on a rerun; its fused entry against the plain composition of the key
   transforms and the pair sort in each transform mode, order and output;
   and one segment of 2^30 pairs against the invariants of a stable sort.
   Its rows time the fused entry the main path launches (values and int64
   indices, bound 16 B a pair) beside torch.sort, the words-only entry and
   the first design of K4 (``pr3_ms``). K7 and K8 are held
   against their plain versions within 1e-5 of each element's absolute-sum
   scale, and against themselves on a rerun bit for bit, at the main-path
   shapes, ragged 1003 x 777, empty brick rows, all-zero and pad bricks,
   an empty matrix and bf16 bricks; K8's rows time its Hopper kernel
   beside spmm.cu's (``pr4_ms``), K2's beside sketch.cu's (``pr1_ms``) and
   the three library calls that compute its outputs apart
   (``composed_ms``: g @ a, a @ omega, a.square().sum(); context, not a
   yardstick), both with the 3xTF32 and the FP32 CUDA-core operation
   bounds beside their byte bound; K7's library yardstick is PyTorch's
   sparse tensor of the same matrix, and PageRank is timed as its host
   build and its fixpoint. K9 is held against its plain version (float32
   |Δo| ≤ 1e-5 max|v|, |Δlse| ≤ 1e-5 (1 + |lse|); bf16 elementwise |Δo| ≤
   3 · 2^-8 (|o| + the attention of |v|) and |Δlse| ≤ 1e-4 (1 + |lse|)) and
   against itself on a rerun bit for bit, at RA (f32 causal and not, bf16),
   RAB, ragged 1000 x 777 keys with D = 72, D_v = 40, ragged causal 1003,
   causal S_q < S_kv, D = 8, D = 256, S_q = 1, scores scaled by 10 and
   S_kv = 0 (no launch); its Hopper path also at 1000 x 1000 causal and
   not, causal 300 x 1003, S_q = 1 against 4096 keys and scores x 10, each
   at bf16 D = 64, 128 and 256 and at float32 D = 64, and on MHA-1024's
   strided heads, and wherever it runs also against attention.cu's kernel
   on the same inputs (mma.sync for bf16, the FP32 kernel for float32)
   under the same limit, that kernel also against the plain version; the
   float32 cases print the library call's own error against the plain
   version beside K9's; attention.cu on the shapes the Hopper path
   refuses; its lse through the ring's combine of two halves of K/V; on
   the strided heads of a packed projection, bit for bit its result on
   copies; and under autograd (one launch, gradients within 1e-5 of the
   plain version's). Its bound is the operations over 989 TFLOP/s (bf16
   tensor cores) or, for float32, three times the operations over 495
   TFLOP/s (3xTF32 on the tensor cores; the FP32 CUDA-core bound, the
   operations over 67 TFLOP/s, beside it), or the bytes where larger; its
   library yardstick is ``scaled_dot_product_attention`` on the same
   inputs, checked to agree first; at every main shape the Hopper path
   and attention.cu's kernel are timed side by side; the public calls are
   timed end to end and one MultiheadAttention forward is profiled. K5 and K6 are held
   against their plain versions bit for bit (raw words) at the per-rank
   shapes of the 1 GB move over 8 ranks and of (2048, 64) <-> (8192, 16)
   over 4, ragged and degenerate shapes (no rows, p = 1, c_in = c_out),
   64-bit offsets, bool, int8, bf16, float32, float64, complex64 and
   complex128, and float32 NaN payloads and -0.0; their bound is the bytes
   read and written over 3.35 TB/s, and a clone() of the 160 MB buffer
   stands beside them as the card's copy rate (no single PyTorch call pads
   and block-transposes).

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
import warnings

HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12

M, N = 65536, 8192  # the north-star per-chip shard, float32
MAXRANK = 10
RAGGED = (1000, 777)  # n % 4 != 0: K2 keeps sketch.cu's kernel here
K2_RAGGED_SM90 = (1000, 776)  # ragged rows and columns on K2's Hopper kernel
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

SPARSE_SEED = 0x18  # bench.py's seed of spmm_1gb and pagerank_2m
SPMM_N, SPMM_OCC, SPMM_K = 16384, 0.0625, 4  # spmm_1gb (bench.py:117-122): 16,384 full bricks
SDDMM_D = 64
# d at K8's edges: 4 and 60 take its Hopper kernel below one pass of 64, 72
# and 128 in two passes; 30 (not a multiple of 4) keeps spmm.cu's kernel
K8_EDGE_D = (4, 30, 60, 72, 128)
CARD_N, CARD_BRICKS = 131072, 1 << 20  # 6.25% brick fill: 64 bricks per brick row, 4.29 GB
PR_N, PR_DEG, PR_TOL = 8192, 256, 1e-8  # pagerank_2m (bench.py:123-125)
PR_HEAT_TPU_ITERATIONS = 10  # heat_tpu's count on the CPU (docs/PERF.md:334)
# K7 and K8 against their plain versions, and the sparse path against its
# float64 references: |got - ref| <= 1e-5 * (the sum of the absolute
# terms), elementwise; float32 sums in another order stay within a few
# ulps of that scale (1e-5 is ~80 ulps)
TOL_SPARSE = 1e-5
TOL_RANKS = 1e-6  # PageRank against a float64 power iteration, absolute

BF16_FLOP_PER_S = 989e12  # dense bf16 tensor cores, H100 SXM data sheet
TF32_FLOP_PER_S = 495e12  # dense TF32 tensor cores, the same; 3xTF32 runs each float32 product three times
RA = (4, 8, 4096, 64)  # bench.py's RA_* rows (B, H, S, D), causal (bench.py:103)
RAB = (1, 8, 16384, 128)  # bench.py's RAB_* 16k-token long-context row (bench.py:109)
MHA_E, MHA_H = 1024, 8  # MultiheadAttention at RAB's attention shape: 8 heads of 128
SDPA_D256 = (1, 8, 4096, 256)  # bf16 heads of 256 (B, H, S, D), causal: K9's Hopper path at its widest head
# K9 against its plain version. float32: both sides sum float32 terms in
# other orders over up to 16384 keys, and o is a convex combination of v
# rows, so |Δo| <= 1e-5 max|v| of the (b, h) slice and |Δlse| <= 1e-5 (1 +
# |lse|). bfloat16, elementwise: K9 rounds p to bf16 for the second product
# (|Δ| <= 2^-8 A, A the attention of |v|) and both sides round o to bf16
# (2^-8 |o| each), so |Δo| <= 3 · 2^-8 (|ro| + A), which also covers the
# ring's combine of two rounded halves (2 |o| + 3 A); float32 scores and sums
# add ~1e-4 of that. lse stays float32: 1e-4 (1 + |lse|)
TOL_ATT_F32 = 1e-5
TOL_ATT_BF16_O = 3.0
TOL_ATT_BF16_LSE = 1e-4

# K5/K6 move bytes and must equal their plain versions bit for bit
RESHAPE_1GB = ((1000, 250000), (10_000_000, 25))  # bench.py's reshape_split1_1gb row
RELAYOUT_P8 = (1_250_000, 25, 32, 8)  # K5's per-rank (rows, c_in, c_out, p) of that move over 8 ranks
RELAYOUT_WIDE = (67_108_865, 31, 32, 8)  # rows x 32 > 2^31: the kernels' 64-bit index path


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
        # register use and spills (-Xptxas -v) of the main paths'
        # instantiations (K1 l=25, K2's Hopper kernel at k̂ ≤ 24 and
        # sketch.cu's ℓ=59 timed beside it, K3 k ≤ 8, K4's kernels of both
        # regimes (rows of 512: two warps a row), K7 k = 1 and 4, K8's
        # Hopper kernel and spmm.cu's timed beside it, K9's Hopper path at
        # bf16 D = 64, 128 and 256 and float32 D = 64, attention.cu's
        # kernels timed beside it (float32 at D_v = 64, mma.sync bf16 at
        # D_v = 256), K5/K6 on 4-byte words with 32-bit offsets); and any
        # wgmma that ptxas serialised
        for i, line in enumerate(lines):
            main = ("ILi25ELb0E", "ILi59ELb1E", "dual_sm90_kernelILi24E", "assign_kernelILi8E",
                    "seg_sort_kernelILi8ELi2E", "sweep_hist_kernel", "sweep_plan_kernel", "sweep_pass_kernel",
                    "brick_spmm_kernelILi1E", "brick_spmm_kernelILi4E", "brick_sddmm_kernel", "sddmm_sm90_kernel",
                    "attn_f32_kernelILi4ELi64E", "attn_bf16_kernelILi256E", "attn_sm90_kernelILi64ELi3E",
                    "attn_sm90_kernelILi128ELi2E", "attn_sm90_kernelILi256ELi2E", "attn_sm90_f32_kernelILi2E",
                    "11pack_kernelIjjE", "13unpack_kernelIjjE")
            if "serializ" in line.lower():
                print(f"ptxas {name}: {line.strip()}", flush=True)
            tags = [tag for tag in main if tag in line]
            if "Compiling entry function" in line and tags:
                detail = " | ".join(s.split(":", 1)[-1].strip() for s in lines[i + 1 : i + 4])
                print(f"ptxas {line.split(chr(39))[1][:48]} ({tags[0]}): {detail}", flush=True)


def _k2_case(cs, a, gen, l: int = 59, k: int = 24) -> dict:
    """K2 on ``a`` against its plain version, on the kernel its predicate
    picks (its Hopper launch count must show which), and against itself on
    a rerun; on the Hopper kernel sketch.cu's kernel runs on the same inputs
    too, held to the plain version under the same limits. Returns the main
    shape's largest errors (empty elsewhere)."""
    import torch

    m, n = a.shape
    g = torch.randn(l, m, device=a.device, generator=gen)
    omega = torch.randn(n, k, device=a.device, generator=gen)
    hopper = cs.dual_sketch_sm90_serviceable(l, k, a)
    before = cs.DUAL_SM90_LAUNCHES
    w, y, norm = cs.dual_sketch_with_norm(g, omega, a)
    pw, py, pnorm = cs.dual_sketch_with_norm_plain(g, omega, a)
    torch.cuda.synchronize()
    _require(cs.DUAL_SM90_LAUNCHES == before + int(hopper),
             f"K2 ({m}x{n}) {'did not take' if hopper else 'took'} the Hopper kernel")
    ew, ey, en = _rel(w, pw), _rel(y, py), abs(float(norm) - float(pnorm)) / float(pnorm)
    rerun = all(map(torch.equal, (w, y, norm), cs.dual_sketch_with_norm(g, omega, a)))
    route, old = "sketch_sm90" if hopper else "sketch", ""
    ok_old = True
    if hopper:
        ow, oy, onorm = cs._dual_sketch_with_norm_sketch_cu(g, omega, a)
        torch.cuda.synchronize()
        eow, eoy, eon = _rel(ow, pw), _rel(oy, py), abs(float(onorm) - float(pnorm)) / float(pnorm)
        ok_old = eow <= TOL_W and eoy <= TOL_W and eon <= TOL_NORM
        old = f"; sketch.cu's kernel: w rel {eow:.3e}, y rel {eoy:.3e}, norm rel {eon:.3e}"
    print(
        f"K2 {route} ({m}x{n}, l={l}, k={k}): w rel {ew:.3e}, y rel {ey:.3e} (tol {TOL_W}), "
        f"norm rel {en:.3e} (tol {TOL_NORM}), rerun identical {rerun}{old}", flush=True,
    )
    _require(ew <= TOL_W and ey <= TOL_W and en <= TOL_NORM and rerun and ok_old,
             f"K2 disagrees with its plain version or itself at {m}x{n}, l={l}, k={k}")
    if (m, n, l, k) != (M, N, 59, 24):
        return {}
    errs = {"dual_sketch_with_norm": max(float((w - pw).abs().max()), float((y - py).abs().max()))}
    if hopper:
        errs["dual_sketch_with_norm_pr1"] = max(float((ow - pw).abs().max()), float((oy - py).abs().max()))
    return errs


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
        errs.update(_k2_case(cs, a, gen))
        del a
    # a ragged shape the Hopper kernel serves (n % 4 == 0), and the widest
    # row and column sketches it takes
    a = torch.randn(*K2_RAGGED_SM90, device=dev, generator=gen)
    _k2_case(cs, a, gen)
    _k2_case(cs, a, gen, l=64, k=32)
    _k2_case(cs, a * 1e3, gen, l=1, k=1)
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


# K4's fused entry in each transform mode, order and output: (total, descending, out)
K4_FUSED_MODES = ((False, False, "values"), (False, True, "values"), (False, False, "words"),
                  (True, True, None), (True, True, "values"), (True, False, "values"))


def _bits_of(t):
    import torch

    return t.view(torch.int32) if t.dtype == torch.float32 else t


def _fused_case(ks, label: str, x, seg_len=None, modes=K4_FUSED_MODES) -> int:
    """K4's fused entry against its plain composition (sort_key,
    pair_sort_plain, from_sortable) bit for bit, and against itself on a
    rerun, in each (total, descending, out) of ``modes``. Returns the
    largest absolute difference of the raw bits."""
    import torch

    err, rerun = 0, True
    for total, descending, out in modes:
        got = ks.fused_sort(x, seg_len, total=total, descending=descending, out=out)
        ref = ks.fused_sort_plain(x, seg_len, total=total, descending=descending, out=out)
        again = ks.fused_sort(x, seg_len, total=total, descending=descending, out=out)
        torch.cuda.synchronize()
        for g, r, a in zip(got, ref, again):
            _require((g is None) == (r is None) and (g is None or g.dtype == r.dtype), f"K4 fused ({label}) types")
            if g is not None:
                err = max(err, int((_bits_of(g).long() - _bits_of(r).long()).abs().max()))
                rerun = rerun and torch.equal(_bits_of(g), _bits_of(a))
    print(f"K4 fused ({label}, {len(modes)} transform/order/output modes): max |difference| of the bits from "
          f"the plain composition {err} (tol 0), rerun identical {rerun}", flush=True)
    _require(err == 0 and rerun, f"K4's fused entry disagrees with its plain composition or itself ({label})")
    return err


def _k4_huge_case(ks, gen, dev, n: int) -> None:
    """One segment of n pairs, too large for the plain version: the result
    must be a stable sort, which the invariants below pin exactly (keys
    non-decreasing, payloads a permutation, keys equal to the input at the
    payloads, payloads increasing within each run of equal keys), and a
    rerun must give the same bits."""
    import torch

    keys = _random_words(gen, n, dev)
    t0 = time.perf_counter()
    out_k, out_p = ks.pair_sort(keys)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    seen = torch.zeros(n, dtype=torch.bool, device=dev)
    step = 1 << 26
    ok = True
    for s in range(0, n, step):
        e = min(n, s + step + 1)
        k, p = _unsigned(out_k[s:e]), out_p[s:e].long()
        ok &= bool((k[1:] >= k[:-1]).all())
        ties = k[1:] == k[:-1]
        ok &= bool((p[1:][ties] > p[:-1][ties]).all())
        ok &= torch.equal(keys[p[: step]], out_k[s : s + step])
        seen[p[: step]] = True
        del k, p, ties
    ok &= bool(seen.all())
    del seen
    again_k, again_p = ks.pair_sort(keys)
    rerun = torch.equal(out_k, again_k) and torch.equal(out_p, again_p)
    print(f"K4 (n={n}, one segment, {-(-n // 4096)} tiles in the look-back): a stable sort of the keys {ok}, "
          f"rerun identical {rerun} (first call {ms:.1f} ms by the host clock)", flush=True)
    _require(ok and rerun, f"K4 at n={n} is not the stable sort of its keys, or a rerun differs")


def check_sort(dev) -> dict:
    """K4 against its plain version at the listed shapes; returns the
    largest error of each regime's main shape."""
    import torch

    from heat_tpu_torch.kernels import sort as ks

    gen = torch.Generator(device=dev)
    gen.manual_seed(8)
    errs = {}
    keys = _random_words(gen, SORT_N, dev)
    errs["pair_sort_one_segment"] = max(_k4_case(ks, f"n={SORT_N}, one segment", keys),
                                        _fused_case(ks, f"n={SORT_N} float32 randn, one segment",
                                                    torch.randn(SORT_N, device=dev, generator=gen)))
    del keys
    keys, pays = _random_words(gen, SORT_N, dev, 1000), _random_words(gen, SORT_N, dev)
    _k4_case(ks, f"n={SORT_N}, 1000 key values, pay_bytes=4", keys, pays, pay_bytes=4)
    del keys, pays
    keys = _random_words(gen, SORT_ROWS * SORT_SEG, dev)
    errs["pair_sort_segments"] = max(
        _k4_case(ks, f"{SORT_ROWS} segments of {SORT_SEG}", keys, seg_len=SORT_SEG),
        _fused_case(ks, f"{SORT_ROWS} float32 randn segments of {SORT_SEG}",
                    torch.randn(SORT_ROWS * SORT_SEG, device=dev, generator=gen), SORT_SEG))
    del keys
    for rows, seg in ((10_007, 777), (2048, ks.SEG_MAX), (1, ks.SEG_MAX + 1), (1, 1), (100_003, 100),
                      (1, 2 * 4096 - 1), (1, 2 * 4096), (1, 2 * 4096 + 1), (1, 3_000_017)):
        words = _random_words(gen, rows * seg, dev, 3000)
        _k4_case(ks, f"{rows} segment(s) of {seg}", words, seg_len=seg)
        _fused_case(ks, f"{rows} segment(s) of {seg}, the words as float32", words.view(torch.float32), seg)
    for kind in ("sorted", "reverse", "const", "fewuniq", "nan", "specials"):
        x = _adversarial_f32(kind, gen, dev)
        u = ks.to_sortable(x)
        _k4_case(ks, f"{kind} float32 keys, one segment of {ADV_N}", u)
        _k4_case(ks, f"{kind} float32 keys, segments of {SORT_SEG}", u, seg_len=SORT_SEG)
        _fused_case(ks, f"{kind} float32, one segment of {ADV_N}", x)
        _fused_case(ks, f"{kind} float32, segments of {SORT_SEG}", x, SORT_SEG)
    ints = _random_words(gen, ADV_N, dev)
    ends = torch.tensor([-(2**31), -(2**31) + 1, -1, 0, 1, 2**31 - 2, 2**31 - 1], device=dev, dtype=torch.int32)
    pick = torch.rand(ADV_N, device=dev, generator=gen) < 0.5
    ints[pick] = ends[torch.randint(0, len(ends), (int(pick.sum()),), device=dev, generator=gen)]
    _fused_case(ks, f"int32 with its extremes, one segment of {ADV_N}", ints)
    _fused_case(ks, f"int32 with its extremes, segments of {SORT_SEG}", ints, SORT_SEG)
    # constant digit places, whose passes the one-sweep regime skips
    n = ADV_N + 3
    top = torch.randint(0, 256, (n,), device=dev, generator=gen, dtype=torch.int32)
    for label, words in (
        ("all-equal keys (every place constant)", torch.full((n,), 0x3F800000, device=dev, dtype=torch.int32)),
        ("keys that differ only in the top byte", (top << 24) | 0x123456),
        ("randint(0, 1000) (the top two bytes constant)", _random_words(gen, n, dev, 1000)),
    ):
        _k4_case(ks, f"{label}, one segment of {n}", words)
        _fused_case(ks, f"{label} as float32, one segment of {n}", words.view(torch.float32))
        _fused_case(ks, f"{label} as int32, one segment of {n}", words)
    del x, u, ints, top, words
    _k4_huge_case(ks, gen, dev, 1 << 30)
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


# K4's kernels and the memsets of its state: all that ht.sort of float32
# may run on the card (csrc/radix_sort.cu)
K4_KERNELS = ("sweep_hist_kernel", "sweep_plan_kernel", "sweep_pass_kernel", "seg_sort_kernel", "Memset")
FIRST_SORT_MS = 18.8688  # ht.sort(randn(2^27)) on K4's first design (PERF.md §5)


def sort_timings(dev, launches: dict, errs: dict) -> list:
    """K4 in both regimes (the fused entry the main path launches) beside
    its plain version, torch.sort, the words-only entry and K4's first design,
    then the public calls end to end and a profile of ht.sort; returns
    K4's rows."""
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
        vals = x if seg is None else X.reshape(-1)
        words = ks.to_sortable(vals)
        plan = ks.sort_plan(SORT_N, seg_len=seg)
        # in turns: old, new, new, old
        pr3_ms = _median_ms(lambda: ks._pair_sort_pr3(words, seg_len=seg), 10)
        ms = _median_ms(lambda: ks.fused_sort(vals, seg_len=seg), 10)
        words_ms = _median_ms(lambda: ks.pair_sort(words, seg_len=seg), 10)
        pr3_again_ms = _median_ms(lambda: ks._pair_sort_pr3(words, seg_len=seg), 10)
        plain_ms = _median_ms(lambda: ks.fused_sort_plain(vals, seg_len=seg), 2)
        library_ms = _median_ms(library, 10)
        # the fused entry: read each value once, write each value and int64 index once
        bound_ms, bound_by = _bound(16.0 * SORT_N, 0.0)
        model_ms = plan["hbm_bytes"] / HBM_BYTES_PER_S * 1e3
        print(
            f"{name} (K4 fused, {plan['path']}, n={SORT_N} float32{'' if seg is None else f' in segments of {seg}'}, "
            f"values and int64 indices): {ms:.4f} ms, torch.sort(stable=True) {library_ms:.4f} ms "
            f"(K4 faster: {ms <= library_ms}), plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}, 16 B a "
            f"pair); words in and out (12 B a pair): this design {words_ms:.4f} ms, the first design {pr3_ms:.4f} / "
            f"{pr3_again_ms:.4f} ms; pass model {plan['passes']} passes, {plan['hbm_bytes'] / 1e9:.4f} GB, "
            f"{model_ms:.4f} ms at 3.35 TB/s ({plan['hbm_bytes'] / (ms * 1e-3) / 1e9:.1f} GB/s of model bytes "
            f"achieved)", flush=True,
        )
        rows.append({
            "name": name, "route": "cuda", "source": "heat_tpu_torch/csrc/radix_sort.cu",
            "replaces": "heat_tpu/kernels/sort.py:253", "launches": launches[key], "max_abs_err": errs[name],
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms,
            "words_ms": words_ms, "pr3_ms": min(pr3_ms, pr3_again_ms),
        })
        del words
    A = ht.array(x, split=0)
    floor_ms = ks.sort_plan(SORT_N)["floor_bytes"] / HBM_BYTES_PER_S * 1e3
    sort_ms = _median_ms(lambda: ht.sort(A), 5)
    desc_ms = _median_ms(lambda: ht.sort(A, descending=True), 5)
    unique_ms = _median_ms(lambda: ht.unique(A), 5)
    topk_ms = _median_ms(lambda: ht.topk(A, TOPK_K), 5)
    torch_topk_ms = _median_ms(lambda: torch.topk(x, TOPK_K), 5)
    rows_ms = _median_ms(lambda: ht.sort(ht.array(X, split=0), axis=1), 5)
    print(
        f"ht.sort(randn({SORT_N})): {sort_ms:.4f} ms (median of 5, CUDA events; on the first design: "
        f"{FIRST_SORT_MS} ms), floor {floor_ms:.4f} ms (read 4, write 4 + 8 B an element); descending {desc_ms:.4f} ms; "
        f"ht.sort(randn({SORT_ROWS}, {SORT_SEG}), axis=1): {rows_ms:.4f} ms; ht.unique: {unique_ms:.4f} ms; "
        f"ht.topk(x, {TOPK_K}): {topk_ms:.4f} ms beside torch.topk {torch_topk_ms:.4f} ms", flush=True,
    )
    kernels = profile_breakdown(f"ht.sort(randn({SORT_N}))", lambda: ht.sort(A))
    others = [k for k in kernels if not any(tag in k for tag in K4_KERNELS)]
    print(f"ht.sort(randn({SORT_N})) ran {len(kernels)} kinds of device work, none outside K4: {not others}",
          flush=True)
    _require(not others, f"ht.sort of float32 ran device work outside K4: {others}")
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
        cs.SKETCH_LAUNCHES = cs.DUAL_LAUNCHES = cs.DUAL_SM90_LAUNCHES = 0
        U, sigma, V, err = ht.linalg.hsvd_rank(A, MAXRANK, compute_sv=True, single_pass=single_pass)
        torch.cuda.synchronize()
        counts = {"sketch_with_norm": cs.SKETCH_LAUNCHES, "dual_sketch_with_norm": cs.DUAL_LAUNCHES,
                  "dual_sketch_sm90": cs.DUAL_SM90_LAUNCHES}
        launches[kernel] = counts[kernel]
        s = sigma.larray
        ou, ov = _orthonormal_err(U.larray), _orthonormal_err(V.larray)
        print(
            f"hsvd_rank({M}x{N}, {MAXRANK}, single_pass={single_pass}): launches {counts}, "
            f"U {tuple(U.shape)} V {tuple(V.shape)}, orthonormality {ou:.2e}/{ov:.2e} (tol 1e-4), "
            f"sigma[0]={float(s[0]):.4f} sigma[-1]={float(s[-1]):.4f}, err={float(err):.6f}", flush=True,
        )
        _require(counts[kernel] > 0, f"the main path ran without kernel {kernel}")
        _require(not single_pass or counts["dual_sketch_sm90"] == counts[kernel],
                 "the one-view hsvd_rank ran K2 off its Hopper kernel")
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
    # K1 (sketch.cu): bound the larger of the bytes and the FP32 operations
    ms = _median_ms(lambda: cs.sketch_with_norm(g1, a), 10)
    plain_ms = _median_ms(lambda: cs.sketch_with_norm_plain(g1, a), 5)
    library_ms = _median_ms(lambda: torch.matmul(g1, a), 10)
    bound_ms, bound_by = _bound(4 * (mn + 25 * M + 25 * N + 1), 2 * 25 * mn + 2 * mn)
    print(f"sketch_with_norm: {ms:.4f} ms, plain {plain_ms:.4f} ms, library (g @ a) {library_ms:.4f} ms, "
          f"bound {bound_ms:.4f} ms ({bound_by})", flush=True)
    rows.append({
        "name": "sketch_with_norm", "route": "cuda", "source": "heat_tpu_torch/csrc/sketch.cu",
        "replaces": "heat_tpu/core/linalg/_pallas_sketch.py:56", "launches": launches["sketch_with_norm"],
        "max_abs_err": errs["sketch_with_norm"], "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": bound_by, "library_ms": library_ms,
    })
    # K2 on its Hopper kernel (sketch_sm90.cu, 3xTF32 on the tensor cores):
    # bound the read of A (the bytes), beside the 3xTF32 operation bound and
    # the FP32 CUDA-core bound that held sketch.cu's kernel (pr1_ms: that
    # kernel on the same inputs); composed_ms: g @ a, a @ omega and
    # a.square().sum() back to back, context only (three reads of A)
    _require(cs.dual_sketch_sm90_serviceable(59, 24, a), "K2's main shape is off its Hopper kernel")
    flops = 2 * (59 + 24) * mn + 2 * mn
    nbytes = 4 * (mn + 59 * M + 24 * N + 59 * N + 24 * M + 1)
    ms = _median_ms(lambda: cs.dual_sketch_with_norm(g2, omega, a), 10)
    pr1_ms = _median_ms(lambda: cs._dual_sketch_with_norm_sketch_cu(g2, omega, a), 10)
    ms_again = _median_ms(lambda: cs.dual_sketch_with_norm(g2, omega, a), 10)
    pr1_again = _median_ms(lambda: cs._dual_sketch_with_norm_sketch_cu(g2, omega, a), 10)
    plain_ms = _median_ms(lambda: cs.dual_sketch_with_norm_plain(g2, omega, a), 5)
    composed_ms = _median_ms(lambda: (torch.matmul(g2, a), torch.matmul(a, omega), a.square().sum()), 10)
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    tf32_ms = 3 * flops / TF32_FLOP_PER_S * 1e3
    fp32_ms = flops / FP32_FLOP_PER_S * 1e3
    print(
        f"dual_sketch_with_norm (K2 sketch_sm90.cu): {ms:.4f} ms [{ms_again:.4f}], sketch.cu's kernel (pr1_ms) "
        f"{pr1_ms:.4f} ms [{pr1_again:.4f}], plain {plain_ms:.4f} ms, composed (g @ a, a @ omega, a.square().sum()) "
        f"{composed_ms:.4f} ms; bound {bound_ms:.4f} ms (bytes: {nbytes / 1e9:.4f} GB), 3xTF32 operations "
        f"{tf32_ms:.4f} ms, FP32 CUDA cores {fp32_ms:.4f} ms; {nbytes / (ms * 1e-3) / 1e9:.1f} GB/s achieved, "
        f"{bound_ms / ms:.1%} of the bound", flush=True,
    )
    rows.append({
        "name": "dual_sketch_with_norm", "route": "cuda", "source": "heat_tpu_torch/csrc/sketch_sm90.cu",
        "replaces": "heat_tpu/core/linalg/_pallas_sketch.py:105", "launches": launches["dual_sketch_with_norm"],
        "max_abs_err": errs["dual_sketch_with_norm"], "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": "bytes", "library_ms": None, "pr1_ms": pr1_ms, "pr1_err": errs["dual_sketch_with_norm_pr1"],
        "composed_ms": composed_ms, "bound_3xtf32_ms": tf32_ms, "bound_fp32_ms": fp32_ms,
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


# --------------------------------------------------------------------- #
# the sparse engine and PageRank (kernels K7 and K8)                    #
# --------------------------------------------------------------------- #
def sparse_inputs() -> dict:
    """The host inputs of the sparse rows, built as bench.py builds them
    (seed 0x18): spmm_1gb's BSR and pagerank_2m's adjacency."""
    import numpy as np
    import scipy.sparse as sp

    t0 = time.perf_counter()
    rng = np.random.default_rng(SPARSE_SEED)
    smb, snb = SPMM_N // 8, SPMM_N // 128
    lin = np.sort(rng.choice(smb * snb, int(smb * snb * SPMM_OCC), replace=False))
    brow = (lin // snb).astype(np.int32)
    indptr = np.zeros(smb + 1, np.int64)
    np.add.at(indptr, brow + 1, 1)
    bsr = sp.bsr_matrix(
        (rng.standard_normal((lin.size, 8, 128)).astype(np.float32), (lin % snb).astype(np.int32), np.cumsum(indptr)),
        shape=(SPMM_N, SPMM_N),
    )
    prng = np.random.default_rng(SPARSE_SEED)
    src, dst = prng.integers(0, PR_N, PR_N * PR_DEG), prng.integers(0, PR_N, PR_N * PR_DEG)
    keep = src != dst
    graph = sp.csr_matrix((np.ones(int(keep.sum()), np.float32), (src[keep], dst[keep])), shape=(PR_N, PR_N))
    graph.sum_duplicates()
    print(
        f"sparse inputs on the host: spmm_1gb {SPMM_N}^2 with {lin.size} bricks ({bsr.nnz} nnz), pagerank_2m "
        f"{PR_N} nodes with {graph.nnz} edges, {time.perf_counter() - t0:.1f} s", flush=True,
    )
    return {"bsr": bsr, "graph": graph}


def card_matrix(dev, ht):
    """The card-scale brick matrix, built on the card from a seeded
    generator and passed to the raw constructor: 131072^2, 1,048,576
    distinct bricks (6.25% of the brick grid, 64 per brick row on average,
    bcol ascending within each row), randn data."""
    import torch

    gen = torch.Generator(device=dev)
    gen.manual_seed(SPARSE_SEED)
    mb, nb = CARD_N // 8, CARD_N // 128
    lin = torch.sort(torch.randperm(mb * nb, device=dev, generator=gen)[:CARD_BRICKS]).values
    brow, bcol = (lin // nb).to(torch.int32), (lin % nb).to(torch.int32)
    bdata = torch.randn(CARD_BRICKS, 8, 128, device=dev, generator=gen)
    bmask = torch.ones(CARD_BRICKS, 8, dtype=torch.bool, device=dev)
    gnnz = int(torch.count_nonzero(bdata))
    return ht.sparse.DBCSR_matrix(bdata, bcol, brow, bmask, ((0, mb, CARD_BRICKS),), gnnz, CARD_BRICKS,
                                  (CARD_N, CARD_N), ht.float32, 0, ht.gpu, ht.get_comm())


def _k7_case(ks, label: str, S, k: int, gen, dtype=None) -> float:
    """K7 against its plain version on S's bricks (widened from ``dtype``
    when given), within TOL_SPARSE of the absolute-sum scale, and against
    itself on a rerun, bit for bit. Returns the largest absolute error."""
    import torch

    bdata, bcol, brow, bmask = S._phys_components
    bd = bdata.float()
    x = torch.randn(S.shape[1], k, device=bd.device, generator=gen)
    y = ks.brick_spmm(bd, bcol, brow, bmask, S._brick_rowptr, x, S.shape[0])
    again = ks.brick_spmm(bd, bcol, brow, bmask, S._brick_rowptr, x, S.shape[0])
    ref = ks.brick_spmm_plain(bd, bcol, brow, bmask, x, S.shape[0])
    scale = ks.brick_spmm_plain(bd.abs(), bcol, brow, bmask, x.abs(), S.shape[0])
    torch.cuda.synchronize()
    err = float((y - ref).abs().max()) if y.numel() else 0.0
    rel = float(((y - ref).abs() / scale.clamp_min(1e-30)).max()) if y.numel() else 0.0
    rerun = torch.equal(y, again)
    print(f"K7 ({label}, k={k}): max |err| {err:.3e}, max err/scale {rel:.3e} (tol {TOL_SPARSE}), rerun identical {rerun}",
          flush=True)
    _require(bool(((y - ref).abs() <= TOL_SPARSE * scale).all()) and rerun,
             f"K7 disagrees with its plain version or itself ({label}, k={k})")
    return err


def _k8_case(ks, label: str, S, d: int, gen) -> tuple:
    """K8 against its plain version, within TOL_SPARSE of the scale
    |s|·(|u|·|v|ᵀ), and on a rerun bit for bit, on the kernel its predicate
    picks (its Hopper launch count must show which); on the Hopper kernel
    spmm.cu's kernel runs on the same inputs too, held to the plain version
    under the same limit. Returns the largest absolute errors of the route's
    kernel and of spmm.cu's (None off the Hopper kernel)."""
    import torch

    sdata, bcol, brow, _ = S._phys_components
    sd = sdata.float()
    u = torch.randn(S.shape[0], d, device=sd.device, generator=gen)
    v = torch.randn(S.shape[1], d, device=sd.device, generator=gen)
    hopper = ks.sddmm_sm90_serviceable(d, S.shape[0], (u.data_ptr(), v.data_ptr(), sd.data_ptr()))
    before = ks.SDDMM_SM90_LAUNCHES
    out = ks.brick_sddmm(sd, brow, bcol, *S._brick_colorder, u, v)
    again = ks.brick_sddmm(sd, brow, bcol, *S._brick_colorder, u, v)
    _require(ks.SDDMM_SM90_LAUNCHES == before + 2 * int(hopper),
             f"K8 ({label}, d={d}) {'did not take' if hopper else 'took'} the Hopper kernel")
    ref = ks.brick_sddmm_plain(sd, brow, bcol, u, v)
    scale = ks.brick_sddmm_plain(sd.abs(), brow, bcol, u.abs(), v.abs())
    torch.cuda.synchronize()
    err = float((out - ref).abs().max())
    rel = float(((out - ref).abs() / scale.clamp_min(1e-30)).max())
    rerun = torch.equal(out, again)
    ok_old, old, old_err = True, "", None
    if hopper:
        del again
        again = ks._brick_sddmm_spmm_cu(sd, brow, bcol, *S._brick_colorder, u, v)
        torch.cuda.synchronize()
        old_err = float((again - ref).abs().max())
        old_rel = float(((again - ref).abs() / scale.clamp_min(1e-30)).max())
        ok_old = old_rel <= TOL_SPARSE
        old = f"; spmm.cu's kernel: max |err| {old_err:.3e}, max err/scale {old_rel:.3e}"
    print(f"K8 {'sddmm_sm90' if hopper else 'spmm'} ({label}, d={d}): max |err| {err:.3e}, max err/scale {rel:.3e} "
          f"(tol {TOL_SPARSE}), rerun identical {rerun}{old}", flush=True)
    _require(bool(((out - ref).abs() <= TOL_SPARSE * scale).all()) and rerun and ok_old,
             f"K8 disagrees with its plain version or itself ({label}, d={d})")
    del out, again, ref, scale
    return err, old_err


def check_spmm(dev, inputs: dict) -> dict:
    """K7 and K8 against their plain versions at the main-path shapes and
    at ragged, empty-row, zero-brick, empty and bf16 ones; returns the
    largest error at each main-path shape."""
    import numpy as np
    import scipy.sparse as sp
    import torch

    import heat_tpu_torch as ht
    from heat_tpu_torch.graph.pagerank import _transition
    from heat_tpu_torch.kernels import spmm as ks

    gen = torch.Generator(device=dev)
    gen.manual_seed(10)
    errs = {}
    S = ht.sparse.sparse_dbcsr_matrix(inputs["bsr"], split=0)
    for k in (1, SPMM_K, 64):
        e = _k7_case(ks, f"spmm_1gb, {S.nbricks} bricks", S, k, gen)
        errs.setdefault(f"spmm_1gb_k{k}", e)
    for d in (1, SDDMM_D):
        errs[f"sddmm_1gb_d{d}"] = _k8_case(ks, f"spmm_1gb, {S.nbricks} bricks", S, d, gen)
    M = ht.sparse.sparse_dbcsr_matrix(_transition(inputs["graph"], np.float32)[0], split=0)
    errs["pagerank_k1"] = _k7_case(ks, f"pagerank_2m transition, {M.nbricks} bricks", M, 1, gen)
    del S, M

    C = card_matrix(dev, ht)
    for k in (1, SPMM_K):
        errs[f"card_k{k}"] = _k7_case(ks, f"{CARD_N}^2, {CARD_BRICKS} bricks", C, k, gen)
    errs[f"card_sddmm_d{SDDMM_D}"] = _k8_case(ks, f"{CARD_N}^2, {CARD_BRICKS} bricks", C, SDDMM_D, gen)
    del C
    torch.cuda.empty_cache()

    rng = np.random.default_rng(11)
    ragged = sp.random(1003, 777, density=0.02, format="csr", dtype=np.float32, random_state=rng)
    R = ht.sparse.sparse_dbcsr_matrix(ragged)
    # every third brick row holds bricks, the rest are empty rows
    dense = np.zeros((4096, 4096), np.float32)
    dense[::24] = rng.standard_normal((len(range(0, 4096, 24)), 4096)) * (rng.random((171, 4096)) < 0.05)
    E = ht.sparse.sparse_dbcsr_matrix(sp.csr_matrix(dense))
    # stored bricks of all zeros, and pad bricks after the real ones
    bdata, bcol, brow, bmask = R._phys_components
    zero = bdata.clone()
    zero[::3] = 0
    pads = 5
    Z = ht.sparse.DBCSR_matrix(
        torch.cat([zero, torch.zeros(pads, 8, 128, device=dev)]), torch.cat([bcol, bcol[:pads] * 0]),
        torch.cat([brow, brow[:pads] * 0]), torch.cat([bmask, torch.zeros(pads, 8, dtype=torch.bool, device=dev)]),
        ((0, R.mb, R.nbricks),), R.gnnz, R.nbricks, R.shape, ht.float32, None, ht.gpu, ht.get_comm(),
    )
    empty = ht.sparse.sparse_dbcsr_matrix(sp.csr_matrix((37, 300), dtype=np.float32))
    _require(empty.slab_bricks == 1 and empty.nbricks == 0, "the empty matrix is not one pad brick")
    half = R.astype(ht.bfloat16)
    for label, A in (("ragged 1003x777", R), ("4096^2 with empty rows", E), ("zero and pad bricks", Z),
                     ("empty 37x300, one pad brick", empty), ("bf16 bricks, 1003x777", half)):
        for k in (1, SPMM_K, 64):
            _k7_case(ks, label, A, k, gen)
        for d in (1, SDDMM_D) + K8_EDGE_D:
            _k8_case(ks, label, A, d, gen)
    return errs


def _scale_check(label: str, got, ref, scale, tol: float) -> float:
    """|got - ref| <= tol * scale elementwise (float64); returns the
    largest err/scale."""
    import numpy as np

    got, ref, scale = (np.asarray(a, dtype=np.float64) for a in (got, ref, scale))
    _require(got.shape == ref.shape, f"{label}: shape {got.shape}, expected {ref.shape}")
    _require(bool(np.isfinite(got).all()), f"{label}: non-finite values")
    rel = float(np.max(np.abs(got - ref) / np.maximum(scale, 1e-30))) if got.size else 0.0
    print(f"{label}: max err/scale against the float64 reference {rel:.3e} (tol {tol})", flush=True)
    _require(rel <= tol, f"{label} disagrees with its float64 reference")
    return rel


def _pagerank_reference(graph, alpha=0.85, tol=1e-13, max_iter=1000):
    """float64 power iteration with scipy, uniform dangling teleport."""
    import numpy as np
    import scipy.sparse as sp

    n = graph.shape[0]
    outdeg = np.asarray(graph.sum(axis=1)).ravel().astype(np.float64)
    dangling = outdeg == 0
    M = (sp.diags(np.where(dangling, 0.0, 1.0 / np.maximum(outdeg, 1.0))) @ graph.astype(np.float64)).T.tocsr()
    r = np.full(n, 1.0 / n)
    for _ in range(max_iter):
        r_new = alpha * (M @ r + r[dangling].sum() / n) + (1 - alpha) / n
        done = np.abs(r_new - r).sum() < tol
        r = r_new
        if done:
            break
    return r / r.sum()


def sparse_path(dev, inputs: dict) -> dict:
    """The sparse main path through the public entry points, each call
    with the kernel counts set to 0 just before it and read just after;
    returns the launches of each call."""
    import numpy as np
    import torch

    import heat_tpu_torch as ht
    from heat_tpu_torch.kernels import spmm as ks

    def run(label: str, call):
        ks.SPMM_LAUNCHES = ks.SDDMM_LAUNCHES = ks.SDDMM_SM90_LAUNCHES = 0
        out = call()
        torch.cuda.synchronize()
        counts = (ks.SPMM_LAUNCHES, ks.SDDMM_LAUNCHES)
        print(f"{label}: K7 launches {counts[0]}, K8 launches {counts[1]} (on its Hopper kernel "
              f"{ks.SDDMM_SM90_LAUNCHES})", flush=True)
        _require(ks.SDDMM_SM90_LAUNCHES == counts[1], f"{label}: K8 ran off its Hopper kernel")
        return out, counts

    launches = {}
    rng = np.random.default_rng(12)
    bsr = inputs["bsr"]
    t0 = time.perf_counter()
    S = ht.sparse.sparse_dbcsr_matrix(bsr, split=0)
    print(f"spmm_1gb: sparse_dbcsr_matrix {time.perf_counter() - t0:.2f} s, {S}", flush=True)
    _require(S.nbricks == int((SPMM_N // 8) * (SPMM_N // 128) * SPMM_OCC) and S._phys_components[0].device == dev, "spmm_1gb matrix geometry or device")
    x = rng.standard_normal((SPMM_N, SPMM_K)).astype(np.float32)
    y, counts = run(f"spmm_1gb: S @ x, x ({SPMM_N}, {SPMM_K})", lambda: S @ x)
    launches["spmm_1gb"] = counts[0]
    _require(counts == (1, 0) and y.split == 0 and y.larray.device == dev, "S @ x did not run K7 once")
    absA = abs(bsr).astype(np.float64)
    _scale_check("spmm_1gb S @ x vs scipy", y.numpy(), bsr.astype(np.float64) @ x.astype(np.float64),
                 absA @ np.abs(x).astype(np.float64), TOL_SPARSE)
    D = ht.sparse.sparse_csr_matrix(bsr, split=0)
    yd, counts = run("spmm_1gb: DCSR @ x (index_add_)", lambda: D @ x)
    _require(counts == (0, 0), "the DCSR form ran a brick kernel")
    _scale_check("spmm_1gb DCSR @ x vs scipy", yd.numpy(), bsr.astype(np.float64) @ x.astype(np.float64),
                 absA @ np.abs(x).astype(np.float64), TOL_SPARSE)
    del D, yd
    u = torch.from_numpy(rng.standard_normal((SPMM_N, SDDMM_D)).astype(np.float32)).to(dev)
    v = torch.from_numpy(rng.standard_normal((SPMM_N, SDDMM_D)).astype(np.float32)).to(dev)
    C, counts = run(f"spmm_1gb: sddmm(S, u, v), d={SDDMM_D}", lambda: ht.sparse.sddmm(S, u, v))
    launches["sddmm_1gb"] = counts[1]
    _require(counts == (0, 1) and C.nbricks == S.nbricks, "sddmm did not run K8 once")
    sdata, bcol, brow, _ = S._phys_components
    ref = ks.brick_sddmm_plain(sdata.double(), brow, bcol, u.double(), v.double())
    scale = ks.brick_sddmm_plain(sdata.double().abs(), brow, bcol, u.double().abs(), v.double().abs())
    _scale_check("spmm_1gb sddmm vs float64 (plain version in float64 on the card)",
                 C._phys_components[0].cpu().numpy(), ref.cpu().numpy(), scale.cpu().numpy(), TOL_SPARSE)
    del S, C, ref, scale, u, v

    Cm = card_matrix(dev, ht)
    bdata, bcol, brow, bmask = Cm._phys_components
    for k in (1, SPMM_K):
        xk = torch.randn(CARD_N, k, device=dev)
        y, counts = run(f"{CARD_N}^2 ({CARD_BRICKS} bricks): S @ x, k={k}", lambda: Cm @ xk)
        launches[f"card_k{k}"] = counts[0]
        _require(counts == (1, 0) and y.shape == (CARD_N, k), f"S @ x (k={k}) did not run K7 once")
        ref = ks.brick_spmm_plain(bdata.double(), bcol, brow, bmask, xk.double(), CARD_N)
        scale = ks.brick_spmm_plain(bdata.double().abs(), bcol, brow, bmask, xk.double().abs(), CARD_N)
        _scale_check(f"{CARD_N}^2 S @ x (k={k}) vs float64 (plain version on the card)", y.numpy(), ref.cpu().numpy(),
                     scale.cpu().numpy(), TOL_SPARSE)
        del y, ref, scale
    u, v = torch.randn(CARD_N, SDDMM_D, device=dev), torch.randn(CARD_N, SDDMM_D, device=dev)
    Cs, counts = run(f"{CARD_N}^2: sddmm(S, u, v), d={SDDMM_D}", lambda: ht.sparse.sddmm(Cm, u, v))
    launches[f"card_sddmm_d{SDDMM_D}"] = counts[1]
    _require(counts == (0, 1), "sddmm did not run K8 once")
    out = Cs._phys_components[0]
    _require(out.shape == bdata.shape and bool(torch.isfinite(out).all()), "sddmm output shape or values")
    del Cs, out, Cm, bdata, bcol, brow, bmask
    torch.cuda.empty_cache()

    graph = inputs["graph"]
    res, counts = run(f"pagerank_2m: ht.graph.pagerank({PR_N} nodes, {graph.nnz} edges, tol={PR_TOL})",
                      lambda: ht.graph.pagerank(graph, tol=PR_TOL))
    launches["pagerank"] = counts[0]
    ranks = res.ranks.numpy()
    ref = _pagerank_reference(graph)
    err = float(np.abs(ranks - ref).max())
    print(
        f"pagerank_2m: {res.iterations} iterations (heat_tpu on the CPU: {PR_HEAT_TPU_ITERATIONS}), converged "
        f"{res.converged}, delta {res.delta:.3e}; ranks vs float64 scipy power iteration max |err| {err:.3e} "
        f"(tol {TOL_RANKS}), max rel err {float(np.abs(ranks - ref).max() / ref.max()):.3e}", flush=True,
    )
    _require(res.converged and counts == (res.iterations, 0), "PageRank did not run K7 once per iteration")
    _require(err <= TOL_RANKS and abs(float(ranks.sum()) - 1.0) <= 1e-5, "PageRank ranks off")
    launches["pagerank_iterations"] = res.iterations
    return launches


def _library_spmm(S, x):
    """One PyTorch call computing S @ x: the BSR tensor with (8, 128)
    blocks, or, where PyTorch refuses those on CUDA, the CSR tensor of the
    same matrix's nonzeros (built on the card). Returns (name, call)."""
    import torch

    bdata, bcol, brow, _ = S._phys_components
    nreal = S._slab_meta[0][2]
    rowptr = S._brick_rowptr
    m, n = S.mb * 8, S.nb * 128
    _require(S.shape == (m, n), "the library yardstick takes whole bricks")
    warnings.filterwarnings("ignore", message="Sparse (BSR|CSR) tensor support is in beta")
    warnings.filterwarnings("ignore", message="Sparse invariant checks are implicitly disabled")
    try:
        bsr = torch.sparse_bsr_tensor(rowptr, bcol[:nreal], bdata[:nreal], size=(m, n))
        bsr @ x
        return "torch.sparse_bsr_tensor (8, 128) blocks @ x", lambda: bsr @ x
    except RuntimeError as e:
        print(f"library yardstick: torch.sparse_bsr_tensor @ x refused on CUDA ({str(e).splitlines()[0][:120]}); "
              f"using torch.sparse_csr_tensor of the same matrix", flush=True)
    per_row = (rowptr[1:] - rowptr[:-1]).long()
    start = rowptr[:-1].long()
    crow = torch.empty(m + 1, dtype=torch.int64, device=x.device)
    crow[:-1] = (1024 * start[:, None] + 128 * per_row[:, None] * torch.arange(8, device=x.device)).reshape(-1)
    crow[-1] = 1024 * nreal
    values = torch.empty(1024 * nreal, dtype=bdata.dtype, device=x.device)
    cols = torch.empty(1024 * nreal, dtype=torch.int32, device=x.device)
    lane = torch.arange(128, device=x.device)
    for t0 in range(0, nreal, 1 << 16):
        t = torch.arange(t0, min(nreal, t0 + (1 << 16)), device=x.device)
        g = brow[t].long()
        base = crow[:-1].reshape(-1, 8)[g] + 128 * (t - start[g])[:, None]  # (T, 8): each row's slot of brick t
        pos = (base[:, :, None] + lane).reshape(-1)
        values[pos] = bdata[t].reshape(-1)
        cols[pos] = (128 * bcol[t].long()[:, None, None] + lane).expand(-1, 8, -1).reshape(-1).to(torch.int32)
    # the stored zeros of the bricks are no entries of the CSR matrix
    nz = values != 0
    counts = torch.zeros(1024 * nreal + 1, dtype=torch.int64, device=x.device)
    counts[1:] = torch.cumsum(nz, 0)
    csr = torch.sparse_csr_tensor(counts[crow].to(torch.int32), cols[nz], values[nz], size=(m, n))
    return f"torch.sparse_csr_tensor ({int(counts[-1])} nonzeros) @ x", lambda: csr @ x


def _k7_row(name, S, x, launches, err):
    import torch

    from heat_tpu_torch.kernels import spmm as ks

    bdata, bcol, brow, bmask = S._phys_components
    m, n = S.shape
    k = x.shape[1]
    rowptr = S._brick_rowptr
    ms = _median_ms(lambda: ks.brick_spmm(bdata, bcol, brow, bmask, rowptr, x, m), 20)
    plain_ms = _median_ms(lambda: ks.brick_spmm_plain(bdata, bcol, brow, bmask, x, m), 3)
    lib_name, lib_call = _library_spmm(S, x)
    y, y_lib = ks.brick_spmm(bdata, bcol, brow, bmask, rowptr, x, m), lib_call()
    scale = ks.brick_spmm_plain(bdata.abs(), bcol, brow, bmask, x.abs(), m)
    _require(bool(((y - y_lib).abs() <= TOL_SPARSE * scale).all()), f"{lib_name} does not compute S @ x")
    del y, y_lib, scale
    library_ms = _median_ms(lib_call, 10)
    B, nreal = S.slab_bricks, S._slab_meta[0][2]
    nbytes = 4096 * B + 12 * B + 4 * (S.mb + 1) + 4 * k * (n + m)
    bound_ms, bound_by = _bound(nbytes, 2.0 * 1024 * nreal * k)
    print(
        f"{name} (K7, {nreal} bricks, k={k}): {ms:.4f} ms, plain {plain_ms:.4f} ms, {lib_name} {library_ms:.4f} ms, "
        f"bound {bound_ms:.4f} ms ({bound_by}, {nbytes / 1e9:.4f} GB; {nbytes / (ms * 1e-3) / 1e9:.1f} GB/s achieved)",
        flush=True,
    )
    return {
        "name": name, "route": "cuda", "source": "heat_tpu_torch/csrc/spmm.cu",
        "replaces": "heat_tpu/kernels/spmm.py:238", "launches": launches, "max_abs_err": err,
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms,
    }


def _k8_row(name, S, d, gen, launches, errs):
    """K8's Hopper kernel at one of the main path's shapes beside its bound
    (the bricks read and written, u and v once: bytes; the 3xTF32 operation
    bound and the FP32 CUDA-core one beside it), its plain version and
    spmm.cu's kernel on the same inputs (``pr4_ms``), timed in turns.
    ``errs`` is the largest error of each kernel against the plain version."""
    import torch

    from heat_tpu_torch.kernels import spmm as ks

    sdata, bcol, brow, _ = S._phys_components
    m, n = S.shape
    u = torch.randn(m, d, device=sdata.device, generator=gen)
    v = torch.randn(n, d, device=sdata.device, generator=gen)
    _require(ks.sddmm_sm90_serviceable(d, m, (u.data_ptr(), v.data_ptr(), sdata.data_ptr())),
             f"{name} is off K8's Hopper kernel")
    colorder = S._brick_colorder
    ms = _median_ms(lambda: ks.brick_sddmm(sdata, brow, bcol, *colorder, u, v), 10)
    pr4_ms = _median_ms(lambda: ks._brick_sddmm_spmm_cu(sdata, brow, bcol, *colorder, u, v), 10)
    ms_again = _median_ms(lambda: ks.brick_sddmm(sdata, brow, bcol, *colorder, u, v), 10)
    pr4_again = _median_ms(lambda: ks._brick_sddmm_spmm_cu(sdata, brow, bcol, *colorder, u, v), 10)
    plain_ms = _median_ms(lambda: ks.brick_sddmm_plain(sdata, brow, bcol, u, v), 3)
    B = S.slab_bricks
    nbytes = 2 * 4096 * B + 8 * B + 4 * d * (m + n)
    flops = 1024.0 * B * (2 * d + 1)
    t_bytes, tf32_ms, fp32_ms = nbytes / HBM_BYTES_PER_S * 1e3, 3 * flops / TF32_FLOP_PER_S * 1e3, flops / FP32_FLOP_PER_S * 1e3
    bound_ms, bound_by = (t_bytes, "bytes") if t_bytes >= tf32_ms else (tf32_ms, "operations")
    print(
        f"{name} (K8 sddmm_sm90.cu, {B} bricks, d={d}): {ms:.4f} ms [{ms_again:.4f}], spmm.cu's kernel (pr4_ms) "
        f"{pr4_ms:.4f} ms [{pr4_again:.4f}], plain {plain_ms:.4f} ms, library — (none), bound {bound_ms:.4f} ms "
        f"({bound_by}; {nbytes / 1e9:.4f} GB, {flops / 1e9:.1f} GFLOP: 3xTF32 {tf32_ms:.4f} ms, FP32 CUDA cores "
        f"{fp32_ms:.4f} ms; {nbytes / (ms * 1e-3) / 1e9:.1f} GB/s achieved, {bound_ms / ms:.1%} of the bound)",
        flush=True,
    )
    return {
        "name": name, "route": "cuda", "source": "heat_tpu_torch/csrc/sddmm_sm90.cu",
        "replaces": "heat_tpu/kernels/spmm.py:265", "launches": launches, "max_abs_err": errs[0],
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
        "pr4_ms": pr4_ms, "pr4_err": errs[1], "bound_3xtf32_ms": tf32_ms, "bound_fp32_ms": fp32_ms,
    }


def sparse_timings(dev, inputs: dict, launches: dict, errs: dict) -> list:
    """K7 and K8 at the main-path shapes beside bound, plain version and
    library call; S @ x end to end; PageRank split into the host build and
    the fixpoint. Returns the kernel rows."""
    import numpy as np
    import torch

    import heat_tpu_torch as ht
    from heat_tpu_torch.graph.pagerank import _adjacency_to_scipy, _fixpoint, _transition

    gen = torch.Generator(device=dev)
    gen.manual_seed(13)
    rows = []
    S = ht.sparse.sparse_dbcsr_matrix(inputs["bsr"], split=0)
    x = torch.randn(SPMM_N, SPMM_K, device=dev, generator=gen)
    rows.append(_k7_row("brick_spmm_1gb", S, x, launches["spmm_1gb"], errs[f"spmm_1gb_k{SPMM_K}"]))
    rows.append(_k8_row("brick_sddmm_1gb", S, SDDMM_D, gen, launches["sddmm_1gb"], errs[f"sddmm_1gb_d{SDDMM_D}"]))
    e2e = _median_ms(lambda: S @ x, 20)
    print(f"spmm_1gb: S @ x {e2e:.4f} ms end to end (median of 20, CUDA events)", flush=True)
    del S

    C = card_matrix(dev, ht)
    for k in (SPMM_K, 1):
        xk = torch.randn(CARD_N, k, device=dev, generator=gen)
        rows.append(_k7_row(f"brick_spmm_card_k{k}", C, xk, launches[f"card_k{k}"], errs[f"card_k{k}"]))
    rows.append(_k8_row("brick_sddmm_card", C, SDDMM_D, gen, launches[f"card_sddmm_d{SDDMM_D}"],
                        errs[f"card_sddmm_d{SDDMM_D}"]))
    xk = torch.randn(CARD_N, SPMM_K, device=dev, generator=gen)
    e2e = _median_ms(lambda: C @ xk, 10)
    print(f"{CARD_N}^2: S @ x (k={SPMM_K}) {e2e:.4f} ms end to end (median of 10, CUDA events)", flush=True)
    del C, xk
    torch.cuda.empty_cache()

    graph = inputs["graph"]
    steps = {}
    for rep in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        csr = _adjacency_to_scipy(graph)
        t1 = time.perf_counter()
        M_host, dangling, _ = _transition(csr, np.float32)
        t2 = time.perf_counter()
        M = ht.sparse.sparse_dbcsr_matrix(M_host, dtype=ht.float32, split=0)
        dang = torch.from_numpy(dangling).to(dev)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        r, iters, _ = _fixpoint(M, dang, 0.85, PR_TOL, 200)
        torch.cuda.synchronize()
        t4 = time.perf_counter()
        for key, sec in (("adjacency", t1 - t0), ("transition", t2 - t1), ("dbcsr", t3 - t2), ("fixpoint", t4 - t3)):
            steps.setdefault(key, []).append(sec * 1e3)
    med = {key: statistics.median(v) for key, v in steps.items()}
    build = med["adjacency"] + med["transition"] + med["dbcsr"]
    whole = _median_ms(lambda: ht.graph.pagerank(graph, tol=PR_TOL), 3)
    print(
        f"pagerank_2m ({iters} iterations): whole call {whole:.1f} ms (CUDA events, median of 3); host build "
        f"{build:.1f} ms = adjacency to scipy {med['adjacency']:.1f} + transition {med['transition']:.1f} + "
        f"sparse_dbcsr_matrix (tobsr, landing) {med['dbcsr']:.1f}; fixpoint {med['fixpoint']:.2f} ms = "
        f"{med['fixpoint'] / iters:.3f} ms per iteration (host clock with sync, median of 3)", flush=True,
    )
    rows.append(_k7_row("brick_spmm_pagerank", M, r[:, None].contiguous(), launches["pagerank"], errs["pagerank_k1"]))
    profile_breakdown("pagerank_2m fixpoint", lambda: _fixpoint(M, dang, 0.85, PR_TOL, 200))
    return rows


# --------------------------------------------------------------------- #
# attention: K9 under ht.nn                                             #
# --------------------------------------------------------------------- #
def _qkv(dev, gen, bh, s_q, s_kv, d, d_v, dtype, mult: float = 1.0):
    import torch

    q = (torch.randn(bh + (s_q, d), device=dev, generator=gen) * mult).to(dtype)
    k = torch.randn(bh + (s_kv, d), device=dev, generator=gen).to(dtype)
    v = torch.randn(bh + (s_kv, d_v), device=dev, generator=gen).to(dtype)
    return q, k, v


def _o_limit(ka, q, k, v, causal, ro):
    """The elementwise limit of |o - ro| for K9's o (TOL_ATT_*): float32
    1e-5 max|v| of each (batch, head) slice; bfloat16 3 · 2^-8 (|ro| + A),
    A the float32 attention of |v| on the same q and k."""
    import torch

    if q.dtype != torch.bfloat16:
        return TOL_ATT_F32 * v.float().abs().amax(dim=(-2, -1), keepdim=True)
    a, _ = ka.flash_attention_plain(q.float(), k.float(), v.float().abs(), causal)
    return TOL_ATT_BF16_O * 2.0**-8 * (ro.float().abs() + a)


def _o_errors(ka, o, ro, q, k, v, causal):
    """(max |o - ro| / its limit, max |o - ro|); the first must be <= 1."""
    if not o.numel():
        return 0.0, 0.0
    diff = (o.float() - ro.float()).abs()
    return float((diff / _o_limit(ka, q, k, v, causal, ro).clamp_min(1e-30)).max()), float(diff.max())


def _o_tol_text(dtype) -> str:
    import torch

    return f"{TOL_ATT_BF16_O:g} · 2^-8 (|ro| + A)" if dtype == torch.bfloat16 else f"{TOL_ATT_F32:g} max|v|"


def _att_errors(ka, o, lse, ro, rl, q, k, v, causal):
    """o's error as a share of its limit, max |Δo|, and max |Δlse| / (1 +
    |lse|), the -inf rows required to agree exactly."""
    import torch

    eo, abs_o = _o_errors(ka, o, ro, q, k, v, causal)
    dead, rdead = torch.isneginf(lse), torch.isneginf(rl)
    _require(torch.equal(dead, rdead), "K9 and its plain version disagree on the rows without keys")
    live = ~dead
    el = float(((lse - rl).abs() / (1 + rl.abs()))[live].max()) if bool(live.any()) else 0.0
    return eo, abs_o, el


def _lse_tol(dtype) -> float:
    import torch

    return TOL_ATT_BF16_LSE if dtype == torch.bfloat16 else TOL_ATT_F32


def _hopper_shape(q, k, v) -> bool:
    """Whether K9 should take its Hopper path (attention_sm90.cu) on these
    operands: bfloat16 at D = D_v in {64, 128, 256} or float32 at D = D_v
    = 64, every base and every stride but the last dim's on 16 bytes."""
    import torch

    es = q.element_size()
    aligned = all(t.data_ptr() % 16 == 0 and all(st * es % 16 == 0 for st in t.stride()[:-1]) for t in (q, k, v))
    dims = {torch.bfloat16: (64, 128, 256), torch.float32: (64,)}.get(q.dtype, ())
    return q.shape[-1] == v.shape[-1] and q.shape[-1] in dims and aligned


def _old_kernel(dtype) -> str:
    """attention.cu's kernel for ``dtype``."""
    import torch

    return "the mma.sync kernel" if dtype == torch.bfloat16 else "the FP32 kernel"


def _k9_case(ka, label, q, k, v, causal):
    """K9 against its plain version and against itself on a rerun, on the
    route its predicate picks. On the Hopper path attention.cu's kernel
    runs on the same inputs too: held against the plain version, and the
    Hopper path against it, each under the same limits. In float32 the
    library call's own error against the plain version is printed beside
    K9's. Returns the largest |Δo| against the plain version of the
    route's kernel and of attention.cu's kernel (None off the Hopper
    path)."""
    import torch

    launches, launches_sm90 = ka.ATTENTION_LAUNCHES, ka.ATTENTION_SM90_LAUNCHES
    o, lse = ka.flash_attention(q, k, v, causal)
    torch.cuda.synchronize()
    hopper = _hopper_shape(q, k, v)
    _require(ka.ATTENTION_LAUNCHES == launches + 1, f"K9 ({label}) did not launch once")
    _require(ka.ATTENTION_SM90_LAUNCHES == launches_sm90 + int(hopper),
             f"K9 ({label}) {'did not take' if hopper else 'took'} the Hopper path")
    ro, rl = ka.flash_attention_plain(q, k, v, causal)
    eo, abs_o, el = _att_errors(ka, o, lse, ro, rl, q, k, v, causal)
    tol_l = _lse_tol(q.dtype)
    o2, l2 = ka.flash_attention(q, k, v, causal)
    rerun = bool(torch.equal(o, o2) and torch.equal(lse, l2))
    route = "attention_sm90" if hopper else "attention"
    vs_old, ok_old, abs_m = "", True, None
    if hopper:
        old = _old_kernel(q.dtype)
        mo, ml = ka._flash_attention_attention_cu(q, k, v, causal)
        em, abs_m, elm = _att_errors(ka, mo, ml, ro, rl, q, k, v, causal)
        ex, abs_x, elx = _att_errors(ka, o, lse, mo, ml, q, k, v, causal)
        ok_old = em <= 1 and elm <= tol_l and ex <= 1 and elx <= tol_l
        vs_old = (f"; {old} against the plain version: max |Δo| {abs_m:.3e}, {em:.3f} of the limit, "
                  f"lse err {elm:.3e}; the Hopper path against {old}: max |Δo| {abs_x:.3e}, "
                  f"{ex:.3f} of the limit, lse err {elx:.3e}")
    if q.dtype == torch.float32:
        # on copies: the library faults on views whose bases lie off 16 bytes
        scale = 1.0 / math.sqrt(q.shape[-1])
        qc, kc, vc = (t.contiguous() for t in (q, k, v))
        lo = torch.nn.functional.scaled_dot_product_attention(qc, kc, vc, is_causal=causal, scale=scale)
        del qc, kc, vc
        el_lib, abs_lib = _o_errors(ka, lo, ro, q, k, v, causal)
        vs_old += (f"; scaled_dot_product_attention against the plain version: max |Δo| {abs_lib:.3e}, "
                   f"{el_lib:.3f} of the limit")
        del lo
    print(
        f"K9 {route} ({label}, {tuple(q.shape)} x {tuple(v.shape)}, {str(q.dtype)[6:]}, causal={causal}): max |Δo| "
        f"{abs_o:.3e}, {eo:.3f} of its limit {_o_tol_text(q.dtype)}; lse err {el:.3e} of 1+|lse| (tol {tol_l}); "
        f"rerun identical {rerun}{vs_old}",
        flush=True,
    )
    _require(eo <= 1 and el <= tol_l and rerun and ok_old,
             f"K9 disagrees with its plain version, attention.cu's kernel or itself ({label})")
    return abs_o, abs_m


def check_attention(dev) -> dict:
    """K9 against its plain version at the main path's shapes and at ragged
    and boundary ones; the lse residual through the ring's combine; a
    strided read of a packed projection. Returns the main shapes' errors."""
    import torch

    from heat_tpu_torch.kernels import attention as ka

    gen = torch.Generator(device=dev)
    gen.manual_seed(21)
    f32, bf16 = torch.float32, torch.bfloat16
    errs = {}
    b, h, s, d = RA
    for dtype, causal, key in ((f32, True, "ra_f32_causal"), (f32, False, "ra_f32"), (bf16, True, "ra_bf16_causal")):
        errs[key] = _k9_case(ka, key, *_qkv(dev, gen, (b, h), s, s, d, d, dtype), causal)
    b, h, s, d = RAB
    errs["rab_bf16_causal"] = _k9_case(ka, "rab_bf16_causal", *_qkv(dev, gen, (b, h), s, s, d, d, bf16), True)
    b, h, s, d = SDPA_D256
    errs["bf16_d256"] = _k9_case(ka, "bf16_d256", *_qkv(dev, gen, (b, h), s, s, d, d, bf16), True)
    # the Hopper path at its ragged and boundary shapes, at every head dim
    # and dtype it takes (RA, RAB, heads of 256 and the cases below at
    # D = 64 take it too)
    for dtype, d in ((bf16, 64), (bf16, 128), (bf16, 256), (f32, 64)):
        tag = f"D = {d}" if dtype == bf16 else f"float32, D = {d}"
        for causal in (True, False):
            _k9_case(ka, f"ragged 1000, {tag}", *_qkv(dev, gen, (2, 3), 1000, 1000, d, d, dtype), causal)
        _k9_case(ka, f"causal, 300 x 1003, {tag}", *_qkv(dev, gen, (4,), 300, 1003, d, d, dtype), True)
        _k9_case(ka, f"S_q = 1, {tag}", *_qkv(dev, gen, (4, 8), 1, 4096, d, d, dtype), False)
        _k9_case(ka, f"scores x10, {tag}", *_qkv(dev, gen, (2, 8), 2048, 2048, d, d, dtype, mult=10.0), True)
        # the packed projection's heads, read in place by TMA: the bits of copies
        qkv = torch.randn(2, 300, 3, 4, d, device=dev, generator=gen).to(dtype)
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
        _k9_case(ka, f"packed heads, {tag}", q, k, v, True)
        o, lse = ka.flash_attention(q, k, v, True)
        oc, lc = ka.flash_attention(q.contiguous(), k.contiguous(), v.contiguous(), True)
        _require(torch.equal(o, oc) and torch.equal(lse, lc),
                 f"K9's Hopper path on strided views differs from it on copies ({tag})")
    # bfloat16 shapes the Hopper path refuses, on the mma.sync kernel, causal:
    # its D_v <= 64 form (D = 48) and its 64 < D_v <= 128 form (D = 96, and
    # D = 128 read from views that start 2 bytes off 16)
    for d in (48, 96):
        _k9_case(ka, f"mma.sync, ragged causal, D = {d}", *_qkv(dev, gen, (2, 3), 1003, 1003, d, d, bf16), True)
        _k9_case(ka, f"mma.sync, causal, 300 x 1003, D = {d}", *_qkv(dev, gen, (4,), 300, 1003, d, d, bf16), True)
    q, k, v = (t[..., 1:129] for t in _qkv(dev, gen, (2, 3), 1003, 1003, 136, 136, bf16))
    _k9_case(ka, "mma.sync, causal, misaligned views, D = 128", q, k, v, True)
    # float32 shapes the Hopper path refuses, on the FP32 kernel, causal:
    # D = 128 (its 64 < D_v <= 128 form) and D = 64 read from views that
    # start 4 bytes off 16 (its D_v <= 64 form)
    _k9_case(ka, "FP32 kernel, ragged causal, D = 128", *_qkv(dev, gen, (2, 3), 1003, 1003, 128, 128, f32), True)
    q, k, v = (t[..., 1:65] for t in _qkv(dev, gen, (2, 3), 1003, 1003, 72, 72, f32))
    _k9_case(ka, "FP32 kernel, causal, misaligned views, D = 64", q, k, v, True)
    for dtype in (f32, bf16):
        _k9_case(ka, "ragged", *_qkv(dev, gen, (6,), 1000, 777, 72, 40, dtype), False)
        _k9_case(ka, "ragged causal", *_qkv(dev, gen, (2, 3), 1003, 1003, 64, 64, dtype), True)
        _k9_case(ka, "causal, S_q < S_kv", *_qkv(dev, gen, (4,), 300, 1003, 64, 64, dtype), True)
        _k9_case(ka, "D = 8", *_qkv(dev, gen, (2, 4), 64, 64, 8, 8, dtype), True)
        _k9_case(ka, "D = 256", *_qkv(dev, gen, (2, 2), 1000, 1000, 256, 256, dtype), True)
        _k9_case(ka, "D = 256, D_v = 64", *_qkv(dev, gen, (2,), 500, 700, 256, 64, dtype), False)
        _k9_case(ka, "S_q = 1", *_qkv(dev, gen, (4, 8), 1, 4096, 64, 64, dtype), False)
        _k9_case(ka, "scores x10", *_qkv(dev, gen, (2, 8), 2048, 2048, 64, 64, dtype, mult=10.0), True)
        # S_kv = 0: zeros and -inf, no launch
        q, k, v = _qkv(dev, gen, (2,), 5, 0, 16, 8, dtype)
        launches = ka.ATTENTION_LAUNCHES
        o, lse = ka.flash_attention(q, k, v, True)
        _require(ka.ATTENTION_LAUNCHES == launches and not o.any() and bool(torch.isneginf(lse).all()),
                 "S_kv = 0 launched or gave more than zeros and -inf")

        # the lse residual: K9 on the two halves of K/V, combined as the ring
        # combines its steps, against K9 on the whole
        b, h, s, d = RA
        q, k, v = _qkv(dev, gen, (b, h), s, s, d, d, dtype)
        half = s // 2
        o1, l1 = ka.flash_attention(q, k[..., :half, :], v[..., :half, :])
        o2, l2 = ka.flash_attention(q, k[..., half:, :], v[..., half:, :])
        o, lse = ka.combine_partials(o1, l1, o2, l2)
        ro, rl = ka.flash_attention(q, k, v)
        eo, abs_o, el = _att_errors(ka, o, lse, ro, rl, q, k, v, False)
        tol_l = _lse_tol(dtype)
        print(f"K9 lse identity ({str(dtype)[6:]}, two halves of {s} keys combined vs whole): max |Δo| "
              f"{abs_o:.3e}, {eo:.3f} of its limit {_o_tol_text(dtype)}; lse err {el:.3e} (tol {tol_l})", flush=True)
        _require(eo <= 1 and el <= tol_l, "K9's lse residual does not combine into the whole")

        # the heads of a packed projection, read in place: the same bits as
        # K9 on contiguous copies
        qkv = torch.randn(2, 300, 3, 4, 32, device=dev, generator=gen).to(dtype)
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
        o, lse = ka.flash_attention(q, k, v, True)
        oc, lc = ka.flash_attention(q.contiguous(), k.contiguous(), v.contiguous(), True)
        _require(torch.equal(o, oc) and torch.equal(lse, lc), "K9 on strided views differs from K9 on copies")

    # MultiheadAttention's strided heads at MHA-1024 (RAB's attention shape)
    import heat_tpu_torch as ht

    mha, x = _mha_inputs(dev, ht)
    with torch.inference_mode():
        errs["mha_1024_heads"] = _k9_case(ka, "mha_1024 heads", *_mha_heads(mha, x), True)
    del mha, x

    # under autograd the public route launches K9 and differentiates the
    # plain version in the backward
    from heat_tpu_torch.nn.attention import _single_device_attention

    q, k, v = (t.requires_grad_() for t in _qkv(dev, gen, (2, 4), 300, 300, 32, 32, f32))
    launches = ka.ATTENTION_LAUNCHES
    grads = torch.autograd.grad(_single_device_attention(q, k, v, True).square().sum(), (q, k, v))
    ref = torch.autograd.grad(ka.flash_attention_plain(q, k, v, True)[0].square().sum(), (q, k, v))
    gerr = max(float((g - r).abs().max() / r.abs().max()) for g, r in zip(grads, ref))
    print(f"K9 under autograd: {ka.ATTENTION_LAUNCHES - launches} launch, gradients within {gerr:.2e} of the "
          f"plain version's (relative to their largest element; tol {TOL_ATT_F32})", flush=True)
    _require(ka.ATTENTION_LAUNCHES == launches + 1 and gerr <= TOL_ATT_F32, "K9's autograd route")
    del q, k, v, o, lse, grads, ref
    torch.cuda.empty_cache()
    return errs


def attention_path(dev):
    """The attention path through its public entry points at full size;
    returns K9's launch count of each call and the largest |Δo| of K9 on
    MultiheadAttention's heads."""
    import torch

    import heat_tpu_torch as ht
    from heat_tpu_torch.kernels import attention as ka

    launches, launches_sm90, errs = {}, {}, {}

    def run(label: str, call, hopper: bool):
        ka.ATTENTION_LAUNCHES = ka.ATTENTION_SM90_LAUNCHES = 0
        out = call()
        torch.cuda.synchronize()
        launches[label], launches_sm90[label] = ka.ATTENTION_LAUNCHES, ka.ATTENTION_SM90_LAUNCHES
        _require(launches[label] == 1, f"{label} launched K9 {launches[label]} times, not once")
        _require(launches_sm90[label] == int(hopper),
                 f"{label} launched K9's Hopper path {launches_sm90[label]} times, not {int(hopper)}")
        return out

    def check(label, out, q, k, v, causal):
        ro, _ = ka.flash_attention_plain(q, k, v, causal)
        _require(out.shape == ro.shape and out.dtype == ro.dtype and bool(torch.isfinite(out).all()),
                 f"{label}: shape, dtype or values")
        err, abs_o = _o_errors(ka, out, ro, q, k, v, causal)
        print(f"{label}: {tuple(out.shape)} {str(out.dtype)[6:]}, K9 launches {launches[label]} (Hopper path "
              f"{launches_sm90[label]}), max |Δo| {abs_o:.3e} against the plain route, {err:.3f} of its limit "
              f"{_o_tol_text(q.dtype)}", flush=True)
        _require(err <= 1, f"{label} disagrees with the plain route")
        errs[label] = abs_o
        return abs_o

    ht.random.seed(5)
    for (b, h, s, d), dtype, label in ((RA, ht.float32, "ring_attention_ra_f32"),
                                       (RA, ht.bfloat16, "ring_attention_ra_bf16"),
                                       (RAB, ht.bfloat16, "ring_attention_rab_bf16")):
        q, k, v = (ht.random.randn(b, h, s, d, dtype=dtype, split=2) for _ in range(3))
        _require(q.larray.device == dev and q.split == 2, "q is not a split-2 array on the card")
        out = run(label, lambda: ht.nn.ring_attention(q, k, v, causal=True), True)
        _require(out.split == 2 and out.dtype is dtype and out.gshape == (b, h, s, d), f"{label}: result metadata")
        check(label, out.larray, q.larray, k.larray, v.larray, True)
    del q, k, v, out

    gen = torch.Generator(device=dev)
    gen.manual_seed(22)
    b, h, s, d = RA
    q, k, v = _qkv(dev, gen, (b, h), s, s, d, d, torch.float32)
    out = run("sdpa_ra_f32", lambda: ht.nn.functional.scaled_dot_product_attention(q, k, v), True)
    check("sdpa_ra_f32", out, q, k, v, False)
    # bfloat16 heads of 256, the widest K9 takes
    q, k, v = _qkv(dev, gen, SDPA_D256[:2], SDPA_D256[2], SDPA_D256[2], SDPA_D256[3], SDPA_D256[3], torch.bfloat16)
    out = run("sdpa_bf16_d256", lambda: ht.nn.functional.scaled_dot_product_attention(q, k, v, is_causal=True),
              True)
    check("sdpa_bf16_d256", out, q, k, v, True)
    del q, k, v, out

    mha, x = _mha_inputs(dev, ht)
    with torch.inference_mode():
        out = run("mha_1024", lambda: mha(x), True)
        # K9 on the module's strided heads of its packed projection, held
        # against the plain version elementwise; then the module's output
        # against that o through out_proj, the same ops on the same inputs
        # (at most one bf16 rounding apart, of the product and of the sum)
        q, k, v = _mha_heads(mha, x)
        o, _ = ka.flash_attention(q, k, v, True)
        check("mha_1024", o, q, k, v, True)
        y = o.transpose(1, 2).reshape(x.shape) @ mha.out_proj
        ref = y + mha.out_bias
        bound = 2.0**-7 * (y.float().abs() + ref.float().abs())
        ok = bool(((out.float() - ref.float()).abs() <= bound).all()) and bool(torch.isfinite(out).all())
    print(f"MultiheadAttention({MHA_E}, {MHA_H}, causal, bf16) on {tuple(x.shape)}: {tuple(out.shape)}, "
          f"K9 launches {launches['mha_1024']} (Hopper path {launches_sm90['mha_1024']}), equal to K9's o through "
          f"out_proj within one bf16 rounding: {ok}", flush=True)
    _require(ok and out.shape == x.shape, "MultiheadAttention is not K9's attention through its projections")
    del out, ref, y, o, q, k, v
    torch.cuda.empty_cache()
    return launches, launches_sm90, errs


def _mha_inputs(dev, ht):
    import torch

    gen = torch.Generator(device=dev)
    gen.manual_seed(23)
    mha = ht.nn.MultiheadAttention(MHA_E, MHA_H, causal=True, dtype=ht.bfloat16, generator=gen)
    with torch.no_grad():  # non-zero biases, so that they are exercised
        mha.in_bias.uniform_(-0.1, 0.1, generator=gen)
        mha.out_bias.uniform_(-0.1, 0.1, generator=gen)
    x = torch.randn(1, RAB[2], MHA_E, device=dev, generator=gen).to(torch.bfloat16)
    return mha, x


def _mha_heads(mha, x):
    """q, k and v of ``MultiheadAttention.forward``: (B, H, S, D) strided
    views of its packed projection."""
    b, s, e = x.shape
    qkv = (x @ mha.in_proj + mha.in_bias).reshape(b, s, 3, mha.num_heads, mha.head_dim)
    return tuple(qkv[:, :, i].transpose(1, 2) for i in range(3))


def _k9_row(name, q, k, v, causal, launches: int, launches_sm90: int, errs: tuple):
    """K9 at one of the main path's shapes, on the kernel its predicate
    picks there, beside its bound, its plain version and the library call
    on the same inputs (whose agreement is checked first). ``launches`` and
    ``launches_sm90`` are K9's launches and the Hopper path's in the main
    path's call at this shape; ``errs`` is the largest |Δo| against the
    plain version of that kernel and of attention.cu's kernel (None off the
    Hopper path). On the Hopper path the row also carries attention.cu's
    kernel's time on the same inputs (``attention_cu_ms``: mma.sync for
    bf16, the FP32 kernel for float32) and its error
    (``attention_cu_err``). A float32 row's bound is that of 3xTF32 on the
    tensor cores (``bound_fp32_ms``: FP32 on the CUDA cores)."""
    import torch

    from heat_tpu_torch.kernels import attention as ka

    hopper = _hopper_shape(q, k, v)
    source = "heat_tpu_torch/csrc/attention_sm90.cu" if hopper else "heat_tpu_torch/csrc/attention.cu"
    *lead, s_q, d = q.shape
    s_kv, d_v = k.shape[-2], v.shape[-1]
    bh = math.prod(lead)
    scale = 1.0 / math.sqrt(d)
    ms = _median_ms(lambda: ka.flash_attention(q, k, v, causal), 10)
    plain_ms = _median_ms(lambda: ka.flash_attention_plain(q, k, v, causal), 3)
    lib = lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v, is_causal=causal, scale=scale)
    o, _ = ka.flash_attention(q, k, v, causal)
    # both against the exact result: twice K9's float32 limit; in bfloat16
    # each is within 2^-8 (|o| + A), inside the limit with o for ro
    lib_err, lib_abs = _o_errors(ka, lib(), o, q, k, v, causal)
    lim = lib_err / 2 if q.dtype == torch.float32 else lib_err
    _require(lim <= 1, f"scaled_dot_product_attention does not compute K9's function ({name}: {lib_abs:.3e})")
    del o
    library_ms = _median_ms(lib, 10)
    pairs = sum(min(i + 1, s_kv) for i in range(s_q)) if causal else s_q * s_kv
    flops = 2.0 * (d + d_v) * bh * pairs
    es = q.element_size()
    nbytes = es * bh * (s_q * d + s_kv * (d + d_v) + s_q * d_v) + 4 * bh * s_q
    bf16 = q.dtype == torch.bfloat16
    peak = BF16_FLOP_PER_S if bf16 else TF32_FLOP_PER_S / 3  # float32 as 3xTF32
    t_ops, t_bytes = flops / peak * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    bound_ms, bound_by = (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
    fp32_ms = max(flops / FP32_FLOP_PER_S * 1e3, t_bytes)
    extra = "" if bf16 else f"; FP32 on the CUDA cores {fp32_ms:.4f} ms"
    if hopper:
        old_ms = _median_ms(lambda: ka._flash_attention_attention_cu(q, k, v, causal), 10)
        extra += f"; {_old_kernel(q.dtype)} of attention.cu {old_ms:.4f} ms ({old_ms / ms:.2f}x)"
    print(
        f"{name} (K9 {source.rsplit('/', 1)[-1]}, {tuple(q.shape)}, {str(q.dtype)[6:]}, causal={causal}): "
        f"{ms:.4f} ms, plain {plain_ms:.4f} ms, scaled_dot_product_attention {library_ms:.4f} ms (agrees to "
        f"{lib_abs:.2e}, {lim:.3f} of its limit), bound {bound_ms:.4f} ms ({bound_by}: {flops / 1e9:.1f} GFLOP at "
        f"{peak / 1e12:.0f} TFLOP/s{'' if bf16 else ' (3xTF32)'}, {nbytes / 1e6:.1f} MB; "
        f"{flops / (ms * 1e-3) / 1e12:.1f} TFLOP/s achieved, {bound_ms / ms:.1%} of the bound){extra}", flush=True,
    )
    row = {
        "name": name, "route": "cuda", "source": source, "replaces": "heat_tpu/nn/attention.py:637, :537",
        "launches": launches_sm90 if hopper else launches - launches_sm90, "max_abs_err": errs[0],
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms,
    }
    if not bf16:
        row.update(bound_fp32_ms=fp32_ms)
    if hopper:
        row.update(attention_cu_ms=old_ms, attention_cu_err=errs[1])
    return row


def attention_timings(dev, launches: dict, launches_sm90: dict, errs: dict, path_errs: dict) -> list:
    """K9 at the main path's shapes beside bound, plain version and
    library call, the Hopper path also beside attention.cu's kernel; the
    public calls end to end; a profile of one MultiheadAttention forward.
    Returns the kernel rows."""
    import torch

    import heat_tpu_torch as ht

    gen = torch.Generator(device=dev)
    gen.manual_seed(24)
    rows = []

    def row(key, path, q, k, v, causal, errs_of):
        rows.append(_k9_row(f"flash_attention_{key}", q, k, v, causal, launches[path], launches_sm90[path], errs_of))

    b, h, s, d = RA
    for dtype, causal, key, path in ((torch.float32, True, "ra_f32_causal", "ring_attention_ra_f32"),
                                     (torch.float32, False, "ra_f32", "sdpa_ra_f32"),
                                     (torch.bfloat16, True, "ra_bf16_causal", "ring_attention_ra_bf16")):
        row(key, path, *_qkv(dev, gen, (b, h), s, s, d, d, dtype), causal, errs[key])
    b, h, s, d = RAB
    row("rab_bf16_causal", "ring_attention_rab_bf16", *_qkv(dev, gen, (b, h), s, s, d, d, torch.bfloat16), True,
        errs["rab_bf16_causal"])
    b, h, s, d = SDPA_D256
    row("bf16_d256", "sdpa_bf16_d256", *_qkv(dev, gen, (b, h), s, s, d, d, torch.bfloat16), True,
        (path_errs["sdpa_bf16_d256"], errs["bf16_d256"][1]))

    ht.random.seed(6)
    for (b, h, s, d), dtype, label in ((RA, ht.float32, "RA f32"), (RA, ht.bfloat16, "RA bf16"),
                                       (RAB, ht.bfloat16, "RAB bf16")):
        q, k, v = (ht.random.randn(b, h, s, d, dtype=dtype, split=2) for _ in range(3))
        call_ms = _median_ms(lambda: ht.nn.ring_attention(q, k, v, causal=True), 10)
        print(f"ring_attention {label} causal {tuple(q.shape)}: {call_ms:.4f} ms a call (CUDA events, median of 10)",
              flush=True)
    b, h, s, d = SDPA_D256
    q, k, v = _qkv(dev, gen, (b, h), s, s, d, d, torch.bfloat16)
    call_ms = _median_ms(lambda: ht.nn.functional.scaled_dot_product_attention(q, k, v, is_causal=True), 10)
    print(f"scaled_dot_product_attention bf16 causal {tuple(q.shape)}: {call_ms:.4f} ms a call (CUDA events, median "
          f"of 10)", flush=True)
    del q, k, v

    mha, x = _mha_inputs(dev, ht)
    with torch.inference_mode():
        fwd_ms = _median_ms(lambda: mha(x), 10)
        row("mha_1024", "mha_1024", *_mha_heads(mha, x), True, (path_errs["mha_1024"], errs["mha_1024_heads"][1]))
        proj_flops = 2.0 * RAB[2] * MHA_E * 4 * MHA_E
        print(f"MultiheadAttention({MHA_E}, {MHA_H}, causal, bf16) forward on {tuple(x.shape)}: {fwd_ms:.4f} ms "
              f"(CUDA events, median of 10); projections {proj_flops / 1e9:.1f} GFLOP, bound "
              f"{proj_flops / BF16_FLOP_PER_S * 1e3:.4f} ms", flush=True)
        profile_breakdown(f"MultiheadAttention({MHA_E}, {MHA_H}) forward {tuple(x.shape)} bf16", lambda: mha(x))
    return rows


# ---------------------------------------------------------------------------
# relayout: K5 (pack) and K6 (unpack) of the packed pivot
# ---------------------------------------------------------------------------
def _raw(t):
    """The raw words of ``t`` as an integer tensor: equality of these is
    equality bit for bit (NaN payloads and -0.0 included)."""
    import torch

    words = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64, 16: torch.int64}
    return t.contiguous().reshape(-1).view(words[t.element_size()])


def _random_of(gen, n: int, dtype, dev):
    """n elements of ``dtype`` with random raw words (random 0/1 for bool)."""
    import torch

    if dtype == torch.bool:
        return torch.randint(0, 2, (n,), generator=gen, device=dev, dtype=torch.uint8).bool()
    es = torch.empty(0, dtype=dtype).element_size()
    return torch.randint(0, 256, (n * es,), generator=gen, device=dev, dtype=torch.uint8).view(dtype)


def _k56_case(kr, label: str, x, rows: int, c_in: int, c_out: int, p: int) -> None:
    """K5 on x, then K6 on K5's output, each against its plain version bit
    for bit, each launching once (none when there are no rows)."""
    import torch

    before = kr.PACK_LAUNCHES, kr.UNPACK_LAUNCHES
    packed = kr.pack_rows(x, rows, c_in, c_out, p)
    back = kr.unpack_rows(packed, rows, c_out, c_in, p)
    torch.cuda.synchronize()
    want = kr.pack_rows_plain(x, rows, c_in, c_out, p)
    ok = torch.equal(_raw(packed), _raw(want)) and torch.equal(_raw(back), _raw(kr.unpack_rows_plain(want, rows, c_out, c_in, p)))
    ok = ok and torch.equal(_raw(back), _raw(x))
    launched = int(rows > 0)
    counted = (kr.PACK_LAUNCHES - before[0], kr.UNPACK_LAUNCHES - before[1]) == (launched, launched)
    print(f"K5/K6 {label} ({rows} rows, {c_in} <-> {c_out} over p={p}, {str(x.dtype)[6:]}): "
          f"{'equal bit for bit' if ok else 'DIFFER'}, launches {'as expected' if counted else 'WRONG'}", flush=True)
    _require(ok, f"K5/K6 differ from their plain versions at {label}")
    _require(counted, f"K5/K6 launch counts at {label}")


def check_relayout(dev) -> dict:
    """K5 and K6 against their plain versions bit for bit at the executor's
    per-rank shapes (the 1 GB move over 8 ranks, (2048, 64) <-> (8192, 16)
    over 4), ragged and degenerate shapes, a 64-bit index case, six dtypes
    and special float32 bits; returns the main shape's errors."""
    import torch

    from heat_tpu_torch.kernels import relayout as kr

    gen = torch.Generator(device=dev)
    gen.manual_seed(30)
    rows, c_in, c_out, p = RELAYOUT_P8
    x = torch.randn(rows * c_in, device=dev, generator=gen)
    _k56_case(kr, "the 1 GB move's per-rank shape at p = 8", x, rows, c_in, c_out, p)
    packed = kr.pack_rows(x, rows, c_in, c_out, p)
    errs = {"relayout_pack": float((packed - kr.pack_rows_plain(x, rows, c_in, c_out, p)).abs().max())}
    errs["relayout_unpack"] = float((kr.unpack_rows(packed, rows, c_out, c_in, p) - x).abs().max())
    del x, packed
    for shape in ((2048, 16, 16, 4), (512, 64, 64, 4)):
        _k56_case(kr, "(2048, 64) <-> (8192, 16) per rank at p = 4", torch.randn(shape[0] * shape[1], device=dev,
                  generator=gen), *shape)
    for dtype in (torch.bool, torch.int8, torch.bfloat16, torch.float32, torch.float64, torch.complex64):
        for shape in ((1003, 777, 784, 8), (7, 13, 15, 5), (1, 25, 32, 8), (5, 7, 7, 1), (6, 1, 8, 8), (0, 25, 32, 8)):
            _k56_case(kr, "ragged/degenerate", _random_of(gen, shape[0] * shape[1], dtype, dev), *shape)
    _k56_case(kr, "16-byte words", _random_of(gen, 64 * 13, torch.complex128, dev), 64, 13, 16, 4)
    specials = torch.tensor([float("nan"), -0.0, float("inf"), -float("inf"), 0.0, 1e-40, -1.5, 3.0] * 100, device=dev)
    words = specials.view(torch.int32)
    words[::8] = 0x7FC12345  # a quiet NaN with a payload
    words[5::8] = 0xFFC00001 - (1 << 32)  # a NaN with its sign bit set
    words[7::8] = 0x7F800001  # a signalling NaN
    _k56_case(kr, "NaN payloads and -0.0", specials, 32, 25, 32, 8)
    big = RELAYOUT_WIDE
    _k56_case(kr, "64-bit offsets (rows x c_out > 2^31)", _random_of(gen, big[0] * big[1], torch.bool, dev), *big)
    return errs


def relayout_path(dev) -> dict:
    """The slice's main path. On the card, 8 ranks of the packed pivot run
    in one process (``LocalWorld``: the exchange is a device copy, not
    NCCL): the 1 GB move (1000, 250000) split 1 -> (10,000,000, 25)
    new_split=1 and back, planned by the port's planner as heat_tpu plans
    them (packed-pivot, 9 all-to-alls each). Then the world-size-1 entry
    points. Returns K5's launches on the forward move and K6's on the
    reverse."""
    import torch

    import heat_tpu_torch as ht
    from heat_tpu_torch.kernels import relayout as kr
    from heat_tpu_torch.redistribution import executor, planner

    print("packed pivot: 8 ranks emulated in one process; exchange is a device copy, not NCCL", flush=True)
    gen = torch.Generator(device=dev)
    gen.manual_seed(31)
    x = torch.randn(*RESHAPE_1GB[0], device=dev, generator=gen)
    p = 8
    world = executor.LocalWorld(p)
    launches = {}
    shards = list(x.chunk(p, dim=1))
    for name, want in (("reshape_split1_1gb_p8", x.reshape(RESHAPE_1GB[1])), ("reshape_packed_rev_p8", x)):
        spec = dict(planner.golden_specs())[name]
        sched = planner.plan(spec)
        _require((sched.strategy, sched.collective_counts()) == ("packed-pivot", {"all-to-all": 9}),
                 f"{name} plans {sched.strategy} {sched.collective_counts()}, not packed-pivot with 9 all-to-alls")
        body = executor.program(spec, sched)
        shards = [s.contiguous() for s in shards]
        torch.cuda.synchronize()
        kr.PACK_LAUNCHES = kr.UNPACK_LAUNCHES = 0
        t0 = time.perf_counter()
        shards = world.run(body, shards)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        launches[name] = (kr.PACK_LAUNCHES, kr.UNPACK_LAUNCHES)
        whole = torch.cat(shards, dim=1)
        ok = torch.equal(_raw(whole), _raw(want))
        print(f"{name} {spec!r}: K5 launches {launches[name][0]}, K6 launches {launches[name][1]}, "
              f"all-to-alls per rank {world.counts[0]}, {'equal to torch.reshape' if ok else 'DIFFERS'} bit for bit; "
              f"{wall:.1f} ms wall for all 8 emulated ranks (not a distributed timing)", flush=True)
        _require(ok, f"{name}: the emulated ranks' result differs from torch.reshape")
        _require(all(c == sched.collective_counts() for c in world.counts), f"{name}: collectives differ from the plan")
    _require(launches["reshape_split1_1gb_p8"] == (8, 0), "the forward move must launch K5 once a rank and K6 never")
    _require(launches["reshape_packed_rev_p8"] == (0, 8), "the reverse move must launch K6 once a rank and K5 never")
    del shards, whole

    # world size 1 through the public entry points
    n = 2**27
    s = ht.arange(n, split=0).sum()
    _require(s.dtype is ht.int64 and s.item() == n * (n - 1) // 2,
             f"ht.arange(2**27, split=0).sum() gave {s.item()} ({s.dtype.__name__}), not {n * (n - 1) // 2} (int64)")
    A = ht.array(x, split=1)
    B = A.resplit(0)
    C = ht.reshape(A, RESHAPE_1GB[1], new_split=1)
    plan = ht.redistribution.explain(A, reshape=RESHAPE_1GB[1], new_split=1)
    ok = torch.equal(B.larray, x) and B.split == 0 and torch.equal(C.larray, x.reshape(RESHAPE_1GB[1])) and C.split == 1
    print(f"world size 1: ht.arange(2**27, split=0).sum() = {s.item()} (int64); resplit(0) and "
          f"reshape({RESHAPE_1GB[1]}, new_split=1) of the 1 GB array: {'equal' if ok else 'DIFFER'} to torch.reshape; "
          f"plan {plan.strategy}", flush=True)
    _require(ok and plan.strategy == "local", "world size 1 resplit/reshape")
    return {"pack": launches["reshape_split1_1gb_p8"][0], "unpack": launches["reshape_packed_rev_p8"][1]}


def relayout_timings(dev, launches: dict, errs: dict) -> list:
    """K5 and K6 at the per-rank shape of the 1 GB move over 8 ranks,
    beside their bound (bytes read and written over 3.35 TB/s), their plain
    versions and a clone() of the 160 MB buffer (the card's copy rate);
    no single PyTorch call pads and block-transposes, so no library row."""
    import torch

    from heat_tpu_torch.kernels import relayout as kr

    gen = torch.Generator(device=dev)
    gen.manual_seed(32)
    rows, c_in, c_out, p = RELAYOUT_P8
    x = torch.randn(rows * c_in, device=dev, generator=gen)
    packed = kr.pack_rows(x, rows, c_in, c_out, p)
    nbytes = 4.0 * rows * (c_in + c_out)
    bound_ms, bound_by = _bound(nbytes, 0.0)
    clone_ms = _median_ms(lambda: packed.clone(), 20)
    print(f"copy rate: clone() of the {packed.numel() * 4 / 1e6:.0f} MB packed buffer {clone_ms:.4f} ms "
          f"({2 * packed.numel() * 4 / (clone_ms * 1e-3) / 1e12:.3f} TB/s read + write)", flush=True)
    rows_out = []
    for name, kernel, (c_from, c_to), call, plain, line in (
        ("relayout_pack", "K5", (c_in, c_out), lambda: kr.pack_rows(x, rows, c_in, c_out, p),
         lambda: kr.pack_rows_plain(x, rows, c_in, c_out, p), "heat_tpu/kernels/relayout.py:169"),
        ("relayout_unpack", "K6", (c_out, c_in), lambda: kr.unpack_rows(packed, rows, c_out, c_in, p),
         lambda: kr.unpack_rows_plain(packed, rows, c_out, c_in, p), "heat_tpu/kernels/relayout.py:194"),
    ):
        ms = _median_ms(call, 20)
        plain_ms = _median_ms(plain, 5)
        print(f"{name} ({kernel}, {rows} rows, {c_from} -> {c_to} columns over p={p}, float32): {ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms, clone {clone_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}: "
              f"{nbytes / 1e6:.0f} MB; {nbytes / (ms * 1e-3) / 1e12:.3f} TB/s achieved)", flush=True)
        rows_out.append({
            "name": name, "route": "cuda", "source": "heat_tpu_torch/csrc/relayout.cu", "replaces": line,
            "launches": launches["pack" if kernel == "K5" else "unpack"], "max_abs_err": errs[name],
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
        })
    return rows_out


def profile_breakdown(label: str, call) -> list:
    """Device time by kernel for one ``call()``, from torch.profiler
    (device-side events only; the wall time includes the profiler's own
    cost); returns the names of the device work that ran."""
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
    return [key for _, _, key in rows]


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
    inputs = sparse_inputs()
    spmm_errs = check_spmm(dev, inputs)
    att_errs = check_attention(dev)
    relayout_errs = check_relayout(dev)
    launches = main_path(dev)
    assign_launches = kmeans_path(dev)
    sort_launches = sort_path(dev)
    sparse_launches = sparse_path(dev, inputs)
    att_launches, att_launches_sm90, att_path_errs = attention_path(dev)
    relayout_launches = relayout_path(dev)
    rows = timings(dev, launches, errs)
    rows.append(kmeans_timings(dev, assign_launches, assign_err))
    rows.extend(sort_timings(dev, sort_launches, sort_errs))
    rows.extend(sparse_timings(dev, inputs, sparse_launches, spmm_errs))
    rows.extend(attention_timings(dev, att_launches, att_launches_sm90, att_errs, att_path_errs))
    rows.extend(relayout_timings(dev, relayout_launches, relayout_errs))
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
