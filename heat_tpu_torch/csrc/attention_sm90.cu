// Hand-written Hopper (sm_90a) kernel K9, its bfloat16 path at head dims 64
// and 128: the forward of exact softmax attention with its log-sum-exp
// residual, fed by TMA and multiplied with wgmma.
//
// For each (batch, head) pair and query row i:
//     o[i, :] = sum_j softmax_j(scale * q[i, :] . k[j, :]) v[j, :]
//     lse[i]  = log sum_j exp(scale * q[i, :] . k[j, :])
//   over the valid keys j (all of them, or j <= i when causal: top-left
//   aligned, also when S_q != S_kv). q (B, H, S_q, D), k and v (B, H, S_kv,
//   D) in bfloat16 are read through (batch, head, row) strides that are
//   multiples of 16 bytes, from bases on 16 bytes, with a contiguous last
//   dim: the heads of a packed projection need no copy. o (B*H, S_q, D) is
//   written in bfloat16, lse (B*H, S_q) in float32. A row with no valid key
//   gets o = 0 and lse = -inf. D = 64 or 128, any S_q, S_kv >= 1: the ragged
//   edges come in zero-filled from TMA and are masked here. The other
//   shapes keep attention.cu's kernels (mma.sync for bfloat16, CUDA cores
//   for float32).
//   Replaces the TPU kernel heat_tpu/nn/attention.py calls for bfloat16:
//   JAX's splash kernel (_build_splash_mha, :537), and its flash kernel
//   (_pallas_attention_program, :637) where that one serves bfloat16, both
//   also in their save-residuals form (_ring_step_kernels, :250).
//
// What bounds it on an H100 SXM: 4 * B*H * (valid pairs) * D operations on
// the tensor cores at 989 TFLOP/s bf16 (RAB, (1, 8, 16384, 128) causal:
// 5.5e11 operations, 0.556 ms), against reading q, k, v and writing o once
// (135 MB, 0.04 ms). The exp2 of every valid score runs on the SFU, at 16 a
// clock an SM: 1.07e9 at RAB, about 0.29 ms at 1.75 GHz, half the tensor-core
// time. So the tensor cores must be kept fed from shared memory without a
// register round trip, and the exps must run under the products, not
// between them.
//
// Design (one block of three warpgroups per (batch, head) and tile of 128
// query rows; the last tiles, the heaviest when causal, go first):
// * Warpgroup 0 is the producer: setmaxnreg.dec gives its registers away
//   and one thread issues TMA loads (4-D tensor maps over (D, S, H, B) in
//   the operands' own strides, 128-byte swizzle, D = 128 as two 64-column
//   boxes). Q comes once; K and V come in tiles of 128 keys through a ring
//   of ST stages, each with full and empty mbarriers for K and for V, so
//   Q K^T of a tile can start before its V has landed. Tiles wholly above
//   the causal diagonal are never loaded; rows past S_q or S_kv are zero
//   filled by TMA.
// * Warpgroups 1 and 2 are consumers, 64 query rows each (setmaxnreg.inc
//   to 240 registers). S = Q K^T is wgmma m64n128k16 with both operands
//   from swizzled shared memory (K-major). P is rounded to bf16 in
//   registers, as splash does, and is the register A operand of O += P V,
//   wgmma m64nDk16 with V from shared memory in its natural layout
//   (MN-major B, the transpose bit set).
// * Softmax: float32 scores; the row max is taken on the raw scores, so
//   the scale (in log2 units) and the shift cost one FFMA a score ahead of
//   exp2 on the SFU, not a multiply and a subtract. Row max by shuffles over the
//   four threads that share a row in wgmma's accumulator layout, row sums
//   kept per thread and reduced once at the end. Masks only on tiles that
//   cross the diagonal or the ragged edge.
// * Overlap: within a warpgroup, iteration j issues S_j = Q K_j^T and
//   O += P_{j-1} V_{j-1} back to back, then runs the softmax of S_j while
//   the second product is in flight. Across warpgroups, two named barriers
//   hand the tensor cores back and forth (ping-pong), so one warpgroup's
//   exps run under the other's products.
// * Each block owns its rows: no atomics, no split over keys, a rerun
//   repeats the bits.
// * Descriptors are built once a tile and stepped by adding to their
//   address field: built afresh for every product, they cost enough
//   registers at D = 128 that ptxas spilled and serialised the wgmmas.
// * Not done: a persistent grid (tried: one block an SM walking the items
//   with the next Q loading under the last tile moved no time beyond the
//   run-to-run spread), an intra-tile split of the softmax, TMA stores of
//   o, D = 256 (a 64 x 256 accumulator needs twice the registers).

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;  // query rows of a block (two consumer warpgroups of 64)
constexpr int BN = 128;  // keys of a K/V tile
constexpr int NT = 384;  // threads: producer warpgroup + two consumer warpgroups

struct Args {
  void* o;
  float* lse;
  int H, BH, n_qt;
  long long sq, skv;
  float sl2;  // scale * log2(e)
  int causal;
};

// ------------------------------------------------------------ PTX helpers
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], "
      "[%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void named_sync(int id) { asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory"); }
__device__ __forceinline__ void named_arrive(int id) { asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory"); }

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving reads or writes of wgmma's registers across
// the asynchronous product: each register is "rewritten" here.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// wgmma shared-memory descriptor for a 128-byte-swizzled tile: start
// address, leading and stride byte offsets (16-byte units), layout 1 = B128.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | ((uint64_t)1 << 62);
}

#define F8(d, i) \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), \
      "+f"(d[i + 7])
#define F32(d) F8(d, 0), F8(d, 8), F8(d, 16), F8(d, 24)
#define F64(d) F32(d), F8(d, 32), F8(d, 40), F8(d, 48), F8(d, 56)
#define R32                                                                                                        \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, " \
  "%24, %25, %26, %27, %28, %29, %30, %31}"
#define R64                                                                                                        \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, " \
  "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, "  \
  "%46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"

// d (64 x 128, f32) (+)= A (64 x 16, smem, K-major) B (16 x 128, smem, K-major)
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " R64 ", %64, %65, p, 1, 1, 0, 0;\n}\n"
      : F64(d)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 128, f32) += A (64 x 16, registers) B (16 x 128, smem, MN-major)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " R64 ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : F64(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 64, f32) += A (64 x 16, registers) B (16 x 64, smem, MN-major)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " R32 ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : F32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (the lower index) in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

// ------------------------------------------------------------------ kernel
template <int D, int ST>
__global__ void __launch_bounds__(NT, 1)
    attn_sm90_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv, const Args a) {
  constexpr int DC = D / 64;                 // 64-column (128-byte) chunks of a row
  constexpr uint32_t CHUNK = BN * 128;       // bytes of one chunk of a 128-row tile
  constexpr uint32_t TILE = DC * CHUNK;      // bytes of a Q, K or V tile
  constexpr int NO = D / 2;                  // o accumulators a thread holds (64 rows x D / 128 threads)
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[1 + 4 * ST];

  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;  // swizzled tiles sit on 1024 bytes
  const uint32_t sQ = base;
  auto sK = [&](int s) { return base + TILE + (uint32_t)s * 2u * TILE; };
  auto sV = [&](int s) { return base + TILE + (uint32_t)s * 2u * TILE + TILE; };
  const uint32_t q_full = smem_u32(&bars[0]);
  auto k_full = [&](int s) { return smem_u32(&bars[1 + s]); };
  auto v_full = [&](int s) { return smem_u32(&bars[1 + ST + s]); };
  auto k_empty = [&](int s) { return smem_u32(&bars[1 + 2 * ST + s]); };
  auto v_empty = [&](int s) { return smem_u32(&bars[1 + 3 * ST + s]); };

  const int bx = blockIdx.x;
  const int bh = bx % a.BH;
  const int qt = a.n_qt - 1 - bx / a.BH;  // the last query tiles, the heaviest when causal, go first
  const long long q0 = (long long)qt * BM;
  const int b = bh / a.H, h = bh - b * a.H;
  long long kend = a.skv;
  if (a.causal && q0 + BM < kend) kend = q0 + BM;
  const int ntiles = (int)((kend + BN - 1) / BN);

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(k_empty(s), 8);  // one arrival from each consumer warp
      mbar_init(v_empty(s), 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---------------------------------------------------------- producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, TILE);
#pragma unroll
      for (int c = 0; c < DC; ++c) tma_load(sQ + c * CHUNK, &tq, q_full, c * 64, (int)q0, h, b);
      for (int j = 0; j < ntiles; ++j) {
        const int s = j % ST;
        const uint32_t ph = ((j / ST) & 1) ^ 1;  // the first round finds every stage empty
        mbar_wait(k_empty(s), ph);
        mbar_expect_tx(k_full(s), TILE);
#pragma unroll
        for (int c = 0; c < DC; ++c) tma_load(sK(s) + c * CHUNK, &tk, k_full(s), c * 64, j * BN, h, b);
        mbar_wait(v_empty(s), ph);
        mbar_expect_tx(v_full(s), TILE);
#pragma unroll
        for (int c = 0; c < DC; ++c) tma_load(sV(s) + c * CHUNK, &tv, v_full(s), c * 64, j * BN, h, b);
      }
    }
  } else {
    // ---------------------------------------------------------- consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int w = (threadIdx.x >> 7) - 1;  // consumer warpgroup 0 or 1
    const int tid = threadIdx.x & 127;
    const int warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t4 = lane & 3;
    const long long r0 = q0 + 64 * w + 16 * warp + g;  // this thread's rows: r0 and r0 + 8
    const int my_bar = 1 + w, other_bar = 2 - w;
    const uint32_t sQw = sQ + (uint32_t)w * 64u * 128u;  // this warpgroup's 64 rows of each Q chunk

    float s[64], o[NO];
    uint32_t p[32];
#pragma unroll
    for (int i = 0; i < 64; ++i) s[i] = 0.f;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < NO; ++i) o[i] = 0.f;

    // S = Q K_st^T: D / 16 steps of 16 along D, 32 bytes apart in a chunk
    // (a step moves the descriptor's address field, in 16-byte units)
    const uint64_t dq = desc(sQw, 16, 1024);
    auto qk = [&](int st) {
      const uint64_t dk = desc(sK(st), 16, 1024);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off = ((kk >> 2) * CHUNK + (kk & 3) * 32u) >> 4;
        wgmma_ss_n128(s, dq + off, dk + off, kk > 0);
      }
    };
    // O += P V_st: 8 steps of 16 keys, 2048 bytes apart; the 64-column
    // chunks of V (N) are a chunk apart
    auto pv = [&](int st) {
      const uint64_t dv = desc(sV(st), CHUNK, 1024);
#pragma unroll
      for (int kb = 0; kb < BN / 16; ++kb) {
        if constexpr (D == 128)
          wgmma_rs_n128(o, &p[4 * kb], dv + kb * (2048 >> 4));
        else
          wgmma_rs_n64(o, &p[4 * kb], dv + kb * (2048 >> 4));
      }
    };
    // the online softmax of tile j on the raw scores in s: p = exp2 in s,
    // corr. The largest scaled score of a row is sc times the raw max (or,
    // for a negative scale, the raw min), so the scale costs one FFMA a
    // score, fused with the shift. A tile that needs a mask is scaled
    // first and its masked scores set to -inf (sc = 1 then).
    auto softmax = [&](int j, float (&corr)[2]) {
      const long long k0 = (long long)j * BN;
      float sc = a.sl2;
      if (k0 + BN > a.skv || (a.causal && k0 + BN - 1 > q0 + 64 * w)) {
#pragma unroll
        for (int i = 0; i < 64; ++i) {
          const long long jj = k0 + 8 * (i >> 2) + 2 * t4 + (i & 1);
          const long long row = r0 + 8 * ((i >> 1) & 1);
          s[i] = jj >= a.skv || (a.causal && jj > row) ? -INFINITY : s[i] * sc;
        }
        sc = 1.f;
      }
      float mx[2];
      if (sc >= 0.f) {
        mx[0] = mx[1] = -INFINITY;
#pragma unroll
        for (int i = 0; i < 64; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
      } else {
        mx[0] = mx[1] = INFINITY;
#pragma unroll
        for (int i = 0; i < 64; ++i) mx[(i >> 1) & 1] = fminf(mx[(i >> 1) & 1], s[i]);
      }
#pragma unroll
      for (int hi = 0; hi < 2; ++hi) {
        float x = mx[hi] * sc;  // the row's largest scaled score in this tile
        x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
        x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
        const float m_new = fmaxf(m[hi], x);
        mx[hi] = m_new == -INFINITY ? 0.f : m_new;  // the shift used: 0 while the row has no valid key
        corr[hi] = ex2(m[hi] - mx[hi]);
        m[hi] = m_new;
      }
      float sum[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        const float e = ex2(fmaf(s[i], sc, -mx[(i >> 1) & 1]));
        s[i] = e;
        sum[(i >> 1) & 1] += e;
      }
      l[0] = l[0] * corr[0] + sum[0];  // per-thread partial sums, reduced at the end
      l[1] = l[1] * corr[1] + sum[1];
    };
    auto to_p = [&]() {
#pragma unroll
      for (int kb = 0; kb < 8; ++kb) {
        p[4 * kb + 0] = pack_bf16(s[8 * kb + 0], s[8 * kb + 1]);
        p[4 * kb + 1] = pack_bf16(s[8 * kb + 2], s[8 * kb + 3]);
        p[4 * kb + 2] = pack_bf16(s[8 * kb + 4], s[8 * kb + 5]);
        p[4 * kb + 3] = pack_bf16(s[8 * kb + 6], s[8 * kb + 7]);
      }
    };
    auto release = [&](uint32_t bar) {
      __syncwarp();
      if (lane == 0) mbar_arrive(bar);
    };

    mbar_wait(q_full, 0);
    if (w == 1) named_arrive(1);  // warpgroup 0 takes the tensor cores first

    // tile 0: S only
    float corr[2];
    mbar_wait(k_full(0), 0);
    named_sync(my_bar);
    wgmma_fence();
    qk(0);
    wgmma_commit();
    named_arrive(other_bar);
    wgmma_wait<0>();
    fence_regs(s);
    release(k_empty(0));
    softmax(0, corr);
    to_p();

    for (int j = 1; j < ntiles; ++j) {
      const int st = j % ST, pst = (j - 1) % ST;
      mbar_wait(k_full(st), (j / ST) & 1);
      named_sync(my_bar);
      fence_regs(o);
      fence_regs(p);
      wgmma_fence();
      qk(st);
      wgmma_commit();
      mbar_wait(v_full(pst), ((j - 1) / ST) & 1);
      pv(pst);
      wgmma_commit();
      named_arrive(other_bar);
      wgmma_wait<1>();  // S_j is done, O += P_{j-1} V_{j-1} may still run
      fence_regs(s);
      release(k_empty(st));
      softmax(j, corr);
      wgmma_wait<0>();
      fence_regs(o);
      fence_regs(p);
      release(v_empty(pst));
#pragma unroll
      for (int i = 0; i < NO; ++i) o[i] *= corr[(i >> 1) & 1];
      to_p();
    }

    // the last tile's O += P V
    const int lst = (ntiles - 1) % ST;
    mbar_wait(v_full(lst), ((ntiles - 1) / ST) & 1);
    named_sync(my_bar);
    fence_regs(o);
    fence_regs(p);
    wgmma_fence();
    pv(lst);
    wgmma_commit();
    if (w == 0) named_arrive(other_bar);  // warpgroup 1 has no turn left to hand over
    wgmma_wait<0>();
    fence_regs(o);
    fence_regs(p);
    release(v_empty(lst));

    // epilogue: o = acc / l in bfloat16, lse = (m + log2 l) ln 2
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      l[hi] += __shfl_xor_sync(0xffffffffu, l[hi], 1);
      l[hi] += __shfl_xor_sync(0xffffffffu, l[hi], 2);
      const long long row = r0 + 8 * hi;
      if (row >= a.sq) continue;
      const bool live = l[hi] > 0.f;
      const float inv = live ? 1.f / l[hi] : 0.f;
      __nv_bfloat16* orow = static_cast<__nv_bfloat16*>(a.o) + ((long long)bh * a.sq + row) * D;
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
        *reinterpret_cast<__nv_bfloat162*>(orow + n * 8 + 2 * t4) =
            __floats2bfloat162_rn(o[4 * n + 2 * hi] * inv, o[4 * n + 2 * hi + 1] * inv);
      if (t4 == 0)
        a.lse[(long long)bh * a.sq + row] = live ? (m[hi] + log2f(l[hi])) * 0.6931471805599453f : -INFINITY;
    }
  }
}

// ---------------------------------------------------------------- host side
PFN_cuTensorMapEncodeTiled_v12000 encode_fn() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault,
                                                           &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess) fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(ptr);
  }
  return fn;
}

constexpr int ERR_ENCODE = 100000;  // + the CUresult of a refused tensor map

// A 4-D tensor map over (D, S, H, B) in the operand's own byte strides
// (cuTensorMapEncodeTiled takes them unsorted, and 0 along an extent of 1) with a box
// of 64 columns x 128 rows, 128-byte swizzle, zero fill out of bounds.
int encode(CUtensorMap* map, const void* ptr, long long s_b, long long s_h, long long s_r, long long B, long long H,
           long long S, int d) {
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)S, (cuuint64_t)H, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)s_r * 2, (cuuint64_t)s_h * 2, (cuuint64_t)s_b * 2};
  const cuuint32_t box[4] = {64, BN, 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  PFN_cuTensorMapEncodeTiled_v12000 fn = encode_fn();
  if (fn == nullptr) return ERR_ENCODE;
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : ERR_ENCODE + (int)r;
}

template <int D, int ST>
int launch(const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv, const Args& a, long long blocks,
           cudaStream_t s) {
  const size_t smem = (size_t)(1 + 2 * ST) * (D / 64) * BN * 128 + 1024;
  auto kernel = attn_sm90_kernel<D, ST>;
  const cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<(unsigned)blocks, NT, smem, s>>>(tq, tk, tv, a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// o (B*H, S_q, D) bfloat16 and lse (B*H, S_q) float32 of attention over
// bfloat16 q, k, v with D = D_v in {64, 128}, each read at base + b * s_b +
// h * s_h + row * s_row (in elements; 0 along an extent of 1) with a
// contiguous last dim; bases and strides on 16 bytes. Returns 0, the CUDA
// error code of the launch, or 100000 + the CUresult of a refused tensor
// map (100000 alone: cuTensorMapEncodeTiled was not found).
int heat_flash_attention_sm90(const void* q, const void* k, const void* v, void* o, float* lse, long long qb,
                              long long qh, long long qs, long long kb, long long kh, long long ks, long long vb,
                              long long vh, long long vs, int B, int H, long long sq, long long skv, int d,
                              float scale, int causal, int device, void* stream) {
  if (B < 1 || H < 1 || (long long)B * H > 0x7fffffffLL || sq < 1 || skv < 1 || sq > 0x7fffffffLL ||
      skv > 0x7fffffffLL || (d != 64 && d != 128))
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  CUtensorMap tq, tk, tv;
  Args a{o, lse, H, B * H, 0, sq, skv, scale * 1.4426950408889634f, causal};
  int rc = encode(&tq, q, qb, qh, qs, B, H, sq, d);
  if (rc == 0) rc = encode(&tk, k, kb, kh, ks, B, H, skv, d);
  if (rc == 0) rc = encode(&tv, v, vb, vh, vs, B, H, skv, d);
  if (rc != 0) return rc;
  const long long n_qt = (sq + BM - 1) / BM;
  a.n_qt = (int)n_qt;
  const long long blocks = n_qt * a.BH;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return d == 128 ? launch<128, 2>(tq, tk, tv, a, blocks, s) : launch<64, 3>(tq, tk, tv, a, blocks, s);
}

const char* heat_attention_sm90_error_string(int code) {
  if (code >= ERR_ENCODE) return "cuTensorMapEncodeTiled refused the tensor map (or was not found)";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
