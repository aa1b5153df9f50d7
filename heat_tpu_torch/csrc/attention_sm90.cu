// Hand-written Hopper (sm_90a) kernels of K9: the forward of exact softmax
// attention with its log-sum-exp residual, fed by TMA and multiplied with
// wgmma. Two kernels: bfloat16 at head dims 64, 128 and 256
// (attn_sm90_kernel), and float32 at head dim 64 in three TF32 passes that
// keep float32 accuracy (attn_sm90_f32_kernel).
//
// For each (batch, head) pair and query row i:
//     o[i, :] = sum_j softmax_j(scale * q[i, :] . k[j, :]) v[j, :]
//     lse[i]  = log sum_j exp(scale * q[i, :] . k[j, :])
//   over the valid keys j (all of them, or j <= i when causal: top-left
//   aligned, also when S_q != S_kv). q (B, H, S_q, D), k and v (B, H, S_kv,
//   D) are read through (batch, head, row) strides that are multiples of 16
//   bytes, from bases on 16 bytes, with a contiguous last dim: the heads of
//   a packed projection need no copy. o (B*H, S_q, D) is written in the
//   input dtype, lse (B*H, S_q) in float32. A row with no valid key gets
//   o = 0 and lse = -inf. bfloat16 at D = 64, 128 or 256, float32 at D = 64;
//   any S_q, S_kv >= 1: the ragged edges come in zero-filled from TMA and
//   are masked here. The other shapes keep attention.cu's kernels (mma.sync
//   for bfloat16, CUDA cores for float32).
//   Replaces the TPU kernels heat_tpu/nn/attention.py calls: JAX's splash
//   kernel for bfloat16 (_build_splash_mha, :537) and its flash kernel
//   (_pallas_attention_program, :637), which serves float32 (and bfloat16
//   where splash does not), both also in their save-residuals form
//   (_ring_step_kernels, :250).
//
// What bounds them on an H100 SXM.
// * bfloat16: 4 * B*H * (valid pairs) * D operations on the tensor cores
//   at 989 TFLOP/s (RAB, (1, 8, 16384, 128) causal: 5.5e11 operations,
//   0.556 ms; (1, 8, 4096, 256) causal: 6.9e10, 0.0695 ms), against reading
//   q, k, v and writing o once (135 MB, 0.04 ms, at RAB). The exp2 of every
//   valid score runs on the SFU, at 16 a clock an SM: 1.07e9 at RAB, about
//   0.29 ms at 1.75 GHz, half the tensor-core time. So the tensor cores
//   must be kept fed from shared memory without a register round trip, and
//   the exps must run under the products, not between them.
// * float32: FP32 accuracy on the CUDA cores costs the same operations at
//   67 TFLOP/s (RA, (4, 8, 4096, 64) causal: 6.87e10 operations, 1.03 ms).
//   On the tensor cores TF32 keeps 11 bits of mantissa, so each product
//   runs three times (3xTF32, below): 3 * 6.87e10 at 495 TFLOP/s, 0.417 ms
//   causal, 0.833 ms not. The operands must also be split into their TF32
//   halves, and V transposed (below), once a tile and not once a product.
//
// Design of both (one block of three warpgroups per (batch, head) and tile
// of 128 query rows; the last tiles, the heaviest when causal, go first):
// * Warpgroup 0 gives its registers away (setmaxnreg.dec); one thread
//   issues TMA loads (4-D tensor maps over (D, S, H, B) in the operands'
//   own strides, 128-byte swizzle, a row as boxes of 128 bytes). Q comes
//   once; K and V come in tiles of BN keys through a ring of ST stages,
//   each with full and empty mbarriers for K and for V, so Q K^T of a tile
//   can start before its V has landed. Tiles wholly above the causal
//   diagonal are never loaded; rows past S_q or S_kv are zero filled by TMA.
// * Warpgroups 1 and 2 are consumers, 64 query rows each (setmaxnreg.inc).
//   S = Q K^T and O += P V are wgmma with B from swizzled shared memory; P
//   is the register A operand of the second product.
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
//
// bfloat16 (attn_sm90_kernel<D, ST>): both products are bf16 wgmma (k16),
// S from shared memory (K-major), O += P V with P rounded to bf16 in
// registers, as splash does, and V in its natural layout (MN-major B, the
// transpose bit set). Key tiles of BN = 128 at D = 64 and 128 (3 and 2
// stages); at D = 256, BN = 80 (FA3's tile at this head dim; 2 stages):
// the 64 x 256 float32 o is 128 registers a consumer thread, S 40 and P
// 20, inside 240, and Q (64 KB) plus two stages of K and V (40 KB each)
// take 224 KB of shared memory. At BN = 64 each k16 step of Q K^T reads
// 4 KB of shared memory for 32 clocks of tensor work, the whole 128 B a
// clock the SM's shared memory gives; at 80 it reads 4.5 KB for 40. At
// D = 256 the second product is two wgmma n128 a step, one for each half
// of V's columns.
//
// float32 (attn_sm90_f32_kernel<ST>, D = 64, BN = 64, 2 stages), 3xTF32:
// each operand x is split into big = cvt.rna.tf32(x) and small =
// cvt.rna.tf32(x - big) (rounded, not the tensor core's truncation of raw
// float32 bits), and each product is three TF32 wgmmas (k8) into one
// float32 accumulator, the small terms first so that they are not lost
// against the big one, as CUTLASS's OpMultiplyAddFastF32 orders them: S =
// Qs Kb^T + Qb Ks^T + Qb Kb^T and O += Ps Vb + Pb Vs + Pb Vb. The dropped
// term small * small is 2^-22 of the product.
// * TF32 wgmma reads only K-major operands from shared memory (the
//   transpose bit exists for 16-bit types only). K lands K-major by TMA;
//   V lands with D contiguous and must be turned round. So warps 1-3 of
//   warpgroup 0 sit between the TMA thread and the consumers: they split K
//   in place (its big half over the landed tile, the small one beside it),
//   and write V^T's big and small halves (keys contiguous, swizzled as
//   wgmma reads them) from the landed V, then fence the async proxy and
//   arrive on ready barriers, which the consumers wait on instead of
//   TMA's. A stage holds K big and small, V as landed, V^T big and small:
//   80 KB, two stages and Q 192 KB. The split moves 96 KB of shared memory
//   a tile beside wgmma's 192 KB of operand reads, so it uses 16-byte
//   accesses only: K float4 by float4 in place, V^T in 4 x 4 blocks turned
//   in registers (4-byte reads of V with per-element swizzle arithmetic
//   make the split warps the bottleneck).
// * Q's halves live in registers as the A operand (64 x 64 each, 32
//   registers a thread apiece), split once from the landed tile. P is
//   split in registers. TF32 A fragments hold, in each 8-column step,
//   columns t and t + 4 of a thread's rows, while the accumulator of S
//   holds columns 2t and 2t + 1: rather than move scores between threads,
//   the keys of each group of 8 are taken in the order 0 2 4 6 1 3 5 7 in
//   both P and V^T (a sum over keys does not care), and V^T is written in
//   that order.
// * Registers: o 32, s 32, Q's halves 64 and P's 64 a consumer thread, so
//   the consumers take 232 (setmaxnreg.inc) and warpgroup 0 keeps 40.
// * D = 128 in float32 does not fit: Q's halves alone are 128 registers a
//   thread in registers or 128 KB in shared memory, beside K's, V^T's and
//   the landed V's 160 KB a stage at BN = 64. It stays on attention.cu.
//
// Not done: a persistent grid (tried for bfloat16: one block an SM walking
// the items with the next Q loading under the last tile moved no time
// beyond the run-to-run spread), an intra-tile split of the softmax, TMA
// stores of o.

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;  // query rows of a block (two consumer warpgroups of 64)
constexpr int NT = 384;  // threads: producer warpgroup + two consumer warpgroups

// keys of a K/V tile of the bfloat16 kernel at head dim D
template <int D>
__host__ __device__ constexpr int kv_tile() {
  return D == 256 ? 80 : 128;
}

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

// generic-proxy writes to shared memory, made visible to wgmma (async proxy)
__device__ __forceinline__ void fence_async_smem() { asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory"); }

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
#define R40                                                                                                        \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, " \
  "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39}"
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

// d (64 x 80, f32) (+)= A (64 x 16, smem, K-major) B (16 x 80, smem, K-major)
__device__ __forceinline__ void wgmma_ss_n80(float (&d)[40], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %42, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 " R40 ", %40, %41, p, 1, 1, 0, 0;\n}\n"
      : F32(d), F8(d, 32)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 128, f32; d[0..63] of the caller's accumulator) += A (64 x 16,
// registers) B (16 x 128, smem, MN-major)
__device__ __forceinline__ void wgmma_rs_n128(float* d, const uint32_t* a, uint64_t db) {
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

// d (64 x 64, f32) (+)= A (64 x 8, registers, TF32) B (8 x 64, smem, K-major, TF32)
__device__ __forceinline__ void wgmma_tf32_n64(float (&d)[32], const uint32_t* a, uint64_t db, int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 " R32 ", {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : F32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// x rounded to TF32 (10 explicit mantissa bits), to nearest, ties away
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t y;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(y) : "f"(x));
  return y;
}

// x = big + small, each TF32
__device__ __forceinline__ void tf32_split(float x, uint32_t& big, uint32_t& small) {
  big = tf32_rna(x);
  small = tf32_rna(x - __uint_as_float(big));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (the lower index) in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

// ------------------------------------------------- shared by both kernels
// The online softmax of one key tile on the raw scores in s (wgmma's
// accumulator layout: s[i] is column 8 (i / 4) + 2 t4 + i % 2 of the tile
// and row r0 + 8 ((i / 2) % 2)): s becomes p = exp2 in place, m and l
// advance, corr is exp2(m_old - m_new) of both rows. The largest scaled
// score of a row is sl2 times the raw max (or, for a negative scale, the
// raw min), so the scale costs one FFMA a score, fused with the shift. A
// tile that needs a mask (masked) is scaled first and its masked scores
// set to -inf (sc = 1 then).
template <int NS>
__device__ __forceinline__ void online_softmax(float (&s)[NS], float (&m)[2], float (&l)[2], float (&corr)[2],
                                               bool masked, long long k0, long long r0, int t4, const Args& a) {
  float sc = a.sl2;
  if (masked) {
#pragma unroll
    for (int i = 0; i < NS; ++i) {
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
    for (int i = 0; i < NS; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
  } else {
    mx[0] = mx[1] = INFINITY;
#pragma unroll
    for (int i = 0; i < NS; ++i) mx[(i >> 1) & 1] = fminf(mx[(i >> 1) & 1], s[i]);
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
  for (int i = 0; i < NS; ++i) {
    const float e = ex2(fmaf(s[i], sc, -mx[(i >> 1) & 1]));
    s[i] = e;
    sum[(i >> 1) & 1] += e;
  }
  l[0] = l[0] * corr[0] + sum[0];  // per-thread partial sums, reduced at the end
  l[1] = l[1] * corr[1] + sum[1];
}

// The epilogue's row sum over the four threads of a row; writes lse
// (m + log2 l) ln 2 from the row's first thread and returns 1 / l (0 for a
// row with no valid key).
__device__ __forceinline__ float finish_row(float l, float m, long long bh, long long row, int t4, const Args& a) {
  l += __shfl_xor_sync(0xffffffffu, l, 1);
  l += __shfl_xor_sync(0xffffffffu, l, 2);
  const bool live = l > 0.f;
  if (t4 == 0 && row < a.sq) a.lse[bh * a.sq + row] = live ? (m + log2f(l)) * 0.6931471805599453f : -INFINITY;
  return live ? 1.f / l : 0.f;
}

// Addresses of the first of each array of ST consecutive mbarriers: those a
// consumer waits on before it reads a stage's K and V, and those it arrives
// on when it is done with them.
struct Ring {
  uint32_t k_ready, v_ready, k_empty, v_empty;
};

// The consumers' walk over the key tiles, the same in both kernels: tile 0
// computes S only; iteration j issues S_j = Q K_j^T and O += P_{j-1}
// V_{j-1} back to back and runs the softmax of S_j while the second product
// is in flight; the last tile adds its P V. Two named barriers hand the
// tensor cores from one warpgroup (w) to the other (ping-pong). qk(st) and
// pv(st) issue a product on stage st, softmax(j, corr) and to_p() turn S_j
// into P, rescale(corr) scales o; fence_s() and fence_pv() rewrite the
// registers of the first and of the second product (fence_regs).
template <int ST, class QK, class PV, class Softmax, class ToP, class Rescale, class FenceS, class FencePV>
__device__ __forceinline__ void consumer_tiles(int ntiles, int w, int lane, const Ring& ring, QK qk, PV pv,
                                               Softmax softmax, ToP to_p, Rescale rescale, FenceS fence_s,
                                               FencePV fence_pv) {
  const int my_bar = 1 + w, other_bar = 2 - w;
  auto at = [](uint32_t first, int stage) { return first + 8u * (uint32_t)stage; };
  auto release = [&](uint32_t bar) {
    __syncwarp();
    if (lane == 0) mbar_arrive(bar);
  };
  if (w == 1) named_arrive(1);  // warpgroup 0 takes the tensor cores first

  // tile 0: S only
  float corr[2];
  mbar_wait(ring.k_ready, 0);
  named_sync(my_bar);
  wgmma_fence();
  qk(0);
  wgmma_commit();
  named_arrive(other_bar);
  wgmma_wait<0>();
  fence_s();
  release(ring.k_empty);
  softmax(0, corr);
  to_p();

  for (int j = 1; j < ntiles; ++j) {
    const int st = j % ST, pst = (j - 1) % ST;
    mbar_wait(at(ring.k_ready, st), (j / ST) & 1);
    named_sync(my_bar);
    fence_pv();
    wgmma_fence();
    qk(st);
    wgmma_commit();
    mbar_wait(at(ring.v_ready, pst), ((j - 1) / ST) & 1);
    pv(pst);
    wgmma_commit();
    named_arrive(other_bar);
    wgmma_wait<1>();  // S_j is done, O += P_{j-1} V_{j-1} may still run
    fence_s();
    release(at(ring.k_empty, st));
    softmax(j, corr);
    wgmma_wait<0>();
    fence_pv();
    release(at(ring.v_empty, pst));
    rescale(corr);
    to_p();
  }

  // the last tile's O += P V
  const int lst = (ntiles - 1) % ST;
  mbar_wait(at(ring.v_ready, lst), ((ntiles - 1) / ST) & 1);
  named_sync(my_bar);
  fence_pv();
  wgmma_fence();
  pv(lst);
  wgmma_commit();
  if (w == 0) named_arrive(other_bar);  // warpgroup 1 has no turn left to hand over
  wgmma_wait<0>();
  fence_pv();
  release(at(ring.v_empty, lst));
}

// ------------------------------------------------------ bfloat16 kernel
template <int D, int ST>
__global__ void __launch_bounds__(NT, 1)
    attn_sm90_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv, const Args a) {
  constexpr int BN = kv_tile<D>();
  constexpr int DC = D / 64;                // 64-column (128-byte) chunks of a row
  constexpr uint32_t QCHUNK = BM * 128;     // bytes of one chunk of the Q tile
  constexpr uint32_t KCHUNK = BN * 128;     // bytes of one chunk of a K or V tile
  constexpr uint32_t QTILE = DC * QCHUNK;
  constexpr uint32_t KTILE = DC * KCHUNK;
  constexpr int NO = D / 2;                 // o accumulators a thread holds (64 rows x D / 128 threads)
  constexpr int NS = BN / 2;                // score accumulators a thread holds
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[1 + 4 * ST];

  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;  // swizzled tiles sit on 1024 bytes
  const uint32_t sQ = base;
  auto sK = [&](int s) { return base + QTILE + (uint32_t)s * 2u * KTILE; };
  auto sV = [&](int s) { return base + QTILE + (uint32_t)s * 2u * KTILE + KTILE; };
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
      mbar_expect_tx(q_full, QTILE);
#pragma unroll
      for (int c = 0; c < DC; ++c) tma_load(sQ + c * QCHUNK, &tq, q_full, c * 64, (int)q0, h, b);
      for (int j = 0; j < ntiles; ++j) {
        const int s = j % ST;
        const uint32_t ph = ((j / ST) & 1) ^ 1;  // the first round finds every stage empty
        mbar_wait(k_empty(s), ph);
        mbar_expect_tx(k_full(s), KTILE);
#pragma unroll
        for (int c = 0; c < DC; ++c) tma_load(sK(s) + c * KCHUNK, &tk, k_full(s), c * 64, j * BN, h, b);
        mbar_wait(v_empty(s), ph);
        mbar_expect_tx(v_full(s), KTILE);
#pragma unroll
        for (int c = 0; c < DC; ++c) tma_load(sV(s) + c * KCHUNK, &tv, v_full(s), c * 64, j * BN, h, b);
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
    const uint32_t sQw = sQ + (uint32_t)w * 64u * 128u;  // this warpgroup's 64 rows of each Q chunk

    float s[NS], o[NO];
    uint32_t p[BN / 4];
#pragma unroll
    for (int i = 0; i < NS; ++i) s[i] = 0.f;
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
        const uint32_t qoff = ((kk >> 2) * QCHUNK + (kk & 3) * 32u) >> 4;
        const uint32_t koff = ((kk >> 2) * KCHUNK + (kk & 3) * 32u) >> 4;
        if constexpr (BN == 128)
          wgmma_ss_n128(s, dq + qoff, dk + koff, kk > 0);
        else
          wgmma_ss_n80(s, dq + qoff, dk + koff, kk > 0);
      }
    };
    // O += P V_st: BN / 16 steps of 16 keys, 2048 bytes apart; the 64-column
    // chunks of V (N) are a chunk apart
    auto pv = [&](int st) {
      const uint64_t dv = desc(sV(st), KCHUNK, 1024);
#pragma unroll
      for (int kb = 0; kb < BN / 16; ++kb) {
        if constexpr (D == 256) {  // two n128 halves: columns 0-127, then 128-255 (chunks 2 and 3)
          wgmma_rs_n128(o, &p[4 * kb], dv + kb * (2048 >> 4));
          wgmma_rs_n128(o + 64, &p[4 * kb], dv + kb * (2048 >> 4) + ((2 * KCHUNK) >> 4));
        } else if constexpr (D == 128) {
          wgmma_rs_n128(o, &p[4 * kb], dv + kb * (2048 >> 4));
        } else {
          wgmma_rs_n64(o, &p[4 * kb], dv + kb * (2048 >> 4));
        }
      }
    };
    auto softmax = [&](int j, float (&corr)[2]) {
      const long long k0 = (long long)j * BN;
      const bool masked = k0 + BN > a.skv || (a.causal && k0 + BN - 1 > q0 + 64 * w);
      online_softmax(s, m, l, corr, masked, k0, r0, t4, a);
    };
    auto to_p = [&]() {
#pragma unroll
      for (int kb = 0; kb < BN / 16; ++kb) {
        p[4 * kb + 0] = pack_bf16(s[8 * kb + 0], s[8 * kb + 1]);
        p[4 * kb + 1] = pack_bf16(s[8 * kb + 2], s[8 * kb + 3]);
        p[4 * kb + 2] = pack_bf16(s[8 * kb + 4], s[8 * kb + 5]);
        p[4 * kb + 3] = pack_bf16(s[8 * kb + 6], s[8 * kb + 7]);
      }
    };
    mbar_wait(q_full, 0);
    consumer_tiles<ST>(
        ntiles, w, lane, Ring{k_full(0), v_full(0), k_empty(0), v_empty(0)}, qk, pv, softmax, to_p,
        [&](const float (&corr)[2]) {
#pragma unroll
          for (int i = 0; i < NO; ++i) o[i] *= corr[(i >> 1) & 1];
        },
        [&]() { fence_regs(s); },
        [&]() {
          fence_regs(o);
          fence_regs(p);
        });

    // epilogue: o = acc / l in bfloat16, lse = (m + log2 l) ln 2
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      const long long row = r0 + 8 * hi;
      const float inv = finish_row(l[hi], m[hi], bh, row, t4, a);
      if (row >= a.sq) continue;
      __nv_bfloat16* orow = static_cast<__nv_bfloat16*>(a.o) + ((long long)bh * a.sq + row) * D;
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
        *reinterpret_cast<__nv_bfloat162*>(orow + n * 8 + 2 * t4) =
            __floats2bfloat162_rn(o[4 * n + 2 * hi] * inv, o[4 * n + 2 * hi + 1] * inv);
    }
  }
}

// ------------------------------------------------------- float32 kernel
constexpr int F_D = 64;                       // head dim of the float32 kernel
constexpr int F_BN = 64;                      // keys of its K/V tile
constexpr uint32_t F_QCHUNK = BM * 128;       // 32 float32 columns (128 bytes) of the Q tile's rows
constexpr uint32_t F_CHUNK = F_BN * 128;      // 32 columns of a K/V tile, or 32 keys of V^T's 64 rows
constexpr uint32_t F_QTILE = 2 * F_QCHUNK;    // 32 KB
constexpr uint32_t F_TILE = 2 * F_CHUNK;      // 16 KB
constexpr uint32_t F_STAGE = 5 * F_TILE;      // K big (landed here), K small, V landed, V^T big, V^T small
constexpr int F_SPLIT_WARPS = 3;              // warps 1-3 of warpgroup 0

// byte offset of element (row, col) of a 128-byte-swizzled float32 tile
// stored as chunks of 32 columns, `chunk` bytes apart
__device__ __forceinline__ uint32_t f32_swz(int row, int col, uint32_t chunk) {
  return (uint32_t)(col >> 5) * chunk + (uint32_t)row * 128u + ((((col & 31) >> 2) ^ (row & 7)) << 4) +
         ((col & 3) << 2);
}

// component c (a constant once unrolled) of v
__device__ __forceinline__ float component(const float4& v, int c) {
  return c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w;
}

template <int ST>
__global__ void __launch_bounds__(NT, 1)
    attn_sm90_f32_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                         const __grid_constant__ CUtensorMap tv, const Args a) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[1 + 6 * ST];

  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;  // swizzled tiles sit on 1024 bytes
  uint8_t* const gbase = smem_raw + (base - smem_u32(smem_raw));  // the same bytes, as a generic pointer
  const uint32_t sQ = base;
  auto stage = [&](int s) { return F_QTILE + (uint32_t)s * F_STAGE; };  // offsets from base
  auto oKb = [&](int s) { return stage(s); };
  auto oKs = [&](int s) { return stage(s) + F_TILE; };
  auto oVr = [&](int s) { return stage(s) + 2 * F_TILE; };
  auto oVb = [&](int s) { return stage(s) + 3 * F_TILE; };
  auto oVs = [&](int s) { return stage(s) + 4 * F_TILE; };
  const uint32_t q_full = smem_u32(&bars[0]);
  auto k_full = [&](int s) { return smem_u32(&bars[1 + s]); };
  auto v_full = [&](int s) { return smem_u32(&bars[1 + ST + s]); };
  auto k_ready = [&](int s) { return smem_u32(&bars[1 + 2 * ST + s]); };
  auto v_ready = [&](int s) { return smem_u32(&bars[1 + 3 * ST + s]); };
  auto k_empty = [&](int s) { return smem_u32(&bars[1 + 4 * ST + s]); };
  auto v_empty = [&](int s) { return smem_u32(&bars[1 + 5 * ST + s]); };

  const int bx = blockIdx.x;
  const int bh = bx % a.BH;
  const int qt = a.n_qt - 1 - bx / a.BH;  // the last query tiles, the heaviest when causal, go first
  const long long q0 = (long long)qt * BM;
  const int b = bh / a.H, h = bh - b * a.H;
  long long kend = a.skv;
  if (a.causal && q0 + BM < kend) kend = q0 + BM;
  const int ntiles = (int)((kend + F_BN - 1) / F_BN);

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(k_ready(s), F_SPLIT_WARPS);  // one arrival from each splitting warp
      mbar_init(v_ready(s), F_SPLIT_WARPS);
      mbar_init(k_empty(s), 8);  // one arrival from each consumer warp
      mbar_init(v_empty(s), 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      // ------------------------------------------------------ TMA thread
      mbar_expect_tx(q_full, F_QTILE);
#pragma unroll
      for (int c = 0; c < 2; ++c) tma_load(sQ + c * F_QCHUNK, &tq, q_full, c * 32, (int)q0, h, b);
      for (int j = 0; j < ntiles; ++j) {
        const int s = j % ST;
        const uint32_t ph = ((j / ST) & 1) ^ 1;  // the first round finds every stage empty
        mbar_wait(k_empty(s), ph);
        mbar_expect_tx(k_full(s), F_TILE);
#pragma unroll
        for (int c = 0; c < 2; ++c) tma_load(base + oKb(s) + c * F_CHUNK, &tk, k_full(s), c * 32, j * F_BN, h, b);
        mbar_wait(v_empty(s), ph);
        mbar_expect_tx(v_full(s), F_TILE);
#pragma unroll
        for (int c = 0; c < 2; ++c) tma_load(base + oVr(s) + c * F_CHUNK, &tv, v_full(s), c * 32, j * F_BN, h, b);
      }
    } else if (threadIdx.x >= 32) {
      // ------------------------------------------- splitting warps (1-3)
      const int tt = threadIdx.x - 32, lane = threadIdx.x & 31;
      constexpr int NSPLIT = 32 * F_SPLIT_WARPS;
      for (int j = 0; j < ntiles; ++j) {
        const int s = j % ST;
        const uint32_t ph = (j / ST) & 1;
        // K: big over the landed tile, small beside it, in the same
        // (K-major, swizzled) places
        mbar_wait(k_full(s), ph);
        float4* kb = reinterpret_cast<float4*>(gbase + oKb(s));
        float4* ks = reinterpret_cast<float4*>(gbase + oKs(s));
        for (int i = tt; i < (int)(F_TILE / 16); i += NSPLIT) {
          const float4 x = kb[i];
          uint4 hi, lo;
          tf32_split(x.x, hi.x, lo.x);
          tf32_split(x.y, hi.y, lo.y);
          tf32_split(x.z, hi.z, lo.z);
          tf32_split(x.w, hi.w, lo.w);
          reinterpret_cast<uint4*>(kb)[i] = hi;
          reinterpret_cast<uint4*>(ks)[i] = lo;
        }
        fence_async_smem();
        __syncwarp();
        if (lane == 0) mbar_arrive(k_ready(s));
        // V^T (row n a column of V, keys contiguous) in 16 x 16 items of 4
        // columns of V (n = 4a .. 4a + 3) by 4 logical keys (4u .. 4u + 3,
        // the physical keys 8 (u / 2) + 2 e + u % 2: the order 0 2 4 6 1 3
        // 5 7 within each group of 8, to match P's registers): four 16-byte
        // reads of V's rows, a 4 x 4 turn in registers, eight 16-byte
        // writes. The 8 lanes of a quarter warp take (a, u) = (t + 8 A,
        // (t + δ) % 8 + 8 U), t = 0 .. 7: their writes hit 8 distinct
        // 16-byte units of the swizzle, their reads two lanes a unit.
        mbar_wait(v_full(s), ph);
        const uint8_t* vr = gbase + oVr(s);
        for (int i = tt; i < 256; i += NSPLIT) {
          const int t = i & 7, j = i >> 3;
          const int a = t + 8 * (j & 1), u = ((t + (j >> 2)) & 7) + 8 * ((j >> 1) & 1);
          float4 x[4];
#pragma unroll
          for (int e = 0; e < 4; ++e)
            x[e] = *reinterpret_cast<const float4*>(vr + f32_swz(8 * (u >> 1) + 2 * e + (u & 1), 4 * a, F_CHUNK));
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            uint4 hi, lo;
            tf32_split(component(x[0], c), hi.x, lo.x);
            tf32_split(component(x[1], c), hi.y, lo.y);
            tf32_split(component(x[2], c), hi.z, lo.z);
            tf32_split(component(x[3], c), hi.w, lo.w);
            const uint32_t off = f32_swz(4 * a + c, 4 * u, F_CHUNK);
            *reinterpret_cast<uint4*>(gbase + oVb(s) + off) = hi;
            *reinterpret_cast<uint4*>(gbase + oVs(s) + off) = lo;
          }
        }
        fence_async_smem();
        __syncwarp();
        if (lane == 0) mbar_arrive(v_ready(s));
      }
    }
  } else {
    // ---------------------------------------------------------- consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int w = (threadIdx.x >> 7) - 1;  // consumer warpgroup 0 or 1
    const int tid = threadIdx.x & 127;
    const int warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t4 = lane & 3;
    const long long r0 = q0 + 64 * w + 16 * warp + g;  // this thread's rows: r0 and r0 + 8

    float s[32], o[32];
    uint32_t qb[32], qs[32], pb[32], ps[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = o[i] = 0.f;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

    // S = Q K_st^T in three passes of 8 steps of 8 along D (32 bytes apart
    // in a 32-column chunk), the small terms first
    auto qk = [&](int st) {
      const uint64_t dkb = desc(base + oKb(st), 16, 1024), dks = desc(base + oKs(st), 16, 1024);
#pragma unroll
      for (int kk = 0; kk < F_D / 8; ++kk)
        wgmma_tf32_n64(s, &qs[4 * kk], dkb + (((kk >> 2) * F_CHUNK + (kk & 3) * 32u) >> 4), kk > 0);
#pragma unroll
      for (int kk = 0; kk < F_D / 8; ++kk)
        wgmma_tf32_n64(s, &qb[4 * kk], dks + (((kk >> 2) * F_CHUNK + (kk & 3) * 32u) >> 4), 1);
#pragma unroll
      for (int kk = 0; kk < F_D / 8; ++kk)
        wgmma_tf32_n64(s, &qb[4 * kk], dkb + (((kk >> 2) * F_CHUNK + (kk & 3) * 32u) >> 4), 1);
    };
    // O += P V_st in three passes of 8 steps of 8 keys along V^T's rows
    auto pv = [&](int st) {
      const uint64_t dvb = desc(base + oVb(st), 16, 1024), dvs = desc(base + oVs(st), 16, 1024);
#pragma unroll
      for (int kb = 0; kb < F_BN / 8; ++kb)
        wgmma_tf32_n64(o, &ps[4 * kb], dvb + (((kb >> 2) * F_CHUNK + (kb & 3) * 32u) >> 4), 1);
#pragma unroll
      for (int kb = 0; kb < F_BN / 8; ++kb)
        wgmma_tf32_n64(o, &pb[4 * kb], dvs + (((kb >> 2) * F_CHUNK + (kb & 3) * 32u) >> 4), 1);
#pragma unroll
      for (int kb = 0; kb < F_BN / 8; ++kb)
        wgmma_tf32_n64(o, &pb[4 * kb], dvb + (((kb >> 2) * F_CHUNK + (kb & 3) * 32u) >> 4), 1);
    };
    auto softmax = [&](int j, float (&corr)[2]) {
      const long long k0 = (long long)j * F_BN;
      const bool masked = k0 + F_BN > a.skv || (a.causal && k0 + F_BN - 1 > q0 + 64 * w);
      online_softmax(s, m, l, corr, masked, k0, r0, t4, a);
    };
    // P's TF32 A fragments of step kb: rows g and g + 8, logical columns
    // t4 and t4 + 4, which hold the keys 2 t4 and 2 t4 + 1 of the group
    auto to_p = [&]() {
#pragma unroll
      for (int kb = 0; kb < F_BN / 8; ++kb) {
        tf32_split(s[4 * kb + 0], pb[4 * kb + 0], ps[4 * kb + 0]);
        tf32_split(s[4 * kb + 2], pb[4 * kb + 1], ps[4 * kb + 1]);
        tf32_split(s[4 * kb + 1], pb[4 * kb + 2], ps[4 * kb + 2]);
        tf32_split(s[4 * kb + 3], pb[4 * kb + 3], ps[4 * kb + 3]);
      }
    };
    // Q's halves as TF32 A fragments: step kk holds rows g, g + 8 and
    // columns 8 kk + t4, 8 kk + t4 + 4 of this warp's 16 rows
    mbar_wait(q_full, 0);
#pragma unroll
    for (int kk = 0; kk < F_D / 8; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = 64 * w + 16 * warp + g + 8 * (e & 1), col = 8 * kk + t4 + 4 * (e >> 1);
        tf32_split(*reinterpret_cast<const float*>(gbase + f32_swz(row, col, F_QCHUNK)), qb[4 * kk + e],
                   qs[4 * kk + e]);
      }
    consumer_tiles<ST>(
        ntiles, w, lane, Ring{k_ready(0), v_ready(0), k_empty(0), v_empty(0)}, qk, pv, softmax, to_p,
        [&](const float (&corr)[2]) {
#pragma unroll
          for (int i = 0; i < 32; ++i) o[i] *= corr[(i >> 1) & 1];
        },
        [&]() {
          fence_regs(s);
          fence_regs(qb);
          fence_regs(qs);
        },
        [&]() {
          fence_regs(o);
          fence_regs(pb);
          fence_regs(ps);
        });

    // epilogue: o = acc / l in float32, lse = (m + log2 l) ln 2
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      const long long row = r0 + 8 * hi;
      const float inv = finish_row(l[hi], m[hi], bh, row, t4, a);
      if (row >= a.sq) continue;
      float* orow = static_cast<float*>(a.o) + ((long long)bh * a.sq + row) * F_D;
#pragma unroll
      for (int n = 0; n < F_D / 8; ++n)
        *reinterpret_cast<float2*>(orow + n * 8 + 2 * t4) =
            make_float2(o[4 * n + 2 * hi] * inv, o[4 * n + 2 * hi + 1] * inv);
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

// A 4-D tensor map over (D, S, H, B) in the operand's own element strides
// (cuTensorMapEncodeTiled takes them unsorted, and 0 along an extent of 1)
// with a box of 128 bytes (64 bfloat16 or 32 float32 columns) x `rows`
// rows, 128-byte swizzle, zero fill out of bounds.
int encode(CUtensorMap* map, const void* ptr, long long s_b, long long s_h, long long s_r, long long B, long long H,
           long long S, int d, int rows, bool f32) {
  const long long es = f32 ? 4 : 2;
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)S, (cuuint64_t)H, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)(s_r * es), (cuuint64_t)(s_h * es), (cuuint64_t)(s_b * es)};
  const cuuint32_t box[4] = {(cuuint32_t)(128 / es), (cuuint32_t)rows, 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  PFN_cuTensorMapEncodeTiled_v12000 fn = encode_fn();
  if (fn == nullptr) return ERR_ENCODE;
  const CUresult r = fn(map, f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                        const_cast<void*>(ptr), dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : ERR_ENCODE + (int)r;
}

template <typename Kernel>
int launch(Kernel kernel, size_t smem, const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv,
           const Args& a, long long blocks, cudaStream_t s) {
  const cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<(unsigned)blocks, NT, smem, s>>>(tq, tk, tv, a);
  return (int)cudaGetLastError();
}

// dynamic shared memory of the bfloat16 kernel: Q, then ST stages of K and V
template <int D, int ST>
constexpr size_t bf16_smem() {
  return (size_t)(D / 64) * 128 * (BM + 2 * ST * kv_tile<D>()) + 1024;
}

}  // namespace

extern "C" {

// o (B*H, S_q, D) and lse (B*H, S_q) float32 of attention over q, k, v
// with D = D_v, in bfloat16 (f32 = 0; D in {64, 128, 256}) or float32
// (f32 = 1; D = 64), o in the input dtype. Each operand is read at base +
// b * s_b + h * s_h + row * s_row (in elements; 0 along an extent of 1)
// with a contiguous last dim; bases and strides on 16 bytes. Returns 0,
// the CUDA error code of the launch, or 100000 + the CUresult of a refused
// tensor map (100000 alone: cuTensorMapEncodeTiled was not found).
int heat_flash_attention_sm90(const void* q, const void* k, const void* v, void* o, float* lse, long long qb,
                              long long qh, long long qs, long long kb, long long kh, long long ks, long long vb,
                              long long vh, long long vs, int B, int H, long long sq, long long skv, int d,
                              float scale, int causal, int f32, int device, void* stream) {
  const bool ok_d = f32 ? d == F_D : (d == 64 || d == 128 || d == 256);
  if (B < 1 || H < 1 || (long long)B * H > 0x7fffffffLL || sq < 1 || skv < 1 || sq > 0x7fffffffLL ||
      skv > 0x7fffffffLL || !ok_d)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  CUtensorMap tq, tk, tv;
  Args a{o, lse, H, B * H, 0, sq, skv, scale * 1.4426950408889634f, causal};
  const int bn = f32 ? F_BN : d == 256 ? kv_tile<256>() : kv_tile<128>();
  int rc = encode(&tq, q, qb, qh, qs, B, H, sq, d, BM, f32);
  if (rc == 0) rc = encode(&tk, k, kb, kh, ks, B, H, skv, d, bn, f32);
  if (rc == 0) rc = encode(&tv, v, vb, vh, vs, B, H, skv, d, bn, f32);
  if (rc != 0) return rc;
  const long long n_qt = (sq + BM - 1) / BM;
  a.n_qt = (int)n_qt;
  const long long blocks = n_qt * a.BH;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (f32) return launch(attn_sm90_f32_kernel<2>, F_QTILE + 2 * F_STAGE + 1024, tq, tk, tv, a, blocks, s);
  if (d == 256) return launch(attn_sm90_kernel<256, 2>, bf16_smem<256, 2>(), tq, tk, tv, a, blocks, s);
  if (d == 128) return launch(attn_sm90_kernel<128, 2>, bf16_smem<128, 2>(), tq, tk, tv, a, blocks, s);
  return launch(attn_sm90_kernel<64, 3>, bf16_smem<64, 3>(), tq, tk, tv, a, blocks, s);
}

const char* heat_attention_sm90_error_string(int code) {
  if (code >= ERR_ENCODE) return "cuTensorMapEncodeTiled refused the tensor map (or was not found)";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
