// Hand-written Hopper (sm_90a) kernel K9: the forward of exact softmax
// attention with its log-sum-exp residual.
//
// flash_attention (K9)  for each (batch, head) pair and query row i:
//     o[i, :] = sum_j softmax_j(scale * q[i, :] . k[j, :]) v[j, :]
//     lse[i]  = log sum_j exp(scale * q[i, :] . k[j, :])
//   over the valid keys j (all of them, or j <= i when causal: the mask is
//   top-left aligned, also when S_q != S_kv). q (B, H, S_q, D), k (B, H,
//   S_kv, D), v (B, H, S_kv, D_v) are read through (batch, head, row)
//   strides with a contiguous last dim, so the heads of a packed projection
//   need no copy; o (B*H, S_q, D_v) is written in the input dtype, lse
//   (B*H, S_q) in float32. A row with no valid key gets o = 0 and
//   lse = -inf. 1 <= D, D_v <= 256, any S_q, S_kv >= 1; the ragged edges
//   are masked here, not padded by the caller.
//   Which shapes reach it: attention_sm90.cu (TMA and wgmma) serves
//   bfloat16 at D = D_v in {64, 128, 256} and float32 at D = D_v = 64
//   (3xTF32) whenever bases and strides lie on 16 bytes, which covers the
//   main path (RA in both dtypes, RAB, MHA-1024, heads of 256). This file
//   serves every other shape: bfloat16 at other head dims, D != D_v or a
//   misaligned view; float32 at D != 64 (D = 128 does not fit the Hopper
//   kernel's registers and shared memory), D != D_v or a misaligned view.
//   Replaces the TPU kernels heat_tpu/nn/attention.py calls: JAX's Pallas
//   flash kernel for float32 (_pallas_attention_program, :637) and its
//   splash kernel for bfloat16 (_build_splash_mha, :537), both also in
//   their save-residuals form (_ring_step_kernels, :250).
//
// What bounds it on an H100 SXM: 4 * B*H * S_q * S_kv * D operations
// (D = D_v; halved for causal when S_q == S_kv) against reading q, k, v
// and writing o once. At (4, 8, 4096, 64) causal that is 6.9e10 operations
// against 67 MB, so operations bound it: float32 at 67 TFLOP/s on the CUDA
// cores (1.03 ms), bfloat16 at 989 TFLOP/s on the tensor cores (0.07 ms).
// The exp of every score (S_q * S_kv / 2 per head) also runs on the SFU,
// at 16 a clock an SM, a floor of its own of about a quarter of the bf16
// tensor-core time.
//
// Design (one block of 128 threads per (batch, head) and tile of query
// rows; heavier causal tiles first):
// * The TPU kernels walk a sequential grid over K/V blocks and carry the
//   running max m, sum l and accumulator in VMEM scratch. Here the block
//   loops over K/V tiles of 64 keys staged in shared memory and keeps m,
//   l and its rows of o in registers (the online softmax of heat_tpu's
//   _online_softmax_update): per tile, scores, the new max, the rescale
//   of l and o by exp(m_old - m_new), then o += p v. Causal tiles wholly
//   above the diagonal are never loaded; tiles on it are masked per
//   element. Each block owns its output rows: no atomics, a rerun repeats
//   the bits.
// * float32: FP32 FMAs on the CUDA cores, no TF32 (heat_tpu routes
//   float32 to flash to keep it exact), natural exp. 64 query rows a
//   block (32 when D_v > 128); thread (ty, tx) holds 4 rows x 8 keys of
//   the score tile (keys tx + 8i, so that float4 reads of the K rows hit
//   distinct banks: the K/Q row stride is 4 mod 32 floats) and 4 rows x
//   D_v/8 columns of o. p goes through shared memory for the second
//   product. About 10 FMAs per 16-byte shared load.
// * bfloat16: warp-level mma.sync.m16n8k16 (bf16 x bf16 -> f32), 64 query
//   rows a block, 16 a warp. Scores, max, sum and o stay in float32; the
//   scale is applied to the float32 scores (splash pre-scales q in bf16
//   instead); p is rounded to bf16 for the second product, as splash
//   does, and reused from the score registers as the A operand; v's B
//   fragments come from ldmatrix.trans. Row strides in shared memory are
//   an odd multiple of 16 bytes, so the fragment loads hit distinct banks.
// * No cp.async/TMA pipeline, wgmma, warp specialisation or persistent
//   grid: loads and products of one block do not overlap (other resident
//   blocks hide some of it). Those are later work.
// * Shared memory: up to 183 KB at D = 256 float32, set as dynamic shared
//   memory with cudaFuncSetAttribute above 48 KB.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NT = 128;  // threads of a block
constexpr int BK = 64;   // keys of a K/V tile

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;
  long long qb, qh, qs, kb, kh, ks, vb, vh, vs;  // (batch, head, row) strides in elements
  int H, BH, n_qt;
  long long sq, skv;
  int d, dv;
  float scale;
  int causal, vq, vk, vv;
};

// dst[r * ld + c] = src[r * stride + c] for r < nrows and c < ncols, zero
// elsewhere in rows [0, rows) and columns [0, width). With vec, 16-byte
// loads: the caller guarantees aligned rows, ncols and width whole units.
template <typename T>
__device__ __forceinline__ void load_rows(T* __restrict__ dst, int ld, int width, const T* __restrict__ src,
                                          long long stride, int rows, long long nrows, int ncols, bool vec) {
  constexpr int V = 16 / sizeof(T);
  if (vec) {
    const int units = width / V;
    for (int i = threadIdx.x; i < rows * units; i += NT) {
      const int r = i / units, c = (i - r * units) * V;
      uint4 x = make_uint4(0u, 0u, 0u, 0u);
      if (r < nrows && c < ncols) x = __ldg(reinterpret_cast<const uint4*>(src + r * stride + c));
      *reinterpret_cast<uint4*>(dst + r * ld + c) = x;
    }
  } else {
    for (int i = threadIdx.x; i < rows * width; i += NT) {
      const int r = i / width, c = i - r * width;
      T x = T(0);
      if (r < nrows && c < ncols) x = src[r * stride + c];
      dst[r * ld + c] = x;
    }
  }
}

// this block's (batch, head) pair and first query row
__device__ __forceinline__ void block_tile(const Args& a, int bq, int& bh, long long& q0) {
  const int bx = blockIdx.x;
  bh = bx % a.BH;
  const int qt = a.n_qt - 1 - bx / a.BH;  // the last query tiles, the heaviest when causal, go first
  q0 = (long long)qt * bq;
}

// number of K/V tiles the rows [q0, q0 + bq) need
__device__ __forceinline__ int tiles_needed(const Args& a, long long q0, int bq) {
  long long kend = a.skv;
  if (a.causal && q0 + bq < kend) kend = q0 + bq;
  return (int)((kend + BK - 1) / BK);
}

// ------------------------------------------------------------------ float32
template <int RQ, int DVC>
__global__ void __launch_bounds__(NT) attn_f32_kernel(Args a) {
  constexpr int BQ = 16 * RQ;
  constexpr int LDP = BK + 4;
  constexpr int NC = DVC / 32;  // float4 columns of o a thread holds per row
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  const int d4 = (a.d + 3) & ~3;
  const int ldk = ((d4 + 31) & ~31) + 4;  // 4 mod 32 floats: conflict-free float4 reads of K rows tx + 8i
  float* Ks = Qs + BQ * ldk;
  float* Vs = Ks + BK * ldk;
  float* Ps = Vs + BK * DVC;

  int bh;
  long long q0;
  block_tile(a, BQ, bh, q0);
  const int b = bh / a.H, h = bh - b * a.H;
  const float* qp = static_cast<const float*>(a.q) + b * a.qb + h * a.qh + q0 * a.qs;
  const float* kp = static_cast<const float*>(a.k) + b * a.kb + h * a.kh;
  const float* vp = static_cast<const float*>(a.v) + b * a.vb + h * a.vh;
  const int tx = threadIdx.x & 7, ty = threadIdx.x >> 3;

  load_rows(Qs, ldk, d4, qp, a.qs, BQ, a.sq - q0, a.d, a.vq);  // made visible by the first tile's barrier

  float acc[RQ][NC * 4];
  float m[RQ], l[RQ];
#pragma unroll
  for (int r = 0; r < RQ; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < NC * 4; ++c) acc[r][c] = 0.f;
  }

  const int ntiles = tiles_needed(a, q0, BQ);
  for (int t = 0; t < ntiles; ++t) {
    const long long k0 = (long long)t * BK;
    __syncthreads();  // the previous tile's reads of Ks, Vs and Ps are done
    load_rows(Ks, ldk, d4, kp + k0 * a.ks, a.ks, BK, a.skv - k0, a.d, a.vk);
    load_rows(Vs, DVC, DVC, vp + k0 * a.vs, a.vs, BK, a.skv - k0, a.dv, a.vv);
    __syncthreads();

    float s[RQ][8];
#pragma unroll
    for (int r = 0; r < RQ; ++r)
#pragma unroll
      for (int i = 0; i < 8; ++i) s[r][i] = 0.f;
    for (int dd = 0; dd < d4; dd += 4) {
      float4 qv[RQ];
#pragma unroll
      for (int r = 0; r < RQ; ++r) qv[r] = *reinterpret_cast<const float4*>(Qs + (ty * RQ + r) * ldk + dd);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float4 kv = *reinterpret_cast<const float4*>(Ks + (tx + 8 * i) * ldk + dd);
#pragma unroll
        for (int r = 0; r < RQ; ++r) {
          s[r][i] = fmaf(qv[r].x, kv.x, s[r][i]);
          s[r][i] = fmaf(qv[r].y, kv.y, s[r][i]);
          s[r][i] = fmaf(qv[r].z, kv.z, s[r][i]);
          s[r][i] = fmaf(qv[r].w, kv.w, s[r][i]);
        }
      }
    }

    const bool masked = k0 + BK > a.skv || (a.causal && k0 + BK - 1 > q0);
#pragma unroll
    for (int r = 0; r < RQ; ++r) {
      const long long qi = q0 + ty * RQ + r;
      float mx = -INFINITY;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const long long j = k0 + tx + 8 * i;
        float x = s[r][i] * a.scale;
        if (masked && (j >= a.skv || (a.causal && j > qi))) x = -INFINITY;
        s[r][i] = x;
        mx = fmaxf(mx, x);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const float m_new = fmaxf(m[r], mx);
      const float m_use = m_new == -INFINITY ? 0.f : m_new;  // no valid key in the row yet
      const float corr = expf(m[r] - m_use);
      float sum = 0.f;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float p = expf(s[r][i] - m_use);
        s[r][i] = p;
        sum += p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      sum += __shfl_xor_sync(0xffffffffu, sum, 4);
      l[r] = l[r] * corr + sum;
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < NC * 4; ++c) acc[r][c] *= corr;
#pragma unroll
      for (int i = 0; i < 8; ++i) Ps[(ty * RQ + r) * LDP + tx + 8 * i] = s[r][i];
    }
    __syncthreads();

    for (int j = 0; j < BK; j += 4) {
      float4 p4[RQ];
#pragma unroll
      for (int r = 0; r < RQ; ++r) p4[r] = *reinterpret_cast<const float4*>(Ps + (ty * RQ + r) * LDP + j);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const float4 vv = *reinterpret_cast<const float4*>(Vs + (j + jj) * DVC + c * 32 + tx * 4);
#pragma unroll
          for (int r = 0; r < RQ; ++r) {
            const float p = jj == 0 ? p4[r].x : jj == 1 ? p4[r].y : jj == 2 ? p4[r].z : p4[r].w;
            acc[r][c * 4 + 0] = fmaf(p, vv.x, acc[r][c * 4 + 0]);
            acc[r][c * 4 + 1] = fmaf(p, vv.y, acc[r][c * 4 + 1]);
            acc[r][c * 4 + 2] = fmaf(p, vv.z, acc[r][c * 4 + 2]);
            acc[r][c * 4 + 3] = fmaf(p, vv.w, acc[r][c * 4 + 3]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < RQ; ++r) {
    const long long row = q0 + ty * RQ + r;
    if (row >= a.sq) continue;
    const bool live = l[r] > 0.f;
    float* orow = static_cast<float*>(a.o) + ((long long)bh * a.sq + row) * a.dv;
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = c * 32 + tx * 4 + e;
        if (col < a.dv) orow[col] = live ? acc[r][c * 4 + e] / l[r] : 0.f;
      }
    if (tx == 0) a.lse[(long long)bh * a.sq + row] = live ? m[r] + logf(l[r]) : -INFINITY;
  }
}

// ----------------------------------------------------------------- bfloat16
__device__ __forceinline__ uint32_t lds32(const uint16_t* p) { return *reinterpret_cast<const uint32_t*>(p); }

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (the lower index) in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void mma_bf16(float* c, uint32_t a0, uint32_t a1, uint32_t a2, uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
      "{%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t& r0, uint32_t& r1, uint32_t& r2, uint32_t& r3,
                                                  const uint16_t* p) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(addr));
}

template <int DVT>
__global__ void __launch_bounds__(NT) attn_bf16_kernel(Args a) {
  constexpr int BQ = 64;       // 4 warps x 16 rows
  constexpr int NB = DVT / 8;  // 8-column blocks of o
  constexpr int LDV = DVT + 8;
  extern __shared__ float4 smem4[];
  uint16_t* Qs = reinterpret_cast<uint16_t*>(smem4);
  const int d16 = (a.d + 15) & ~15;
  const int ldk = d16 + 8;  // an odd multiple of 16 bytes: conflict-free fragment loads
  uint16_t* Ks = Qs + BQ * ldk;
  uint16_t* Vs = Ks + BK * ldk;

  int bh;
  long long q0;
  block_tile(a, BQ, bh, q0);
  const int b = bh / a.H, h = bh - b * a.H;
  const uint16_t* qp = static_cast<const uint16_t*>(a.q) + b * a.qb + h * a.qh + q0 * a.qs;
  const uint16_t* kp = static_cast<const uint16_t*>(a.k) + b * a.kb + h * a.kh;
  const uint16_t* vp = static_cast<const uint16_t*>(a.v) + b * a.vb + h * a.vh;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int wr = warp * 16;  // the warp's first row in the tile

  load_rows(Qs, ldk, d16, qp, a.qs, BQ, a.sq - q0, a.d, a.vq);

  const float sl2 = a.scale * 1.4426950408889634f;  // scores in log2 units: exp2 on the SFU
  float oacc[NB][4];
#pragma unroll
  for (int n = 0; n < NB; ++n) oacc[n][0] = oacc[n][1] = oacc[n][2] = oacc[n][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  const int ntiles = tiles_needed(a, q0, BQ);
  for (int t = 0; t < ntiles; ++t) {
    const long long k0 = (long long)t * BK;
    __syncthreads();
    load_rows(Ks, ldk, d16, kp + k0 * a.ks, a.ks, BK, a.skv - k0, a.d, a.vk);
    load_rows(Vs, LDV, DVT, vp + k0 * a.vs, a.vs, BK, a.skv - k0, a.dv, a.vv);
    __syncthreads();

    // S (16 x 64 a warp) = Q K^T: row g / g + 8, keys nb * 8 + 2 t4 + {0, 1}
    float s[8][4];
#pragma unroll
    for (int nb = 0; nb < 8; ++nb) s[nb][0] = s[nb][1] = s[nb][2] = s[nb][3] = 0.f;
    for (int kk = 0; kk < d16; kk += 16) {
      const uint16_t* q_lo = Qs + (wr + g) * ldk + kk + 2 * t4;
      const uint16_t* q_hi = q_lo + 8 * ldk;
      const uint32_t a0 = lds32(q_lo), a1 = lds32(q_hi), a2 = lds32(q_lo + 8), a3 = lds32(q_hi + 8);
#pragma unroll
      for (int nb = 0; nb < 8; ++nb) {
        const uint16_t* kr = Ks + (nb * 8 + g) * ldk + kk + 2 * t4;
        mma_bf16(s[nb], a0, a1, a2, a3, lds32(kr), lds32(kr + 8));
      }
    }

    const bool masked = k0 + BK > a.skv || (a.causal && k0 + BK - 1 > q0 + wr);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nb = 0; nb < 8; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hi = e >> 1;
        float x = s[nb][e] * sl2;
        if (masked) {
          const long long j = k0 + nb * 8 + 2 * t4 + (e & 1);
          const long long qi = q0 + wr + g + 8 * hi;
          if (j >= a.skv || (a.causal && j > qi)) x = -INFINITY;
        }
        s[nb][e] = x;
        mx[hi] = fmaxf(mx[hi], x);
      }
    float corr[2];
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      mx[hi] = fmaxf(mx[hi], __shfl_xor_sync(0xffffffffu, mx[hi], 1));
      mx[hi] = fmaxf(mx[hi], __shfl_xor_sync(0xffffffffu, mx[hi], 2));
      const float m_new = fmaxf(m[hi], mx[hi]);
      mx[hi] = m_new == -INFINITY ? 0.f : m_new;  // the shift used: 0 while the row has no valid key
      corr[hi] = exp2f(m[hi] - mx[hi]);
      m[hi] = m_new;
    }
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int nb = 0; nb < 8; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(s[nb][e] - mx[e >> 1]);
        s[nb][e] = p;
        sum[e >> 1] += p;
      }
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      sum[hi] += __shfl_xor_sync(0xffffffffu, sum[hi], 1);
      sum[hi] += __shfl_xor_sync(0xffffffffu, sum[hi], 2);
      l[hi] = l[hi] * corr[hi] + sum[hi];
    }
#pragma unroll
    for (int n = 0; n < NB; ++n) {
      oacc[n][0] *= corr[0];
      oacc[n][1] *= corr[0];
      oacc[n][2] *= corr[1];
      oacc[n][3] *= corr[1];
    }

    // O += P V: P (bf16) from the score registers as the A operand, 16 keys a step
    const int mi = lane >> 3, rr = lane & 7;
#pragma unroll
    for (int kb = 0; kb < 4; ++kb) {
      const uint32_t a0 = pack_bf16(s[2 * kb][0], s[2 * kb][1]);
      const uint32_t a1 = pack_bf16(s[2 * kb][2], s[2 * kb][3]);
      const uint32_t a2 = pack_bf16(s[2 * kb + 1][0], s[2 * kb + 1][1]);
      const uint32_t a3 = pack_bf16(s[2 * kb + 1][2], s[2 * kb + 1][3]);
      const uint16_t* vrow = Vs + (kb * 16 + (mi & 1) * 8 + rr) * LDV + (mi >> 1) * 8;
#pragma unroll
      for (int np = 0; np < NB / 2; ++np) {
        uint32_t b0, b1, b2, b3;
        ldmatrix_x4_trans(b0, b1, b2, b3, vrow + np * 16);
        mma_bf16(oacc[2 * np], a0, a1, a2, a3, b0, b1);
        mma_bf16(oacc[2 * np + 1], a0, a1, a2, a3, b2, b3);
      }
    }
  }

#pragma unroll
  for (int hi = 0; hi < 2; ++hi) {
    const long long row = q0 + wr + g + 8 * hi;
    if (row >= a.sq) continue;
    const bool live = l[hi] > 0.f;
    const float inv = live ? 1.f / l[hi] : 0.f;
    __nv_bfloat16* orow = static_cast<__nv_bfloat16*>(a.o) + ((long long)bh * a.sq + row) * a.dv;
#pragma unroll
    for (int n = 0; n < NB; ++n) {
      const int col = n * 8 + 2 * t4;
      const float x0 = oacc[n][2 * hi] * inv, x1 = oacc[n][2 * hi + 1] * inv;
      if (col + 1 < a.dv && (a.dv & 1) == 0) {
        *reinterpret_cast<__nv_bfloat162*>(orow + col) = __floats2bfloat162_rn(x0, x1);
      } else {
        if (col < a.dv) orow[col] = __float2bfloat16_rn(x0);
        if (col + 1 < a.dv) orow[col + 1] = __float2bfloat16_rn(x1);
      }
    }
    if (t4 == 0) a.lse[(long long)bh * a.sq + row] = live ? (m[hi] + log2f(l[hi])) * 0.6931471805599453f : -INFINITY;
  }
}

template <typename Kernel>
int launch(Kernel kernel, size_t smem, long long blocks, const Args& a, cudaStream_t s) {
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<(unsigned)blocks, NT, smem, s>>>(a);
  return (int)cudaGetLastError();
}

int padded_dv(int dv) { return dv <= 32 ? 32 : dv <= 64 ? 64 : dv <= 128 ? 128 : 256; }

}  // namespace

extern "C" {

// o (B*H, S_q, D_v) and lse (B*H, S_q) float32 of attention over q, k, v
// (float32, or bfloat16 when bf16 != 0), each read at base + b * s_b +
// h * s_h + row * s_row (in elements) with a contiguous last dim. vq, vk,
// vv: every row of that operand starts on 16 bytes and holds whole 16-byte
// units. Returns 0 or the CUDA error code of the launch.
int heat_flash_attention(const void* q, const void* k, const void* v, void* o, float* lse, long long qb,
                         long long qh, long long qs, long long kb, long long kh, long long ks, long long vb,
                         long long vh, long long vs, int B, int H, long long sq, long long skv, int d, int dv,
                         float scale, int causal, int bf16, int vq, int vk, int vv, int device, void* stream) {
  if (B < 1 || H < 1 || (long long)B * H > 0x7fffffffLL || sq < 1 || skv < 1 || d < 1 || d > 256 || dv < 1 ||
      dv > 256)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  Args a{q, k, v, o, lse, qb, qh, qs, kb, kh, ks, vb, vh, vs, H, B * H, 0, sq, skv, d, dv, scale, causal,
         vq, vk, vv};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int dvp = padded_dv(dv);
  if (bf16) {
    const int ldk = ((d + 15) & ~15) + 8;
    const size_t smem = (size_t)2 * (64 * ldk + BK * ldk + BK * (dvp + 8));
    const long long n_qt = (sq + 63) / 64;
    if (n_qt > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    a.n_qt = (int)n_qt;
    const long long blocks = n_qt * a.BH;
    if (dvp == 32) return launch(attn_bf16_kernel<32>, smem, blocks, a, s);
    if (dvp == 64) return launch(attn_bf16_kernel<64>, smem, blocks, a, s);
    if (dvp == 128) return launch(attn_bf16_kernel<128>, smem, blocks, a, s);
    return launch(attn_bf16_kernel<256>, smem, blocks, a, s);
  }
  const int ldk = ((((d + 3) & ~3) + 31) & ~31) + 4;
  const int bq = dvp == 256 ? 32 : 64;
  const size_t smem = (size_t)4 * (bq * ldk + BK * ldk + BK * dvp + bq * (BK + 4));
  const long long n_qt = (sq + bq - 1) / bq;
  if (n_qt > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  a.n_qt = (int)n_qt;
  const long long blocks = n_qt * a.BH;
  if (dvp == 32) return launch(attn_f32_kernel<4, 32>, smem, blocks, a, s);
  if (dvp == 64) return launch(attn_f32_kernel<4, 64>, smem, blocks, a, s);
  if (dvp == 128) return launch(attn_f32_kernel<4, 128>, smem, blocks, a, s);
  return launch(attn_f32_kernel<2, 256>, smem, blocks, a, s);
}

const char* heat_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
