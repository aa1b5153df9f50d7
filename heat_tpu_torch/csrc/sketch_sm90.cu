// Hand-written Hopper (sm_90a) kernel of K2, the one-view dual sketch, on
// the tensor cores in 3xTF32: w = g @ A, y = A @ omega and ||A||_F^2 from one
// read of A. Replaces heat_tpu/core/linalg/_pallas_sketch.py::_dual_call
// (:105). Shapes: A (m, n) row-major float32, g (L, m), omega (n, K), w (L,
// n), y (m, K). It serves L <= 64, K <= 32 and n % 4 == 0 with A on 16
// bytes (TMA's rule); every other signature keeps sketch.cu's kernel
// (sketch_kernel<L, true>). K1 stays on sketch.cu.
//
// What bounds it on an H100 SXM. A is read once: 4 m n bytes, 0.641 ms at
// the main-path shape (m = 65536, n = 8192: 2.1 GB at 3.35 TB/s). The work
// is 2 (L + K) operations an element of A (L = 59, K = 24: 89 GFLOP), 1.35
// ms on the CUDA cores' 67 TFLOP/s, which is what bounds sketch.cu's FP32
// kernel; as 3xTF32 on the tensor cores it is 3 x 89 GFLOP / 495 TFLOP/s =
// 0.54 ms, under the read of A. Beside A the kernel moves its partials: w's
// (splits x L x n floats: 15.5 MB at 8 row splits), y's (ceil(n / 512) x m x
// K: 100 MB, written and read back once by the fixed-order sum, where
// sketch.cu's 256-column blocks move 201 MB), and g's and omega's TF32
// halves (33.5 MB and 1.5 MB, written once; read by every block from L2).
//
// Design (one block of three warpgroups a tile of 512 columns x a range of
// rows; grid (ceil(n / 512), row splits), one block an SM):
// * Warpgroup 0 gives its registers away (setmaxnreg.dec) and one of its
//   threads issues TMA loads: A in stages of 64 rows x 64 columns for each
//   consumer warpgroup (two boxes of 32 columns, 128-byte swizzle, zero fill
//   past m and n) with omega's halves for those 64 columns, through a ring
//   of ST stages; g's halves a band of 64 rows at a time, through two slots.
// * Warpgroups 1 and 2 are consumers (setmaxnreg.inc), 256 columns each, in
//   four sub-blocks of 64 columns; a band of 64 rows is four stages.
// * The row sketch is w^T = A^T g^T: M = a sub-block's 64 columns, N = L
//   rounded up to 64 (rows past L are zero), K = the band's rows. A^T's
//   fragments are read from the swizzled tile in shared memory into
//   registers and split there (TF32 wgmma takes A from registers in any
//   layout, but from shared memory only K-major, which A^T is not). B =
//   g^T is K-major as g lies, so g's halves come by TMA. Each band's
//   product starts a fresh accumulator (24 TF32 products), added then to
//   w^T's float32 sum in registers (4 sub-blocks x 32 = 128 a thread): the
//   tensor cores' own accumulation, run over a split's thousands of rows,
//   drifted past TOL_W at the main shape.
// * The column sketch is y = A omega: M = the band's 64 rows, N = K rounded
//   up to 24 or 32, K = the sub-block's columns; the fragments come from the
//   same tile (other elements a thread: each is read twice from shared
//   memory, once for each product), B = omega^T's halves, K-major, made by
//   a first small launch that also splits g (n rounded up to 8 columns). Taking A from registers is
//   what spares this kernel the split warps of attention_sm90.cu's float32
//   kernel, which had to turn a shared-memory operand.
// * Products run KS steps of 8 at a time on two register buffers, so the
//   loads and splits of the next steps run under the products of the last
//   (wgmma.wait_group 1). A thread's fragment holds M indices g and g + 8
//   and K indices t and t + 4 (g = lane / 4, t = lane % 4); both products
//   are sums, so the row sketch maps M index 16 warp + g + 8 e to column
//   16 warp + 2 g + e, and the column sketch K index 8 kk + t + 4 e to
//   column 8 kk + 2 t + e (omega^T's halves are written in that order):
//   each pair a thread needs is two adjacent floats, one 8-byte load. The
//   addresses are 6 per-thread bases plus constants (the swizzle is affine
//   in the step except within a 32-column chunk).
// * y of a band: each consumer warpgroup sums its 256 columns in registers;
//   warpgroup 1 hands its sum to warpgroup 0 through shared memory (named
//   barriers), which adds it second and writes the block's partial. So y
//   has one partial a 512 columns.
// * ||A||^2 is summed from the row sketch's fragments (each element once),
//   in FP32 over a stage and FP64 across stages; a block's sum goes to a
//   partial in a fixed order.
// * Precision, 3xTF32: x = big + small, both rounded to TF32, each product
//   three TF32 products into one float32 accumulator, the small terms
//   first (A_s B_b + A_b B_s + A_b B_b). One TF32 pass leaves about 5e-4
//   relative error, over TOL_W = 1e-5.
// * The partials are summed in a fixed order (sketch_sums.cuh): a rerun
//   repeats the bits.

#include "sketch_sums.cuh"
#include "sm90_common.cuh"

namespace {

using namespace sm90;

constexpr int BAND = 64;                   // rows of a band
constexpr int SUB = 64;                    // columns of a sub-block
constexpr int NSUB = 4;                    // sub-blocks of a consumer warpgroup
constexpr int CB = 2 * NSUB * SUB;         // columns of a block: 512
constexpr int LN = 64;                     // row sketch N: L rounded up
constexpr int NT = 384;                    // producer warpgroup + two consumer warpgroups
constexpr int ST = 2;                      // stages of the ring
constexpr int KS = 1;                      // steps of 8 along K a consumer loads and splits at once
constexpr uint32_t A_CHUNK = BAND * 128;   // 32 columns of a 64 x 64 tile: 8 KB
constexpr uint32_t A_TILE = 2 * A_CHUNK;   // 16 KB
constexpr uint32_t G_HALF = 2 * LN * 128;  // one half of g over a band: 64 x 64, 16 KB
constexpr uint32_t G_SLOT = 2 * G_HALF;    // 32 KB

template <int KN>
struct Layout {
  static constexpr uint32_t O_CHUNK = KN * 128;            // 32 columns of omega^T's KN rows
  static constexpr uint32_t O_HALF = 2 * O_CHUNK;          // one half over 64 columns
  static constexpr uint32_t STAGE = 2 * A_TILE + 4 * O_HALF;  // A for both warpgroups, then omega's halves
  static constexpr uint32_t G_AT = ST * STAGE;
  static constexpr uint32_t Y_AT = G_AT + 2 * G_SLOT;
  static constexpr size_t SMEM = (size_t)Y_AT + BAND * KN * 4 + 1024;
  static __device__ __forceinline__ uint32_t a_at(int s, int w) { return s * STAGE + w * A_TILE; }
  static __device__ __forceinline__ uint32_t o_at(int s, int w, int h) {
    return s * STAGE + 2 * A_TILE + (2 * w + h) * O_HALF;
  }
};

struct Args {
  float* wpart;   // (splits, L, n)
  float* ypart;   // (ceil(n / 512), m, K)
  double* npart;  // (splits * ceil(n / 512))
  int L, K;
  long long m, n, rows_per_split;
};

// d (+)= one product of a 64 x 8 register fragment and an 8 x KN tile
template <int KN>
__device__ __forceinline__ void wgmma_y(float (&d)[KN / 2], const uint32_t* a, uint64_t db) {
  if constexpr (KN == 24)
    wgmma_tf32_n24(d, a, db);
  else
    wgmma_tf32_n32(d, a, db);
}

template <int KN>
__global__ void __launch_bounds__(NT, 1)
    dual_sm90_kernel(const __grid_constant__ CUtensorMap ta, const __grid_constant__ CUtensorMap tg,
                     const __grid_constant__ CUtensorMap to, const Args a) {
  using Ly = Layout<KN>;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[2 * ST + 4];
  __shared__ double red[8];

  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;  // swizzled tiles sit on 1024 bytes
  uint8_t* const gbase = smem_raw + (base - smem_u32(smem_raw));  // the same bytes, as a generic pointer
  auto full = [&](int s) { return smem_u32(&bars[s]); };
  auto empty = [&](int s) { return smem_u32(&bars[ST + s]); };
  auto gfull = [&](int s) { return smem_u32(&bars[2 * ST + s]); };
  auto gempty = [&](int s) { return smem_u32(&bars[2 * ST + 2 + s]); };

  const int cb = blockIdx.x, split = blockIdx.y;
  const long long c_begin = (long long)cb * CB;
  const long long r_begin = (long long)split * a.rows_per_split;
  const long long r_end = min(a.m, r_begin + a.rows_per_split);
  const int nbands = (int)((r_end - r_begin + BAND - 1) / BAND);

  if (threadIdx.x == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 8);  // one arrival from each consumer warp
    }
    for (int s = 0; s < 2; ++s) {
      mbar_init(gfull(s), 1);
      mbar_init(gempty(s), 8);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ------------------------------------------------------------ producer
    setmaxnreg_dec<24>();
    if (threadIdx.x == 0) {
      int q = 0;
      for (int b = 0; b < nbands; ++b) {
        const int r0 = (int)(r_begin + (long long)b * BAND);
        const int gs = b & 1;
        mbar_wait(gempty(gs), (uint32_t)((b >> 1) & 1) ^ 1u);  // the first round finds both slots empty
        mbar_expect_tx(gfull(gs), G_SLOT);
        for (int h = 0; h < 2; ++h)
          for (int c = 0; c < 2; ++c)
            tma_load_2d(base + Ly::G_AT + gs * G_SLOT + h * G_HALF + c * (LN * 128), &tg, gfull(gs), r0 + 32 * c,
                        LN * h);
        for (int j = 0; j < NSUB; ++j, ++q) {
          const int s = q % ST;
          mbar_wait(empty(s), (uint32_t)((q / ST) & 1) ^ 1u);
          mbar_expect_tx(full(s), Ly::STAGE);
          for (int w = 0; w < 2; ++w) {
            const int col = (int)(c_begin + w * (NSUB * SUB) + j * SUB);
            for (int c = 0; c < 2; ++c) {
              tma_load_2d(base + Ly::a_at(s, w) + c * A_CHUNK, &ta, full(s), col + 32 * c, r0);
              for (int h = 0; h < 2; ++h)
                tma_load_2d(base + Ly::o_at(s, w, h) + c * Ly::O_CHUNK, &to, full(s), col + 32 * c, KN * h);
            }
          }
        }
      }
    }
    return;
  }

  // -------------------------------------------------------------- consumers
  setmaxnreg_inc<240>();
  const int w = (threadIdx.x >> 7) - 1;  // consumer warpgroup 0 or 1: columns 256 w .. 256 w + 255 of the block
  const int tid = threadIdx.x & 127;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;

  // w^T of sub-block j, summed over the bands in float32: column 16 warp +
  // g + 8 ((i / 2) % 2) of the sub-block, row of w 8 (i / 4) + 2 t4 + i % 2
  float wsum[NSUB][32];
  float acc[32];         // one band's w^T of the sub-block in flight, fresh each band
  float yacc[KN / 2];    // y of the band: row 16 warp + g + 8 ((i / 2) % 2), column 8 (i / 4) + 2 t4 + i % 2
  uint32_t fb[2][4 * KS], fs[2][4 * KS];  // two buffers of fragments: KS steps of 8, big and small halves
  // a step's offset in a descriptor's address field (16-byte units): steps
  // of 8 along K are 32 bytes apart within a 32-column chunk
  auto g_step = [](int kk) { return (uint32_t)(((kk >> 2) * (LN * 128) + (kk & 3) * 32) >> 4); };
  auto o_step = [](int kk) { return (uint32_t)(((kk >> 2) * Ly::O_CHUNK + (kk & 3) * 32) >> 4); };
#pragma unroll
  for (int j = 0; j < NSUB; ++j)
#pragma unroll
    for (int i = 0; i < 32; ++i) wsum[j][i] = 0.f;
  double nrm = 0.0;
  float* ybuf = reinterpret_cast<float*>(gbase + Ly::Y_AT);
  // Where this thread's pairs lie in a tile (byte offsets from it). Row
  // sketch, step kk: rows 8 kk + t4 (+ 4 e2), columns 16 warp + 2 g and + 1,
  // at rb[e2] + 1024 kk. Column sketch, step kk: rows 16 warp + g (+ 8 e1),
  // columns 8 kk + 2 t4 and + 1, at cb[kk % 4] + 8192 (kk / 4) + 1024 e1:
  // the swizzle XORs the column's 16-byte unit with the row, so only the
  // step within a chunk needs its own base.
  uint32_t rb[2], cb4[4];
#pragma unroll
  for (int e = 0; e < 2; ++e) rb[e] = f32_swz(t4 + 4 * e, 16 * warp + 2 * g, A_CHUNK);
#pragma unroll
  for (int k = 0; k < 4; ++k) cb4[k] = f32_swz(16 * warp + g, 8 * k + 2 * t4, A_CHUNK);

  int q = 0;
  for (int b = 0; b < nbands; ++b) {
    const int gs = b & 1;
    mbar_wait(gfull(gs), (uint32_t)((b >> 1) & 1));
    const uint64_t dgb = desc(base + Ly::G_AT + gs * G_SLOT, 16, 1024);
    const uint64_t dgs = desc(base + Ly::G_AT + gs * G_SLOT + G_HALF, 16, 1024);
#pragma unroll
    for (int i = 0; i < KN / 2; ++i) yacc[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NSUB; ++j, ++q) {
      const int s = q % ST;
      mbar_wait(full(s), (uint32_t)((q / ST) & 1));
      uint32_t tile = base + Ly::a_at(s, w);
      asm volatile("" : "+r"(tile));  // a stage's addresses are formed in the stage, not kept from the last
      const uint64_t dob = desc(base + Ly::o_at(s, w, 0), 16, 1024);
      const uint64_t dos = desc(base + Ly::o_at(s, w, 1), 16, 1024);
      float sq = 0.f;
      // sixteen steps of 8, KS a chunk: 0-7 the row sketch (K = the band's
      // rows), 8-15 the column sketch (K = the sub-block's columns), each
      // three TF32 products, the small terms first
#pragma unroll
      for (int c = 0; c < 16 / KS; ++c) {
        const int f = c & 1;
        const bool row_sketch = c < 8 / KS;
        if (c >= 2) {
          wgmma_wait<1>();  // the products of chunk c - 2, which read buffer f, are done
          fence_regs(fb[f]);
          fence_regs(fs[f]);
        }
        // fragment 4 s + e holds M index + 8 (e % 2) and K index + 4 (e / 2)
        // of step s of the chunk: the row sketch's pairs are (e, e + 1)
        // along M, the column sketch's (e, e + 2) along K
#pragma unroll
        for (int s2 = 0; s2 < KS; ++s2) {
          const int kk = (c * KS + s2) & 7;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const uint32_t addr =
                row_sketch ? tile + rb[h] + 1024u * kk : tile + cb4[kk & 3] + 8192u * (kk >> 2) + 1024u * h;
            float2 x;
            asm("ld.shared.v2.f32 {%0, %1}, [%2];\n" : "=f"(x.x), "=f"(x.y) : "r"(addr));
            const int e0 = 4 * s2 + (row_sketch ? 2 * h : h), e1 = e0 + (row_sketch ? 1 : 2);
            if (row_sketch) sq = fmaf(x.y, x.y, fmaf(x.x, x.x, sq));
            tf32_split_alu(x.x, fb[f][e0], fs[f][e0]);
            tf32_split_alu(x.y, fb[f][e1], fs[f][e1]);
          }
        }
        wgmma_fence();
        if (row_sketch) {
#pragma unroll
          for (int s2 = 0; s2 < KS; ++s2) {
            const int kk = c * KS + s2;
            wgmma_tf32_n64(acc, &fs[f][4 * s2], dgb + g_step(kk), kk > 0);  // a fresh sum each band
          }
#pragma unroll
          for (int s2 = 0; s2 < KS; ++s2) wgmma_tf32_n64(acc, &fb[f][4 * s2], dgs + g_step(c * KS + s2), 1);
#pragma unroll
          for (int s2 = 0; s2 < KS; ++s2) wgmma_tf32_n64(acc, &fb[f][4 * s2], dgb + g_step(c * KS + s2), 1);
        } else {
#pragma unroll
          for (int s2 = 0; s2 < KS; ++s2) wgmma_y<KN>(yacc, &fs[f][4 * s2], dob + o_step((c * KS + s2) & 7));
#pragma unroll
          for (int s2 = 0; s2 < KS; ++s2) wgmma_y<KN>(yacc, &fb[f][4 * s2], dos + o_step((c * KS + s2) & 7));
#pragma unroll
          for (int s2 = 0; s2 < KS; ++s2) wgmma_y<KN>(yacc, &fb[f][4 * s2], dob + o_step((c * KS + s2) & 7));
        }
        wgmma_commit();
      }
      wgmma_wait<0>();
      fence_regs(acc);
      fence_regs(yacc);
      fence_regs(fb[0]);
      fence_regs(fs[0]);
      fence_regs(fb[1]);
      fence_regs(fs[1]);
      // the tensor cores' own sum runs over one band only (24 products); the
      // bands add up here in float32, rounded to nearest
#pragma unroll
      for (int i = 0; i < 32; ++i) wsum[j][i] += acc[i];
      nrm += (double)sq;
      __syncwarp();
      if (lane == 0) mbar_arrive(empty(s));
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(gempty(gs));

    // the band's y: warpgroup 1 hands its sum to warpgroup 0, which adds it
    // second and writes the block's partial
    const long long r0 = r_begin + (long long)b * BAND;
    if (w == 1) {
      if (b > 0) named_sync(2);  // warpgroup 0 has read the previous band's
#pragma unroll
      for (int i = 0; i < KN / 2; ++i)
        ybuf[(16 * warp + g + 8 * ((i >> 1) & 1)) * KN + 8 * (i >> 2) + 2 * t4 + (i & 1)] = yacc[i];
      named_arrive(1);
    } else {
      named_sync(1);
      float* yp = a.ypart + (size_t)cb * a.m * a.K;
#pragma unroll
      for (int i = 0; i < KN / 2; ++i) {
        const int row = 16 * warp + g + 8 * ((i >> 1) & 1), col = 8 * (i >> 2) + 2 * t4 + (i & 1);
        const float v = yacc[i] + ybuf[row * KN + col];
        if (col < a.K && r0 + row < r_end) yp[(r0 + row) * a.K + col] = v;
      }
      if (b + 1 < nbands) named_arrive(2);
    }
  }

  // w^T's partial of this row split
  float* wp = a.wpart + (size_t)split * a.L * a.n;
#pragma unroll
  for (int j = 0; j < NSUB; ++j)
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const long long col = c_begin + w * (NSUB * SUB) + j * SUB + 16 * warp + 2 * g + ((i >> 1) & 1);
      const int row = 8 * (i >> 2) + 2 * t4 + (i & 1);
      if (row < a.L && col < a.n) wp[(long long)row * a.n + col] = wsum[j][i];
    }

  // the block's share of ||A||^2, in a fixed order
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) nrm += __shfl_down_sync(0xffffffffu, nrm, off);
  if (lane == 0) red[4 * w + warp] = nrm;
  named_sync(3);
  if (w == 0 && tid == 0) {
    double t = 0.0;
    for (int i = 0; i < 8; ++i) t += red[i];
    a.npart[(size_t)split * gridDim.x + cb] = t;
  }
}

// g's halves (2, 64, mp), rows past L and columns past m zero; omega^T's
// halves (2, KN, np), np = n rounded up to 8, rows past K and columns past
// n zero, the columns of each group of 8 in the column sketch's K order:
// position 8 q + k holds column 8 q + 2 (k % 4) + k / 4
__global__ void split_kernel(const float* __restrict__ g, const float* __restrict__ omega, uint32_t* __restrict__ gh,
                             uint32_t* __restrict__ oh, int L, int K, int KN, long long m, long long mp, long long n,
                             long long np) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long ng = (long long)LN * mp, no = (long long)KN * np;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < ng + no; i += stride) {
    if (i < ng) {
      const long long row = i / mp, col = i - row * mp;
      const float x = row < L && col < m ? g[row * m + col] : 0.f;
      tf32_split_alu(x, gh[i], gh[ng + i]);
    } else {
      const long long k = i - ng, row = k / np, pos = k - row * np;
      const long long col = (pos & ~7LL) + 2 * (pos & 3) + ((pos >> 2) & 1);
      const float x = row < K && col < n ? omega[col * K + row] : 0.f;
      tf32_split_alu(x, oh[k], oh[no + k]);
    }
  }
}

template <int KN>
int launch(const float* g, const float* omega, const float* a, float* w, float* y, float* norm, uint32_t* gh,
           uint32_t* oh, float* wpart, float* ypart, double* npart, int L, int K, long long m, long long n, int splits,
           long long rows_per_split, cudaStream_t s) {
  using Ly = Layout<KN>;
  const long long mp = (m + 3) & ~3LL, np = (n + 7) & ~7LL;
  split_kernel<<<1024, 256, 0, s>>>(g, omega, gh, oh, L, K, KN, m, mp, n, np);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  CUtensorMap ta, tg, to;
  int rc = encode_2d_f32(&ta, a, m, n, n, 32, BAND, true);
  if (rc == 0) rc = encode_2d_f32(&tg, gh, 2 * LN, mp, mp, 32, LN, true);
  if (rc == 0) rc = encode_2d_f32(&to, oh, 2 * KN, np, np, 32, KN, true);
  if (rc != 0) return rc;
  e = cudaFuncSetAttribute(dual_sm90_kernel<KN>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)Ly::SMEM);
  if (e != cudaSuccess) return (int)e;
  const long long cblocks = (n + CB - 1) / CB;
  const Args args{wpart, ypart, npart, L, K, m, n, rows_per_split};
  dual_sm90_kernel<KN><<<dim3((unsigned)cblocks, (unsigned)splits), NT, Ly::SMEM, s>>>(ta, tg, to, args);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  rc = launch_sum_parts(w, wpart, splits, (size_t)L * n, s);
  if (rc) return rc;
  rc = launch_sum_parts(y, ypart, (int)cblocks, (size_t)m * K, s);
  if (rc) return rc;
  sum_norm_kernel<<<1, 256, 0, s>>>(norm, npart, splits * (int)cblocks);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int heat_dual_sketch_sm90_block_cols() { return CB; }
int heat_dual_sketch_sm90_band_rows() { return BAND; }
// rows of K2's omega^T halves for k columns of the column sketch
int heat_dual_sketch_sm90_k_rows(int k) { return k <= 24 ? 24 : 32; }

// w (L, n), y (m, K) and norm () from g (L, m), omega (n, K) and A (m, n),
// all float32 row-major; L <= 64, K <= 32, n % 4 == 0, A on 16 bytes,
// rows_per_split a multiple of 64 and splits = ceil(m / rows_per_split).
// Scratch the caller allocates: gh (2, 64, round4(m)) and oh (2, KN,
// round8(n)) 32-bit words (KN from heat_dual_sketch_sm90_k_rows), wpart (splits, L,
// n) and ypart (ceil(n / 512), m, K) float32, npart (splits * ceil(n / 512))
// float64. Returns 0, the CUDA error code of the first failing launch, or
// 100000 + the CUresult of a refused tensor map.
int heat_dual_sketch_sm90(const float* g, const float* omega, const float* a, float* w, float* y, float* norm,
                          void* gh, void* oh, float* wpart, float* ypart, double* npart, int L, int K, long long m,
                          long long n, int splits, long long rows_per_split, int device, void* stream) {
  if (L < 1 || L > LN || K < 1 || K > 32 || m < 1 || n < 4 || n % 4 != 0 || m > 0x7fffffffLL || n > 0x7fffffffLL ||
      rows_per_split < BAND || rows_per_split % BAND != 0 || splits < 1 || (m + rows_per_split - 1) / rows_per_split != splits ||
      reinterpret_cast<uintptr_t>(a) % 16)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  uint32_t* ghw = static_cast<uint32_t*>(gh);
  uint32_t* ohw = static_cast<uint32_t*>(oh);
  if (K <= 24)
    return launch<24>(g, omega, a, w, y, norm, ghw, ohw, wpart, ypart, npart, L, K, m, n, splits, rows_per_split, s);
  return launch<32>(g, omega, a, w, y, norm, ghw, ohw, wpart, ypart, npart, L, K, m, n, splits, rows_per_split, s);
}

const char* heat_sketch_error_string(int code) { return error_string(code); }

}  // extern "C"
