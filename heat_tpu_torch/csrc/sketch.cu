// Hand-written Hopper (sm_90a) kernels for the hSVD sketch streams.
//
// K1  sketch_with_norm_f32       w = g @ A and ||A||_F^2 from one read of A.
//     Replaces heat_tpu/core/linalg/_pallas_sketch.py::_fused_call (the
//     Pallas TPU kernel behind sketch_with_norm).
// K2  dual_sketch_with_norm_f32  w = g @ A, y = A @ omega and ||A||_F^2 from
//     one read of A. Replaces _pallas_sketch.py::_dual_call (behind
//     dual_sketch_with_norm).
//
// Shapes: A (m, n) row-major float32; g (L, m); omega (n, K); w (L, n);
// y (m, K). K1 serves L <= 32, K2 serves L <= 64 and K <= 32.
//
// What bounds them on an H100 SXM: both read A exactly once, 4*m*n bytes at
// 3.35 TB/s. K1 does 2*L FLOP per element of A, K2 does 2*(L+K), in FP32 on
// the CUDA cores (67 TFLOP/s). At the main-path shape (m=65536, n=8192) K1
// with L=25 is bound by memory (0.64 ms; its arithmetic takes 0.42 ms) and
// K2 with L=59, K=24 by arithmetic (1.35 ms, about twice its 0.64 ms of
// memory).
//
// Design, and how it departs from the TPU kernels:
// * The TPU grid runs in order and carries w (and, for K2, the whole 64 x n
//   w) in VMEM from one grid step to the next. Hopper blocks run in parallel
//   with nothing carried between them, so the grid is (column block of BN
//   columns) x (row split). A block walks its row range in tiles of TM rows
//   and keeps w for its BN columns in registers (one column per thread, L
//   accumulators). At the end it writes its w, its y rows and its share of
//   ||A||^2 as partials to scratch; a second small kernel sums the partials
//   in a fixed order, so two runs on the same inputs give identical bits.
// * Loads: neighbouring threads take neighbouring columns of the row-major
//   A, so every warp load is one coalesced 128-byte line. The tile goes to
//   shared memory transposed (AsT[c][r]) so each thread reads four rows of
//   its column with one 16-byte load. The g tile is staged in shared memory
//   (gs[r][i]) and read by broadcast, four rows of g per 16-byte load.
// * Only the L (and K) real rows are computed: L is a template parameter,
//   picked by the host from 1..32 (K1) or 1..64 (K2); K is masked per
//   column of the y micro-tile. Nothing is padded to the TPU's sublanes.
// * K2's column sketch y = A @ omega reduces over columns, i.e. across the
//   threads of a block: the block computes the (TM x K) product of the shared
//   tile with its omega slice as 4x4 register micro-tiles over four column
//   slices, sums the slices through shared memory in a fixed order and
//   writes one partial row block per column block. With BN = 256 the y
//   partials are K/BN of A's bytes (about 10% at K=24).
// * ||A||^2 is summed per thread in FP32 over one tile, then in FP64 across
//   tiles and blocks.
// * Ragged m and n are masked: out-of-range A reads as 0, and out-of-range
//   outputs are not stored.
// * Precision is FP32 FMA throughout (no TF32, no tensor cores); wgmma and
//   TMA are for a later revision.

#include <cuda_runtime.h>
#include <stddef.h>

#include "sketch_sums.cuh"

namespace {

constexpr int TM = 32;        // rows per tile
constexpr int BN = 256;       // columns per block, one per thread
constexpr int THREADS = BN;
constexpr int AST = TM + 4;   // AsT row stride (floats): float4 aligned, no bank conflicts
constexpr int KMAX = 32;      // K2 column-sketch width cap
constexpr int CSLICES = 4;    // K2 y micro-tile: column slices reduced through shared memory

__host__ __device__ constexpr int round4(int x) { return (x + 3) & ~3; }

template <int L, bool DUAL>
struct Smem {
  static constexpr int LP = round4(L);
  static constexpr size_t ast = size_t(BN) * AST;
  static constexpr size_t gs = size_t(TM) * LP;
  static constexpr size_t om = DUAL ? size_t(BN) * KMAX : 0;
  static constexpr size_t yred = DUAL ? size_t(CSLICES) * TM * KMAX : 0;
  static constexpr size_t bytes = (ast + gs + om + yred) * sizeof(float);
};

template <int L, bool DUAL>
__global__ void __launch_bounds__(THREADS, 2)
sketch_kernel(const float* __restrict__ g, const float* __restrict__ omega,
              const float* __restrict__ a, float* __restrict__ wpart,
              float* __restrict__ ypart, double* __restrict__ npart, int K,
              long long m, long long n, long long rows_per_split) {
  using S = Smem<L, DUAL>;
  constexpr int LP = S::LP;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* ast = smem;                 // [BN][AST]   transposed A tile
  float* gs = ast + S::ast;          // [TM][LP]    g tile, rows of g contiguous
  float* oms = gs + S::gs;           // [BN][KMAX]  omega slice (K2)
  float* yred = oms + S::om;         // [CSLICES][TM][KMAX] y slice sums (K2)

  const int t = threadIdx.x;
  const int cb = blockIdx.x;
  const int split = blockIdx.y;
  const long long c0 = (long long)cb * BN;
  const long long col = c0 + t;
  const bool col_ok = col < n;
  const long long r_begin = (long long)split * rows_per_split;
  long long r_end = r_begin + rows_per_split;
  if (r_end > m) r_end = m;

  if (DUAL) {
    for (int idx = t; idx < BN * KMAX; idx += THREADS) {
      const int c = idx / KMAX, j = idx % KMAX;
      const long long cc = c0 + c;
      oms[idx] = (cc < n && j < K) ? omega[cc * K + j] : 0.f;
    }
  }

  float acc[L];
#pragma unroll
  for (int i = 0; i < L; ++i) acc[i] = 0.f;
  double nrm = 0.0;

  // K2 y micro-tile coordinates: 4 rows x 4 sketch columns over one column slice
  const int cs = t / 64;
  const int rq = (t % 64) / 8;
  const int jq = t % 8;
  const int j0 = jq * 4;

  for (long long r0 = r_begin; r0 < r_end; r0 += TM) {
    // 1. stream the A tile through registers (coalesced) and stage g
    float av[TM];
    float sq = 0.f;
#pragma unroll
    for (int r = 0; r < TM; ++r) {
      const long long rr = r0 + r;
      av[r] = (col_ok && rr < r_end) ? a[rr * n + col] : 0.f;
    }
    for (int idx = t; idx < L * TM; idx += THREADS) {
      const int i = idx / TM, r = idx % TM;
      const long long rr = r0 + r;
      gs[r * LP + i] = rr < r_end ? g[(long long)i * m + rr] : 0.f;
    }
    float4* my_ast = reinterpret_cast<float4*>(ast + (size_t)t * AST);
#pragma unroll
    for (int q = 0; q < TM / 4; ++q) {
      my_ast[q] = make_float4(av[4 * q], av[4 * q + 1], av[4 * q + 2], av[4 * q + 3]);
      sq = fmaf(av[4 * q], av[4 * q], sq);
      sq = fmaf(av[4 * q + 1], av[4 * q + 1], sq);
      sq = fmaf(av[4 * q + 2], av[4 * q + 2], sq);
      sq = fmaf(av[4 * q + 3], av[4 * q + 3], sq);
    }
    nrm += (double)sq;
    __syncthreads();

    // 2. row sketch: w[:, col] += g[:, tile] @ A[tile, col]
#pragma unroll 1
    for (int q = 0; q < TM / 4; ++q) {
      const float4 a4 = my_ast[q];
      const float ar[4] = {a4.x, a4.y, a4.z, a4.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = ar[e];
        const float* grow = gs + (4 * q + e) * LP;
#pragma unroll
        for (int i4 = 0; i4 < L / 4; ++i4) {
          const float4 gv = reinterpret_cast<const float4*>(grow)[i4];
          acc[4 * i4] = fmaf(gv.x, x, acc[4 * i4]);
          acc[4 * i4 + 1] = fmaf(gv.y, x, acc[4 * i4 + 1]);
          acc[4 * i4 + 2] = fmaf(gv.z, x, acc[4 * i4 + 2]);
          acc[4 * i4 + 3] = fmaf(gv.w, x, acc[4 * i4 + 3]);
        }
#pragma unroll
        for (int i = (L / 4) * 4; i < L; ++i) acc[i] = fmaf(grow[i], x, acc[i]);
      }
    }

    if (DUAL) {
      // 3. column sketch: y[tile, :] += A[tile, block cols] @ omega[block cols, :]
      float yacc[4][4];
#pragma unroll
      for (int er = 0; er < 4; ++er)
#pragma unroll
        for (int ej = 0; ej < 4; ++ej) yacc[er][ej] = 0.f;
      if (j0 < K) {
        const bool jm1 = j0 + 1 < K, jm2 = j0 + 2 < K, jm3 = j0 + 3 < K;
#pragma unroll 4
        for (int c = cs * (BN / CSLICES); c < (cs + 1) * (BN / CSLICES); ++c) {
          const float4 a4 = reinterpret_cast<const float4*>(ast + (size_t)c * AST)[rq];
          const float4 o4 = reinterpret_cast<const float4*>(oms + (size_t)c * KMAX)[jq];
          const float ar[4] = {a4.x, a4.y, a4.z, a4.w};
#pragma unroll
          for (int er = 0; er < 4; ++er) {
            yacc[er][0] = fmaf(ar[er], o4.x, yacc[er][0]);
            if (jm1) yacc[er][1] = fmaf(ar[er], o4.y, yacc[er][1]);
            if (jm2) yacc[er][2] = fmaf(ar[er], o4.z, yacc[er][2]);
            if (jm3) yacc[er][3] = fmaf(ar[er], o4.w, yacc[er][3]);
          }
        }
      }
#pragma unroll
      for (int er = 0; er < 4; ++er) {
        float4* dst = reinterpret_cast<float4*>(yred + ((size_t)cs * TM + 4 * rq + er) * KMAX);
        dst[jq] = make_float4(yacc[er][0], yacc[er][1], yacc[er][2], yacc[er][3]);
      }
      __syncthreads();
      float* yout = ypart + (size_t)cb * m * K;
      for (int o = t; o < TM * K; o += THREADS) {
        const int r = o / K, j = o % K;
        const long long rr = r0 + r;
        if (rr < r_end) {
          float v = yred[(size_t)r * KMAX + j];
#pragma unroll
          for (int s = 1; s < CSLICES; ++s) v += yred[((size_t)s * TM + r) * KMAX + j];
          yout[rr * K + j] = v;
        }
      }
    }
    __syncthreads();
  }

  // partial w of this row split, one column per thread
  if (col_ok) {
    float* wout = wpart + (size_t)split * L * n;
#pragma unroll
    for (int i = 0; i < L; ++i) wout[(long long)i * n + col] = acc[i];
  }

  // block sum of the norm partial, fixed order
  __shared__ double red[THREADS / 32];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) nrm += __shfl_down_sync(0xffffffffu, nrm, off);
  if ((t & 31) == 0) red[t / 32] = nrm;
  __syncthreads();
  if (t == 0) {
    double s = 0.0;
    for (int w = 0; w < THREADS / 32; ++w) s += red[w];
    npart[(size_t)split * gridDim.x + cb] = s;
  }
}

template <int L, bool DUAL>
int launch_sketch(const float* g, const float* omega, const float* a, float* wpart,
                  float* ypart, double* npart, int K, long long m, long long n, int splits,
                  long long rows_per_split, cudaStream_t stream) {
  using S = Smem<L, DUAL>;
  cudaError_t e = cudaFuncSetAttribute(sketch_kernel<L, DUAL>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)S::bytes);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((unsigned)((n + BN - 1) / BN), (unsigned)splits);
  sketch_kernel<L, DUAL><<<grid, THREADS, S::bytes, stream>>>(
      g, omega, a, wpart, ypart, npart, K, m, n, rows_per_split);
  return (int)cudaGetLastError();
}

// Picks the instantiation whose L equals the runtime l.
template <int L, bool DUAL>
int dispatch(int l, const float* g, const float* omega, const float* a, float* wpart,
             float* ypart, double* npart, int K, long long m, long long n, int splits,
             long long rows_per_split, cudaStream_t stream) {
  if (l == L)
    return launch_sketch<L, DUAL>(g, omega, a, wpart, ypart, npart, K, m, n, splits,
                                  rows_per_split, stream);
  if constexpr (L > 1) {
    return dispatch<L - 1, DUAL>(l, g, omega, a, wpart, ypart, npart, K, m, n, splits,
                                 rows_per_split, stream);
  } else {
    return (int)cudaErrorInvalidValue;
  }
}

int finish(float* w, float* y, float* norm, const float* wpart, const float* ypart,
           const double* npart, int L, int K, long long m, long long n, int splits,
           cudaStream_t stream) {
  int rc = launch_sum_parts(w, wpart, splits, (size_t)L * n, stream);
  if (rc) return rc;
  if (y != nullptr) {
    const int cblocks = (int)((n + BN - 1) / BN);
    rc = launch_sum_parts(y, ypart, cblocks, (size_t)m * K, stream);
    if (rc) return rc;
  }
  const int nparts = splits * (int)((n + BN - 1) / BN);
  sum_norm_kernel<<<1, 256, 0, stream>>>(norm, npart, nparts);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Scratch the caller allocates: wpart (splits, L, n) float32,
// npart (splits * ceil(n / 256)) float64; K2 also ypart (ceil(n / 256), m, K).
// Returns 0 or the CUDA error code of the first failing launch.

int heat_sketch_block_cols() { return BN; }
int heat_sketch_tile_rows() { return TM; }

int heat_sketch_with_norm_f32(const float* g, const float* a, float* w, float* norm,
                              float* wpart, double* npart, int L, long long m, long long n,
                              int splits, long long rows_per_split, int device,
                              void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (L < 1 || L > 32) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc = dispatch<32, false>(L, g, nullptr, a, wpart, nullptr, npart, 0, m, n, splits,
                               rows_per_split, s);
  if (rc) return rc;
  return finish(w, nullptr, norm, wpart, nullptr, npart, L, 0, m, n, splits, s);
}

int heat_dual_sketch_with_norm_f32(const float* g, const float* omega, const float* a,
                                   float* w, float* y, float* norm, float* wpart,
                                   float* ypart, double* npart, int L, int K, long long m,
                                   long long n, int splits, long long rows_per_split,
                                   int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (L < 1 || L > 64 || K < 1 || K > KMAX) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc = dispatch<64, true>(L, g, omega, a, wpart, ypart, npart, K, m, n, splits,
                              rows_per_split, s);
  if (rc) return rc;
  return finish(w, y, norm, wpart, ypart, npart, L, K, m, n, splits, s);
}

const char* heat_sketch_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
