// Hand-written Hopper (sm_90a) kernel K3: the fused assignment pass of a
// Lloyd (KMeans) iteration.
//
// kmeans_assign_f32  For X (n, d) and centers C (k, d), both row-major
//     float32: d2 = max(||x||^2 + ||c||^2 - 2 x.c, 0) per row and center,
//     the first-index argmin per row, and from one read of X the cluster
//     sums onehot^T X (k, d), the counts (k,) and the inertia (the summed
//     min d2). Replaces heat_tpu/cluster/_pallas.py::_make_kernel (:66), the
//     Pallas TPU kernel behind fused_assign_program (:106).
//
// What bounds it on an H100 SXM: it reads X once, 4*n*d bytes at 3.35 TB/s.
// At the main-path shape (n = 15,625,000, d = 64, k = 8) that is 4.00 GB,
// 1.194 ms. Its arithmetic is 2nkd FLOP for the products and 2nk(d+2) for
// the one-hot accumulation, about 3.3e10 FLOP, 0.49 ms at 67 TFLOP/s FP32
// outside the tensor cores. So K3 is bound by bytes, and a CUDA-core kernel
// that keeps X out of device memory after one read can come near the bound.
//
// Design, and how it departs from the TPU kernel:
// * The TPU grid runs in order and keeps the one (k, d+2) accumulator in
//   VMEM across every row tile. Hopper blocks run in parallel and carry
//   nothing, so a few blocks per SM each walk their own strided set of
//   128-row tiles, keep their accumulators in registers, and write one
//   partial in float64 at the end. A second small kernel sums the partials
//   in block order with a fixed tree, so a rerun gives the same bits. There
//   are no atomics.
// * The centers and ||c||^2 are staged in shared memory once per block and
//   read by broadcast. k is padded to the template sizes 8/16/32/64 (four
//   instantiations); the extra centers are zero and never win the argmin.
// * Each tile of X is loaded with coalesced 16-byte streaming loads (4-byte
//   loads when d % 4 != 0) into shared memory. A row holds
//   [x | zero pad to a multiple of 4 | 1 | min d2], with an odd number of
//   float4 per row so that one thread per row reading 16 bytes does not hit
//   a single bank. Rows past n are masked in the kernel; nothing is padded
//   on the host.
// * Assignment: one thread per row computes ||x||^2 and the k products,
//   then d2, the clamp and the first-index argmin, and writes its label,
//   the 1 and its min d2 into the tile.
// * Accumulation (the one-hot product): one thread per chunk of 4, 2 or 1
//   columns of the tile row (so that it holds at most 64 accumulators)
//   and per row group adds the group's rows in order, with a predicated
//   add per cluster. The 1 column gives the counts and the min d2 column
//   the per-cluster inertia, as in the TPU kernel.
// * Bounds: k <= 64 (the register accumulators) and d <= 124 (a block's
//   128 threads must cover the padded row at one column each when k > 32).
// * Precision: FP32 FMA for the products and the per-thread sums (no TF32,
//   no tensor cores); float64 across row groups and blocks.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int T = 128;     // threads per block, and rows per tile
constexpr int TM = T;
constexpr int KMAX = 64;
constexpr int DMAX = 124;

// columns per accumulating thread: KP * CPT <= 64 accumulators
template <int KP>
struct Cols {
  static constexpr int CPT = KP <= 16 ? 4 : (KP <= 32 ? 2 : 1);
};

struct Geom {
  int d1;      // d rounded up to a multiple of 4: the column of the 1
  int w;       // accumulated width d1 + 2
  int stride;  // floats per tile row: an odd number of float4
  int nc;      // column chunks of a row
  int groups;  // row groups, groups * nc <= T
  int ncw;     // nc * cpt, the width of the block reduction
  size_t region0;  // floats: the tile, and after the loop the group sums
  size_t bytes;    // dynamic shared memory of a block
};

__host__ __device__ inline Geom geometry(int d, int kp, int cpt) {
  Geom g;
  g.d1 = (d + 3) & ~3;
  g.w = g.d1 + 2;
  g.stride = 4 * (((g.w + 3) / 4) | 1);
  g.nc = (g.w + cpt - 1) / cpt;
  g.groups = T / g.nc;
  g.ncw = g.nc * cpt;
  const size_t tile = (size_t)TM * g.stride;
  const size_t red = (size_t)g.groups * kp * g.ncw;
  g.region0 = tile > red ? tile : red;
  g.bytes = (g.region0 + (size_t)kp * g.stride + kp + TM) * sizeof(float);
  return g;
}

template <int N>
struct Vec;
template <>
struct Vec<4> {
  __device__ static void load(const float* p, float* v) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  }
};
template <>
struct Vec<2> {
  __device__ static void load(const float* p, float* v) {
    const float2 q = *reinterpret_cast<const float2*>(p);
    v[0] = q.x; v[1] = q.y;
  }
};
template <>
struct Vec<1> {
  __device__ static void load(const float* p, float* v) { v[0] = *p; }
};

// Width of the output partial of one block: sums (k*d), counts (k),
// per-cluster inertia (k).
__host__ __device__ inline int part_width(int d, int k) { return k * d + 2 * k; }

constexpr int BATCH = 8;  // loads in flight per thread while staging a tile

template <int KP>
__global__ void __launch_bounds__(T)
assign_kernel(const float* __restrict__ x, const float* __restrict__ c,
              double* __restrict__ part, long long n, int d, int k, long long tiles,
              int vec) {
  constexpr int CPT = Cols<KP>::CPT;
  const Geom g = geometry(d, KP, CPT);
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* xs = smem;                        // [TM][stride]
  float* cs = smem + g.region0;            // [KP][stride] centers, zero-padded
  float* c2s = cs + (size_t)KP * g.stride; // [KP]
  int* labs = reinterpret_cast<int*>(c2s + KP);  // [TM]
  const int t = threadIdx.x;
  const int stride = g.stride;

  for (int i = t; i < KP * stride; i += T) {
    const int j = i / stride, col = i - j * stride;
    cs[i] = (j < k && col < d) ? c[(size_t)j * d + col] : 0.f;
  }
  // zero pad columns [d, d1) of every tile row; loads never write them
  for (int i = t; i < TM * (g.d1 - d); i += T) {
    const int r = i / (g.d1 - d), col = d + i % (g.d1 - d);
    xs[r * stride + col] = 0.f;
  }
  __syncthreads();
  if (t < KP) {
    float s = 0.f;
    for (int col = 0; col < d; ++col) s = fmaf(cs[t * stride + col], cs[t * stride + col], s);
    c2s[t] = s;
  }

  // accumulating thread: column chunk ch of the tile row, row group grp
  const bool accumulates = t < g.groups * g.nc;
  const int ch = t % g.nc;
  const int grp = t / g.nc;
  float acc[KP][CPT];
#pragma unroll
  for (int j = 0; j < KP; ++j)
#pragma unroll
    for (int e = 0; e < CPT; ++e) acc[j][e] = 0.f;

  const int nq = g.d1 / 4;  // float4 of x per row, pad included
  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long long r0 = tile * TM;
    const int rows = (int)((n - r0) < TM ? (n - r0) : TM);

    // 1. stage the tile: coalesced loads, BATCH in flight per thread
    if (vec) {
      const int q4 = d / 4;
      const float4* src = reinterpret_cast<const float4*>(x + r0 * d);
      const int total = rows * q4;
      const int dr = T / q4, dq = T % q4;
      int r = t / q4, q = t % q4;
      for (int base = t; base < total; base += BATCH * T) {
        float4 v[BATCH];
#pragma unroll
        for (int u = 0; u < BATCH; ++u) {
          const int i = base + u * T;
          if (i < total) v[u] = __ldcs(src + i);
        }
#pragma unroll
        for (int u = 0; u < BATCH; ++u) {
          if (base + u * T < total) reinterpret_cast<float4*>(xs + r * stride)[q] = v[u];
          r += dr;
          q += dq;
          if (q >= q4) { q -= q4; ++r; }
        }
      }
    } else {
      const float* src = x + r0 * d;
      const int total = rows * d;
      const int dr = T / d, dc = T % d;
      int r = t / d, col = t % d;
      for (int base = t; base < total; base += BATCH * T) {
        float v[BATCH];
#pragma unroll
        for (int u = 0; u < BATCH; ++u) {
          const int i = base + u * T;
          if (i < total) v[u] = __ldcs(src + i);
        }
#pragma unroll
        for (int u = 0; u < BATCH; ++u) {
          if (base + u * T < total) xs[r * stride + col] = v[u];
          r += dr;
          col += dc;
          if (col >= d) { col -= d; ++r; }
        }
      }
    }
    __syncthreads();

    // 2. assignment, one thread per row
    {
      const int r = t;
      float* row = xs + r * stride;
      const float4* xr = reinterpret_cast<const float4*>(row);
      float dot[KP];
#pragma unroll
      for (int j = 0; j < KP; ++j) dot[j] = 0.f;
      float x2 = 0.f;
      for (int q = 0; q < nq; ++q) {
        const float4 xv = xr[q];
        x2 = fmaf(xv.x, xv.x, x2);
        x2 = fmaf(xv.y, xv.y, x2);
        x2 = fmaf(xv.z, xv.z, x2);
        x2 = fmaf(xv.w, xv.w, x2);
#pragma unroll
        for (int j = 0; j < KP; ++j) {
          const float4 cv = reinterpret_cast<const float4*>(cs + j * stride)[q];
          dot[j] = fmaf(xv.x, cv.x, dot[j]);
          dot[j] = fmaf(xv.y, cv.y, dot[j]);
          dot[j] = fmaf(xv.z, cv.z, dot[j]);
          dot[j] = fmaf(xv.w, cv.w, dot[j]);
        }
      }
      float best = fmaxf(x2 + c2s[0] - 2.f * dot[0], 0.f);
      int lab = 0;
#pragma unroll
      for (int j = 1; j < KP; ++j) {
        const float d2 = fmaxf(x2 + c2s[j] - 2.f * dot[j], 0.f);
        if (j < k && d2 < best) { best = d2; lab = j; }  // strict: first index wins
      }
      const bool valid = r < rows;
      labs[r] = valid ? lab : -1;
      row[g.d1] = valid ? 1.f : 0.f;
      row[g.d1 + 1] = valid ? best : 0.f;
    }
    __syncthreads();

    // 3. accumulation: onehot^T [x | 1 | min d2], rows of a group in order
    if (accumulates) {
      for (int r = grp; r < rows; r += g.groups) {
        const int lab = labs[r];
        float v[CPT];
        Vec<CPT>::load(xs + r * stride + ch * CPT, v);
#pragma unroll
        for (int j = 0; j < KP; ++j) {
          if (lab == j) {
#pragma unroll
            for (int e = 0; e < CPT; ++e) acc[j][e] += v[e];
          }
        }
      }
    }
    __syncthreads();
  }

  // 4. block partial: group sums in a fixed order, in float64
  float* red = smem;  // [groups][KP][ncw], over the tile
  if (accumulates) {
#pragma unroll
    for (int j = 0; j < KP; ++j)
#pragma unroll
      for (int e = 0; e < CPT; ++e)
        red[((size_t)grp * KP + j) * g.ncw + ch * CPT + e] = acc[j][e];
  }
  __syncthreads();
  double* out = part + (size_t)blockIdx.x * part_width(d, k);
  for (int o = t; o < k * g.ncw; o += T) {
    const int j = o / g.ncw, col = o - j * g.ncw;
    if (col >= d && col != g.d1 && col != g.d1 + 1) continue;
    double s = 0.0;
    for (int p = 0; p < g.groups; ++p) s += (double)red[((size_t)p * KP + j) * g.ncw + col];
    if (col < d)
      out[(size_t)j * d + col] = s;
    else if (col == g.d1)
      out[(size_t)k * d + j] = s;
    else
      out[(size_t)k * d + k + j] = s;
  }
}

// Block o < k*d + k sums column o of the partials over the blocks; block
// k*d + k sums the per-cluster inertia columns of every block. Fixed
// order: strided per thread, then a fixed tree.
__global__ void finish_kernel(const double* __restrict__ part, int nblocks, int d, int k,
                              float* __restrict__ sums, float* __restrict__ counts,
                              float* __restrict__ inertia) {
  __shared__ double red[256];
  const int o = blockIdx.x;
  const int width = part_width(d, k);
  const int kd = k * d;
  double s = 0.0;
  if (o < kd + k) {
    for (int b = threadIdx.x; b < nblocks; b += blockDim.x) s += part[(size_t)b * width + o];
  } else {
    for (int p = threadIdx.x; p < nblocks * k; p += blockDim.x)
      s += part[(size_t)(p / k) * width + kd + k + p % k];
  }
  red[threadIdx.x] = s;
  __syncthreads();
  for (int h = blockDim.x / 2; h > 0; h >>= 1) {
    if (threadIdx.x < h) red[threadIdx.x] += red[threadIdx.x + h];
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    if (o < kd)
      sums[o] = (float)red[0];
    else if (o < kd + k)
      counts[o - kd] = (float)red[0];
    else
      *inertia = (float)red[0];
  }
}

template <int KP>
int prepare(int d, size_t* bytes) {
  const Geom g = geometry(d, KP, Cols<KP>::CPT);
  *bytes = g.bytes;
  return (int)cudaFuncSetAttribute(assign_kernel<KP>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize, (int)g.bytes);
}

template <int KP>
int grid_for(long long n, int d, int device, int* grid) {
  size_t bytes;
  int rc = prepare<KP>(d, &bytes);
  if (rc) return rc;
  int per_sm = 0, sms = 0;
  cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, assign_kernel<KP>, T, bytes);
  if (e != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const long long tiles = (n + TM - 1) / TM;
  const long long want = (long long)per_sm * sms;
  *grid = (int)(tiles < want ? tiles : want);
  return 0;
}

template <int KP>
int launch(const float* x, const float* c, double* part, long long n, int d, int k, int grid,
           cudaStream_t stream) {
  size_t bytes;
  int rc = prepare<KP>(d, &bytes);
  if (rc) return rc;
  const long long tiles = (n + TM - 1) / TM;
  const int vec = (d % 4 == 0) && (reinterpret_cast<size_t>(x) % 16 == 0);
  assign_kernel<KP><<<grid, T, bytes, stream>>>(x, c, part, n, d, k, tiles, vec);
  return (int)cudaGetLastError();
}

bool valid_shape(long long n, int d, int k) {
  return n >= 1 && d >= 1 && d <= DMAX && k >= 1 && k <= KMAX;
}

}  // namespace

extern "C" {

// Blocks of the assignment grid for (n, d, k) on `device`: as many as fit
// on the SMs at once, at most one per tile. The caller allocates the
// partials, float64 (grid, k*d + 2k), for that grid.
int heat_kmeans_assign_grid(long long n, int d, int k, int device, int* grid) {
  if (!valid_shape(n, d, k)) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (k <= 8) return grid_for<8>(n, d, device, grid);
  if (k <= 16) return grid_for<16>(n, d, device, grid);
  if (k <= 32) return grid_for<32>(n, d, device, grid);
  return grid_for<64>(n, d, device, grid);
}

// sums (k, d), counts (k,), inertia (): float32 outputs. Returns 0 or the
// CUDA error code of the first failing call.
int heat_kmeans_assign_f32(const float* x, const float* c, float* sums, float* counts,
                           float* inertia, double* part, long long n, int d, int k, int grid,
                           int device, void* stream) {
  if (!valid_shape(n, d, k) || grid < 1) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc;
  if (k <= 8)
    rc = launch<8>(x, c, part, n, d, k, grid, s);
  else if (k <= 16)
    rc = launch<16>(x, c, part, n, d, k, grid, s);
  else if (k <= 32)
    rc = launch<32>(x, c, part, n, d, k, grid, s);
  else
    rc = launch<64>(x, c, part, n, d, k, grid, s);
  if (rc) return rc;
  finish_kernel<<<k * d + k + 1, 256, 0, s>>>(part, grid, d, k, sums, counts, inertia);
  return (int)cudaGetLastError();
}

const char* heat_kmeans_assign_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
