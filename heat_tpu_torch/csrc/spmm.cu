// Hand-written Hopper (sm_90a) kernels K7 and K8: SpMM and SDDMM on the
// (8, 128) bricks of a DBCSR matrix (heat_tpu_torch/sparse/dbcsr_matrix.py).
//
// brick_spmm_f32 (K7)  y = A @ x for A's bricks bdata (B, 8, 128) and the
//     dense operand x (n, k), both row-major float32: for each brick row g,
//     y[8g + r, :] = sum over the row's bricks t (bmask[t, r] set) of
//     bdata[t, r, :] @ x[128 bcol[t] : +128, :], with x read as zero past
//     row n. Replaces heat_tpu/kernels/spmm.py::_brick_spmm_call (:238),
//     the Pallas TPU kernel that computes the per-brick products, and the
//     masked segment-sum that follows it in _local_spmm (:297-327).
// brick_sddmm_f32 (K8)  out[t] = sdata[t] * (u[8 brow[t] : +8] @
//     v[128 bcol[t] : +128]^T) for every brick t of the slab, with u (m, d)
//     and v (n, d) read as zero past their last rows. Replaces
//     heat_tpu/kernels/spmm.py::_brick_sddmm_call (:265).
//
// What bounds them on an H100 SXM (3.35 TB/s, 67 TFLOP/s FP32 outside the
// tensor cores):
// * K7 moves each 4 KB brick once and does 2 * 1024 * k FLOP on it, so it
//   is bound by bytes for every k below about 80: at 1,048,576 bricks and
//   k = 4 that is 4.3 GB, 1.28 ms. x is small (n k floats) and stays in L2.
// * K8 reads each brick and writes one (8 KB a brick) and does
//   2 * 1024 * d FLOP on it: at d = 64 that is 8.6 GB (2.56 ms) against
//   137 GFLOP (2.05 ms), so bytes and operations are close. Each brick also
//   needs 128 rows of v (32 KB at d = 64): read once a brick, as the TPU
//   kernel reads them, that is 4x the brick's own bytes.
//
// Design, and how it departs from the TPU kernels:
// * The TPU kernels run a sequential grid over the bricks, the brick column
//   map prefetched as scalars so that each step's DMA fetches the x (or
//   u, v) brick it needs; the segment-sum into rows stays in XLA. On Hopper
//   a separate scatter-add would need float atomics (bits that change from
//   run to run) or a second pass over a (B, 8, k) buffer. The slab holds
//   its real bricks in ascending brow order, so K7 takes one block per
//   brick row instead: its 8 warps walk the row's run of bricks
//   [rowptr[g], rowptr[g+1]) (warp w takes every 8th brick), each lane
//   loads 4 columns of the brick's 8 rows with 16-byte streaming loads (a
//   warp reads a brick row's 512 bytes at once), reads the 4 x rows it
//   needs through bcol (the block loads its own indices; 16-byte loads
//   when k % 4 == 0), and keeps 8 x KC partial sums in registers. A
//   shuffle tree sums the lanes and shared memory the 8 warps, in a fixed
//   order: no atomics, so a rerun gives the same bits. k runs in register
//   chunks of KC = 1, 2, 4 or 8 columns. Rows that bmask excludes are
//   skipped (a pad brick, the rows past m of the last brick row), and a
//   row with no bricks gets zeros.
// * K8 walks the bricks by brick column, not in slab order: corder lists
//   them grouped by bcol (cached on the matrix). A block of 128 threads
//   takes a run of at least 32 bricks of one column; thread i holds row
//   128 c + i of v (64 of d at a time) in registers for the whole run, so
//   v is read once a run instead of once a brick. Per brick the 8 rows of
//   u are staged in shared memory, transposed, and read by broadcast (the
//   next brick's rows load while this one computes); thread i computes
//   the brick's column i, 8 dot products with FP32 FMAs, scales by sdata
//   and writes with coalesced streaming stores. For d > 64 a later chunk
//   adds to what the earlier ones wrote, in a fixed order. There are no
//   sums across bricks, so a rerun repeats the bits.
// * Precision: FP32 FMA, no TF32 and no tensor cores. bf16/f16 bricks are
//   widened to float32 before the launch by the wrapper.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BR = 8;          // brick rows
constexpr int BC = 128;        // brick columns
constexpr int SPMM_WARPS = 8;  // warps of a K7 block
constexpr int SDDMM_T = BC;    // threads of a K8 block: one brick column each
constexpr int DV = 64;         // K8's chunk of d, held in registers
constexpr int SDDMM_SEG = 32;  // bricks of a column run per K8 block, at least

template <int KC>
__global__ void __launch_bounds__(SPMM_WARPS * 32)
brick_spmm_kernel(const float* __restrict__ bdata, const int* __restrict__ bcol,
                  const unsigned long long* __restrict__ bmask, const int* __restrict__ rowptr,
                  const float* __restrict__ x, float* __restrict__ y, long long m, long long n,
                  int k, bool xvec) {
  __shared__ float red[SPMM_WARPS][BR][KC];
  const long long g = blockIdx.x;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int t0 = rowptr[g];
  const int t1 = rowptr[g + 1];
  for (int j0 = 0; j0 < k; j0 += KC) {
    float acc[BR][KC];
#pragma unroll
    for (int r = 0; r < BR; ++r)
#pragma unroll
      for (int jj = 0; jj < KC; ++jj) acc[r][jj] = 0.0f;

#pragma unroll 2
    for (int t = t0 + warp; t < t1; t += SPMM_WARPS) {
      const float4* brick = reinterpret_cast<const float4*>(bdata + (long long)t * (BR * BC));
      float4 a[BR];
#pragma unroll
      for (int r = 0; r < BR; ++r) a[r] = __ldcs(brick + r * (BC / 4) + lane);
      const unsigned long long mask = __ldg(bmask + t);  // one bool byte per row
      const long long col0 = (long long)__ldg(bcol + t) * BC + 4 * lane;
      float xv[4][KC];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const long long col = col0 + q;
        const bool in = col >= 0 && col < n;
        if constexpr (KC % 4 == 0) {
          if (xvec) {  // k % 4 == 0 and x 16-byte aligned: 16-byte loads
#pragma unroll
            for (int h = 0; h < KC / 4; ++h) {
              float4 w = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
              if (in && j0 + 4 * h < k) w = __ldg(reinterpret_cast<const float4*>(x + col * k + j0 + 4 * h));
              xv[q][4 * h] = w.x;
              xv[q][4 * h + 1] = w.y;
              xv[q][4 * h + 2] = w.z;
              xv[q][4 * h + 3] = w.w;
            }
            continue;
          }
        }
#pragma unroll
        for (int jj = 0; jj < KC; ++jj)
          xv[q][jj] = (in && j0 + jj < k) ? __ldg(x + col * k + j0 + jj) : 0.0f;
      }
#pragma unroll
      for (int r = 0; r < BR; ++r) {
        if ((mask >> (8 * r)) & 0xFFull) {
#pragma unroll
          for (int jj = 0; jj < KC; ++jj) {
            float s = acc[r][jj];
            s = fmaf(a[r].x, xv[0][jj], s);
            s = fmaf(a[r].y, xv[1][jj], s);
            s = fmaf(a[r].z, xv[2][jj], s);
            s = fmaf(a[r].w, xv[3][jj], s);
            acc[r][jj] = s;
          }
        }
      }
    }

#pragma unroll
    for (int r = 0; r < BR; ++r)
#pragma unroll
      for (int jj = 0; jj < KC; ++jj) {
        float v = acc[r][jj];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
        acc[r][jj] = v;
      }
    if (lane == 0) {
#pragma unroll
      for (int r = 0; r < BR; ++r)
#pragma unroll
        for (int jj = 0; jj < KC; ++jj) red[warp][r][jj] = acc[r][jj];
    }
    __syncthreads();
    if (threadIdx.x < BR * KC) {
      const int r = threadIdx.x / KC;
      const int jj = threadIdx.x % KC;
      float s = red[0][r][jj];
#pragma unroll
      for (int w = 1; w < SPMM_WARPS; ++w) s += red[w][r][jj];
      const long long row = g * BR + r;
      if (row < m && j0 + jj < k) y[row * k + j0 + jj] = s;
    }
    __syncthreads();
  }
}

// Row `row` of a (rows, d) row-major matrix, columns [j, j + 4), as one
// float4 with zeros past its last row and column: a 16-byte load when the
// rows are 16-byte aligned (vec), else four 4-byte loads.
__device__ __forceinline__ float4 load4(const float* __restrict__ a, long long row, long long rows,
                                        int d, int j, bool vec) {
  float4 w = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (row < 0 || row >= rows || j >= d) return w;
  const float* p = a + row * d + j;
  if (vec) return __ldg(reinterpret_cast<const float4*>(p));
  w.x = __ldg(p);
  if (j + 1 < d) w.y = __ldg(p + 1);
  if (j + 2 < d) w.z = __ldg(p + 2);
  if (j + 3 < d) w.w = __ldg(p + 3);
  return w;
}

__global__ void __launch_bounds__(SDDMM_T)
brick_sddmm_kernel(const float* __restrict__ sdata, const int* __restrict__ brow,
                   const int* __restrict__ corder, const int* __restrict__ colptr,
                   const float* __restrict__ u, const float* __restrict__ v, float* __restrict__ out,
                   long long m, long long n, int d, int seg, bool vec) {
  __shared__ __align__(16) float ut[DV][BR];  // one brick's u rows, transposed: ut[j][r]
  const int c = blockIdx.x;                   // the brick column
  const int i0 = colptr[c] + blockIdx.y * seg;
  const int i1 = min(colptr[c + 1], i0 + seg);
  if (i0 >= i1) return;
  const int tid = threadIdx.x;                // the column within the brick
  const long long col = (long long)c * BC + tid;
  for (int j0 = 0; j0 < d; j0 += DV) {
    const bool first = j0 == 0;
    const bool last = j0 + DV >= d;
    // this thread's row of v, columns [j0, j0 + DV), kept in registers for
    // every brick of the run
    float vr[DV];
#pragma unroll
    for (int g = 0; g < DV / 4; ++g) {
      const float4 w = load4(v, col, n, d, j0 + 4 * g, vec);
      vr[4 * g] = w.x;
      vr[4 * g + 1] = w.y;
      vr[4 * g + 2] = w.z;
      vr[4 * g + 3] = w.w;
    }
    // thread tid stages row tid % 8, columns 4 (tid / 8) + 0..3, of a
    // brick's 8 rows of u (its transposed stores then meet 8 banks)
    const int ur = tid % BR, uq = 4 * (tid / BR);
    float4 next = load4(u, (long long)__ldg(brow + __ldg(corder + i0)) * BR + ur, m, d, j0 + uq, vec);
    for (int i = i0; i < i1; ++i) {
      const long long t = __ldg(corder + i);
      const float4 w = next;
      __syncthreads();  // every thread is done with the previous brick's rows
      ut[uq][ur] = w.x;
      ut[uq + 1][ur] = w.y;
      ut[uq + 2][ur] = w.z;
      ut[uq + 3][ur] = w.w;
      __syncthreads();
      if (i + 1 < i1)  // the next brick's rows load while this one computes
        next = load4(u, (long long)__ldg(brow + __ldg(corder + i + 1)) * BR + ur, m, d, j0 + uq, vec);
      const float* s = sdata + t * (BR * BC) + tid;
      float* o = out + t * (BR * BC) + tid;
      float sv[BR];
#pragma unroll
      for (int r = 0; r < BR; ++r) sv[r] = last ? __ldcs(s + r * BC) : 0.0f;
      float acc[BR];
#pragma unroll
      for (int r = 0; r < BR; ++r) acc[r] = first ? 0.0f : o[r * BC];
#pragma unroll
      for (int j = 0; j < DV; ++j) {
        const float4 ua = *reinterpret_cast<const float4*>(&ut[j][0]);
        const float4 ub = *reinterpret_cast<const float4*>(&ut[j][4]);
        acc[0] = fmaf(ua.x, vr[j], acc[0]);
        acc[1] = fmaf(ua.y, vr[j], acc[1]);
        acc[2] = fmaf(ua.z, vr[j], acc[2]);
        acc[3] = fmaf(ua.w, vr[j], acc[3]);
        acc[4] = fmaf(ub.x, vr[j], acc[4]);
        acc[5] = fmaf(ub.y, vr[j], acc[5]);
        acc[6] = fmaf(ub.z, vr[j], acc[6]);
        acc[7] = fmaf(ub.w, vr[j], acc[7]);
      }
#pragma unroll
      for (int r = 0; r < BR; ++r) {
        if (last)
          __stcs(o + r * BC, sv[r] * acc[r]);
        else
          o[r * BC] = acc[r];
      }
    }
  }
}

template <int KC>
int launch_spmm(const float* bdata, const int* bcol, const unsigned long long* bmask,
                const int* rowptr, const float* x, float* y, long long mb, long long m,
                long long n, int k, cudaStream_t s) {
  const bool xvec = k % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  brick_spmm_kernel<KC><<<(unsigned)mb, SPMM_WARPS * 32, 0, s>>>(bdata, bcol, bmask, rowptr, x,
                                                                  y, m, n, k, xvec);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// y (m, k) = A @ x. bdata (B, 8, 128), bcol (B,) int32, bmask (B, 8) bool
// (8-byte aligned rows), rowptr (mb + 1,) int32 of the runs of real bricks
// per brick row, x (n, k) float32 row-major. Returns 0 or the CUDA error
// code of the launch.
int heat_brick_spmm_f32(const float* bdata, const int* bcol, const void* bmask, const int* rowptr,
                        const float* x, float* y, long long mb, long long m, long long n, int k,
                        int device, void* stream) {
  if (mb < 1 || mb > 0x7fffffffLL || m < 0 || m > mb * BR || n < 0 || k < 1)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned long long* mask = static_cast<const unsigned long long*>(bmask);
  if (k == 1) return launch_spmm<1>(bdata, bcol, mask, rowptr, x, y, mb, m, n, k, s);
  if (k == 2) return launch_spmm<2>(bdata, bcol, mask, rowptr, x, y, mb, m, n, k, s);
  if (k <= 4) return launch_spmm<4>(bdata, bcol, mask, rowptr, x, y, mb, m, n, k, s);
  return launch_spmm<8>(bdata, bcol, mask, rowptr, x, y, mb, m, n, k, s);
}

// out (B, 8, 128) = sdata * (u-brick @ v-brick^T) per brick. brow (B,)
// int32; corder (B,) int32 lists the bricks grouped by brick column, column
// c's run being corder[colptr[c] : colptr[c + 1]] (colptr (nb + 1,) int32),
// and `longest` is the longest run; u (m, d) and v (n, d) float32
// row-major. Returns 0 or the CUDA error code of the launch.
int heat_brick_sddmm_f32(const float* sdata, const int* brow, const int* corder, const int* colptr,
                         const float* u, const float* v, float* out, long long nb, long long longest,
                         long long m, long long n, int d, int device, void* stream) {
  if (nb < 1 || nb > 0x7fffffffLL || longest < 0 || m < 0 || n < 0 || d < 1)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (longest == 0) return 0;
  // at least SDDMM_SEG bricks a block, and at most 65535 blocks a column
  const long long seg = longest / 65535 + 1 > SDDMM_SEG ? longest / 65535 + 1 : SDDMM_SEG;
  const dim3 grid((unsigned)nb, (unsigned)((longest + seg - 1) / seg));
  const bool vec = d % 4 == 0 && reinterpret_cast<uintptr_t>(u) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(v) % 16 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  brick_sddmm_kernel<<<grid, SDDMM_T, 0, s>>>(sdata, brow, corder, colptr, u, v, out, m, n, d,
                                              (int)seg, vec);
  return (int)cudaGetLastError();
}

const char* heat_spmm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
