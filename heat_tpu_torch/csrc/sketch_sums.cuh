// The fixed-order sums that finish the hSVD sketch kernels (sketch.cu: K1
// and K2; sketch_sm90.cu: K2's Hopper kernel): each kernel block writes
// partials, and these add them in the order of the partials, so that two
// runs on the same inputs give the same bits.

#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

// out[k] = sum_p parts[p * count + k], p in order
__global__ void sum_parts_kernel(float* __restrict__ out, const float* __restrict__ parts,
                                 int nparts, size_t count) {
  for (size_t k = (size_t)blockIdx.x * blockDim.x + threadIdx.x; k < count;
       k += (size_t)gridDim.x * blockDim.x) {
    float v = parts[k];
    for (int p = 1; p < nparts; ++p) v += parts[(size_t)p * count + k];
    out[k] = v;
  }
}

// out[0] = sum of the FP64 norm partials, fixed order, one block
__global__ void sum_norm_kernel(float* __restrict__ out, const double* __restrict__ parts,
                                int nparts) {
  __shared__ double red[256];
  double s = 0.0;
  for (int p = threadIdx.x; p < nparts; p += blockDim.x) s += parts[p];
  red[threadIdx.x] = s;
  __syncthreads();
  for (int h = blockDim.x / 2; h > 0; h >>= 1) {
    if (threadIdx.x < h) red[threadIdx.x] += red[threadIdx.x + h];
    __syncthreads();
  }
  if (threadIdx.x == 0) out[0] = (float)red[0];
}

int launch_sum_parts(float* out, const float* parts, int nparts, size_t count,
                     cudaStream_t stream) {
  if (count == 0) return (int)cudaGetLastError();
  size_t blocks = (count + 255) / 256;
  if (blocks > 4096) blocks = 4096;
  sum_parts_kernel<<<(unsigned)blocks, 256, 0, stream>>>(out, parts, nparts, count);
  return (int)cudaGetLastError();
}

}  // namespace
