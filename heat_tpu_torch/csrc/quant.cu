// Hand-written Hopper (sm_90a) kernel pair Q1: the int8 block codec of the
// wire (heat_tpu_torch/kernels/quant.py, used by the quantized all-reduces
// of the data-parallel gradient and by the redistribution executor's codec
// laps).
//
// quant_encode  (B, n) float32 -> (B, W) int8, W = npad + 4 * nt, npad = n
//     rounded up to a multiple of the tile T = 1024, nt = npad / T. For each
//     tile: amax = the largest |x| over its finite elements (a ragged last
//     tile is padded with zeros), scale = amax / 126 (1 for amax == 0); each
//     element's code is rint(x / scale) clipped to [-126, 126], with the
//     reserved codes -128 for NaN, 127 for +inf and -127 for -inf. The
//     payload is the npad codes; the nt scales follow as raw float32 bytes.
//     Computes heat_tpu/kernels/quant.py:174 _encode_int8.
// quant_decode  (B, W) int8 -> (B, n) float32: code * scale of its tile, the
//     reserved codes back to NaN and +-inf. Computes quant.py:194
//     _decode_int8.
// heat_tpu's codec is an XLA formulation fused into the program around it;
// it is not a Pallas kernel, so Q1 replaces no pallas_call.
//
// What bounds them on an H100 SXM: bytes. Encode reads 4 n bytes and writes
// n + 4 n / T; decode the reverse; a handful of operations an element. At
// n = 2^28: 1,343,225,856 B each way, 0.4010 ms at 3.35 TB/s.
//
// Design: one block of 256 threads a tile, four consecutive elements a
// thread (one 16-byte load where the row is 16-byte aligned, else four
// scalar loads), the tile's amax by warp shuffles and one pass through
// shared memory, the four codes stored as one 32-bit word, thread 0 storing
// the scale. The division is IEEE (no --use_fast_math), so that the codes
// equal the plain version's bit for bit; rintf rounds half to even as
// XLA's round-nearest-even does.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 1024;
constexpr int THREADS = 256;  // TILE / 4
constexpr float QMAX = 126.0f;

template <bool VEC>
__global__ void __launch_bounds__(THREADS) encode_kernel(const float* __restrict__ x, int8_t* __restrict__ out,
                                                         long long n, long long nt, long long width) {
  const long long b = blockIdx.x / nt;
  const long long t = blockIdx.x - b * nt;
  const long long col = t * TILE + 4LL * threadIdx.x;
  const float* row = x + b * n;
  float v[4];
  if (VEC && col + 4 <= n) {
    float4 q = *reinterpret_cast<const float4*>(row + col);
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = col + j < n ? row[col + j] : 0.0f;
  }
  float amax = 0.0f;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (isfinite(v[j])) amax = fmaxf(amax, fabsf(v[j]));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  __shared__ float warp_max[THREADS / 32];
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = amax;
  __syncthreads();
  amax = warp_max[0];
#pragma unroll
  for (int w = 1; w < THREADS / 32; ++w) amax = fmaxf(amax, warp_max[w]);
  const float scale = amax > 0.0f ? amax / QMAX : 1.0f;
  uint32_t word = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    int code;
    if (isnan(v[j])) {
      code = -128;
    } else if (isinf(v[j])) {
      code = v[j] > 0.0f ? 127 : -127;
    } else {
      code = (int)fminf(fmaxf(rintf(v[j] / scale), -QMAX), QMAX);
    }
    word |= (uint32_t)(uint8_t)(int8_t)code << (8 * j);
  }
  int8_t* orow = out + b * width;
  *reinterpret_cast<uint32_t*>(orow + t * TILE + 4LL * threadIdx.x) = word;
  if (threadIdx.x == 0) *reinterpret_cast<float*>(orow + nt * TILE + 4 * t) = scale;
}

template <bool VEC>
__global__ void __launch_bounds__(THREADS) decode_kernel(const int8_t* __restrict__ w, float* __restrict__ out,
                                                         long long n, long long nt, long long width) {
  const long long b = blockIdx.x / nt;
  const long long t = blockIdx.x - b * nt;
  const long long col = t * TILE + 4LL * threadIdx.x;
  const int8_t* wrow = w + b * width;
  const float scale = *reinterpret_cast<const float*>(wrow + nt * TILE + 4 * t);
  const uint32_t word = *reinterpret_cast<const uint32_t*>(wrow + col);
  float v[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int code = (int8_t)(uint8_t)(word >> (8 * j));
    float f = (float)code * scale;
    if (code == -128) f = __int_as_float(0x7fc00000);
    if (code == 127) f = __int_as_float(0x7f800000);
    if (code == -127) f = __int_as_float(0xff800000);
    v[j] = f;
  }
  float* orow = out + b * n;
  if (VEC && col + 4 <= n) {
    *reinterpret_cast<float4*>(orow + col) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (col + j < n) orow[col + j] = v[j];
  }
}

int check(long long rows, long long n, int device) {
  if (rows < 0 || n < 0) return (int)cudaErrorInvalidValue;
  if (rows == 0 || n == 0) return -1;  // nothing to do
  const long long nt = (n + TILE - 1) / TILE;
  if (rows * nt > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  return e == cudaSuccess ? 0 : (int)e;
}

}  // namespace

extern "C" {

// out (rows, npad + 4 nt) int8 = Q1's encode of x (rows, n) float32; both
// contiguous, out aligned to 4 bytes. Returns 0 or a CUDA error code.
int heat_quant_encode(const void* x, void* out, long long rows, long long n, int device, void* stream) {
  int rc = check(rows, n, device);
  if (rc != 0) return rc < 0 ? 0 : rc;
  const long long nt = (n + TILE - 1) / TILE;
  const long long width = nt * TILE + 4 * nt;
  const bool vec = n % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec)
    encode_kernel<true><<<(unsigned)(rows * nt), THREADS, 0, s>>>(static_cast<const float*>(x),
                                                                   static_cast<int8_t*>(out), n, nt, width);
  else
    encode_kernel<false><<<(unsigned)(rows * nt), THREADS, 0, s>>>(static_cast<const float*>(x),
                                                                    static_cast<int8_t*>(out), n, nt, width);
  return (int)cudaGetLastError();
}

// out (rows, n) float32 = Q1's decode of w (rows, npad + 4 nt) int8; w
// aligned to 4 bytes. Same conventions.
int heat_quant_decode(const void* w, void* out, long long rows, long long n, int device, void* stream) {
  int rc = check(rows, n, device);
  if (rc != 0) return rc < 0 ? 0 : rc;
  const long long nt = (n + TILE - 1) / TILE;
  const long long width = nt * TILE + 4 * nt;
  const bool vec = n % 4 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec)
    decode_kernel<true><<<(unsigned)(rows * nt), THREADS, 0, s>>>(static_cast<const int8_t*>(w),
                                                                   static_cast<float*>(out), n, nt, width);
  else
    decode_kernel<false><<<(unsigned)(rows * nt), THREADS, 0, s>>>(static_cast<const int8_t*>(w),
                                                                    static_cast<float*>(out), n, nt, width);
  return (int)cudaGetLastError();
}

const char* heat_quant_error_string(int code) { return cudaGetErrorString(static_cast<cudaError_t>(code)); }

}  // extern "C"
