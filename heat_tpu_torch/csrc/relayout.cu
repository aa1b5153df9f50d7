// Hand-written Hopper (sm_90a) kernels K5 and K6: the pack and unpack
// relayout copies of the packed pivot (heat_tpu_torch/kernels/relayout.py,
// used by heat_tpu_torch/redistribution/executor.py).
//
// relayout_pack (K5)  flat (rows * c_in,) -> (p, rows * c_out / p): every
//     c_in-element row is right-padded with zeros to c_out (p | c_out,
//     c_out >= c_in) and each of the p column blocks of cpp = c_out / p
//     columns is gathered contiguous: out[j, r * cpp + k] = in[r, j * cpp + k]
//     for j * cpp + k < c_in, else 0. Replaces
//     heat_tpu/kernels/relayout.py:169 _pack_call, the Pallas TPU kernel.
// relayout_unpack (K6)  its inverse: (p, rows * c_in / p) -> flat
//     (rows * c_out,) with c_out <= c_in, p | c_in, cpp = c_in / p:
//     out[r, c] = in[c / cpp, r * cpp + c % cpp] for c < c_out (the pad tail
//     of every row is dropped). Replaces relayout.py:194 _unpack_call.
//
// What bounds them on an H100 SXM: bytes. Each is a permutation plus a zero
// pad with no arithmetic on the values, so the least time is one read of the
// input and one write of the output at 3.35 TB/s: at the per-rank shape of
// the 1 GB move over 8 ranks (rows = 1,250,000, 25 <-> 32 float32 columns)
// 125 MB + 160 MB, 0.0851 ms.
//
// Design, and how it departs from the TPU kernels:
// * The TPU kernels stream flat (8, 128)-tiled VMEM blocks of b rows and do
//   the narrow reshape in registers, because a narrow-minor buffer wastes
//   most of every vector register there. Hopper has no such tiling: the
//   copy is indexed by OUTPUT element, so that neighbouring threads write
//   neighbouring addresses (coalesced stores), and each thread computes the
//   one input element it needs. Reads are then runs of cpp (pack) or of the
//   row's columns (unpack) elements; the rows a warp touches are adjacent,
//   so their sectors come from the same few cache lines.
// * Types: the kernels move raw words of the element's width (1, 2, 4, 8 or
//   16 bytes), never values, so every dtype (bool, bf16, complex128) comes
//   out bit for bit, NaN payloads and -0.0 included; pad entries are all
//   zero bits.
// * Indexing: element offsets are 64-bit; the launch takes a 32-bit index
//   type where every offset of the call fits in 32 bits (the division of an
//   index is the costliest instruction of the loop), else a 64-bit one.
// * Edge cases: rows = 0 launches nothing; p = 1 and c_in == c_out are
//   ordinary cases of the same index map.
// * Pack: block b writes ITEMS x 256 consecutive outputs of column block
//   b % p (one division an element); the p blocks of a tile run side by
//   side and read the same input rows, which then come from L2 and not
//   p times from device memory. Unpack: a grid-stride loop over the flat
//   output (two divisions an element), whose warps read runs of cpp
//   elements from each of the p column blocks.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct alignas(16) Word16 {
  unsigned long long lo, hi;
};

template <int B>
struct WordOf;
template <>
struct WordOf<1> { typedef uint8_t type; };
template <>
struct WordOf<2> { typedef uint16_t type; };
template <>
struct WordOf<4> { typedef uint32_t type; };
template <>
struct WordOf<8> { typedef unsigned long long type; };
template <>
struct WordOf<16> { typedef Word16 type; };

constexpr int THREADS = 256;
constexpr int ITEMS = 4;  // output elements a pack thread writes
constexpr unsigned MAX_BLOCKS_X = 132 * 64;

template <typename T, typename Idx>
__global__ void __launch_bounds__(THREADS) pack_kernel(const T* __restrict__ in, T* __restrict__ out, Idx rows,
                                                       Idx c_in, Idx cpp, Idx p) {
  // block b writes tile b / p of column block j = b % p: the p blocks of one
  // tile run side by side and read the same input rows, through L2
  const Idx per_block = rows * cpp;  // elements of one column block
  const Idx j = (Idx)blockIdx.x % p;
  const Idx tile = (Idx)blockIdx.x / p;
  T* dst = out + j * per_block;
  const Idx col0 = j * cpp;
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    const Idx e = tile * (THREADS * ITEMS) + (Idx)i * THREADS + threadIdx.x;
    if (e < per_block) {
      const Idx r = e / cpp;
      const Idx col = col0 + (e - r * cpp);
      dst[e] = col < c_in ? in[r * c_in + col] : T{};
    }
  }
}

template <typename T, typename Idx>
__global__ void __launch_bounds__(THREADS) unpack_kernel(const T* __restrict__ in, T* __restrict__ out, Idx rows,
                                                         Idx c_out, Idx cpp) {
  const Idx total = rows * c_out;
  const Idx per_block = rows * cpp;
  for (Idx e = (Idx)blockIdx.x * THREADS + threadIdx.x; e < total; e += (Idx)gridDim.x * THREADS) {
    const Idx r = e / c_out;
    const Idx col = e - r * c_out;
    const Idx j = col / cpp;
    out[e] = in[j * per_block + r * cpp + (col - j * cpp)];
  }
}

unsigned blocks_for(unsigned long long n) {
  unsigned long long b = (n + THREADS - 1) / THREADS;
  return (unsigned)(b < MAX_BLOCKS_X ? (b > 0 ? b : 1) : MAX_BLOCKS_X);
}

template <int B>
int launch_pack(const void* in, void* out, long long rows, long long c_in, long long c_out, long long p,
                cudaStream_t s) {
  typedef typename WordOf<B>::type T;
  const long long cpp = c_out / p;
  const unsigned long long span = (unsigned long long)rows * (unsigned long long)c_out;  // >= rows * c_in
  const unsigned long long tiles = ((unsigned long long)rows * cpp + THREADS * ITEMS - 1) / (THREADS * ITEMS);
  if (tiles * p > 0x7fffffffULL) return (int)cudaErrorInvalidValue;
  const unsigned grid = (unsigned)(tiles * p);
  if (span < (1ULL << 31))
    pack_kernel<T, uint32_t><<<grid, THREADS, 0, s>>>(static_cast<const T*>(in), static_cast<T*>(out),
                                                      (uint32_t)rows, (uint32_t)c_in, (uint32_t)cpp, (uint32_t)p);
  else
    pack_kernel<T, unsigned long long><<<grid, THREADS, 0, s>>>(static_cast<const T*>(in), static_cast<T*>(out),
                                                                rows, c_in, cpp, p);
  return (int)cudaGetLastError();
}

template <int B>
int launch_unpack(const void* in, void* out, long long rows, long long c_in, long long c_out, long long p,
                  cudaStream_t s) {
  typedef typename WordOf<B>::type T;
  const long long cpp = c_in / p;
  const unsigned long long span = (unsigned long long)rows * (unsigned long long)c_in;
  const unsigned grid = blocks_for((unsigned long long)rows * c_out);
  if (span < (1ULL << 31))
    unpack_kernel<T, uint32_t><<<grid, THREADS, 0, s>>>(static_cast<const T*>(in), static_cast<T*>(out),
                                                        (uint32_t)rows, (uint32_t)c_out, (uint32_t)cpp);
  else
    unpack_kernel<T, unsigned long long><<<grid, THREADS, 0, s>>>(static_cast<const T*>(in),
                                                                  static_cast<T*>(out), rows, c_out, cpp);
  return (int)cudaGetLastError();
}

typedef int (*Launch)(const void*, void*, long long, long long, long long, long long, cudaStream_t);

Launch pick(int elem_bytes, bool pack) {
  switch (elem_bytes) {
    case 1: return pack ? launch_pack<1> : launch_unpack<1>;
    case 2: return pack ? launch_pack<2> : launch_unpack<2>;
    case 4: return pack ? launch_pack<4> : launch_unpack<4>;
    case 8: return pack ? launch_pack<8> : launch_unpack<8>;
    case 16: return pack ? launch_pack<16> : launch_unpack<16>;
    default: return nullptr;
  }
}

int run(bool pack, const void* in, void* out, long long rows, long long c_in, long long c_out, long long p,
        int elem_bytes, int device, void* stream) {
  Launch launch = pick(elem_bytes, pack);
  if (launch == nullptr || rows < 0 || c_in < 0 || c_out < 0 || p < 1 || p > 65535) return (int)cudaErrorInvalidValue;
  if (pack ? (c_out % p != 0 || c_out < c_in) : (c_in % p != 0 || c_out > c_in)) return (int)cudaErrorInvalidValue;
  if (rows == 0 || (pack ? c_out : c_in) == 0 || (!pack && c_out == 0)) return 0;  // nothing to write
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  return launch(in, out, rows, c_in, c_out, p, static_cast<cudaStream_t>(stream));
}

}  // namespace

extern "C" {

// out (p, rows * c_out / p) = K5 of in (rows * c_in,); elements of elem_bytes
// (1, 2, 4, 8 or 16) bytes, both buffers contiguous and aligned to the
// element. Returns 0 or the CUDA error code of the launch.
int heat_relayout_pack(const void* in, void* out, long long rows, long long c_in, long long c_out, long long p,
                       int elem_bytes, int device, void* stream) {
  return run(true, in, out, rows, c_in, c_out, p, elem_bytes, device, stream);
}

// out (rows * c_out,) = K6 of in (p, rows * c_in / p). Same conventions.
int heat_relayout_unpack(const void* in, void* out, long long rows, long long c_in, long long c_out, long long p,
                         int elem_bytes, int device, void* stream) {
  return run(false, in, out, rows, c_in, c_out, p, elem_bytes, device, stream);
}

const char* heat_relayout_error_string(int code) { return cudaGetErrorString(static_cast<cudaError_t>(code)); }

}  // extern "C"
