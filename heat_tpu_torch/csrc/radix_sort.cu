// Hand-written Hopper (sm_90a) kernel K4: a stable LSD radix-256 sort of
// (u32 key, u32 payload) pairs in independent segments.
//
// radix_pair_sort  For n_segments segments of seg_len pairs each, gives in
//     every segment the stable order of the pairs, lexicographic in
//     (key, payload): pay_bytes 8-bit passes over the payload's low bytes
//     first, then four over the key. pay_bytes = 0 carries the payload and
//     orders stably by key alone; with no payload given, the payload is the
//     position within the segment (the argsort). Replaces
//     heat_tpu/kernels/sort.py:253 _pallas_block_call, the Pallas TPU kernel
//     that sorts independent 512-pair blocks in VMEM.
//
// What bounds it on an H100 SXM: bytes. Every pass moves each pair through
// device memory or shared memory with a handful of integer operations, far
// below the integer rate. The least any sort of n pairs with a generated
// payload can move is one read of the keys and one write of keys and
// payloads, 12 B a pair: 1.611 GB, 0.4808 ms at 3.35 TB/s for n = 2^27.
//
// Two regimes in one source:
// (a) seg_len <= SEG_MAX (4096 pairs): one thread block per segment. The
//     segment is read once into shared memory, every pass runs there between
//     two shared buffers, and the result is written once: 12 B a pair of
//     device memory with a generated payload, 16 B with a given one. This is
//     the TPU kernel's shape (independent blocks), done with a scatter in
//     shared memory where the TPU kernel needed a one-hot permutation matmul.
// (b) one segment of any length below 2^31: every pass is three launches:
//     1. per-tile (4096 pairs) digit histograms into a (256 x tiles) table;
//     2. one block per digit scans its row of the table in tile order, into
//        the exclusive prefix and the digit's total;
//     3. per tile: the digit bases (the exclusive scan of the totals), a
//        stable rank of the tile in shared memory, and the scatter of keys
//        and payloads to base + row prefix + rank, ping-ponging between two
//        device buffers so that the last pass writes the output. The tile is
//        first placed in digit order in shared memory, so that neighbouring
//        threads write neighbouring addresses within each digit's run.
//     A pass moves about 21 B a pair (4 read for the histogram, 8 read and 8
//     written by the scatter, 1 for the table); the first reads 4 less when
//     the payload is generated.
//
// Stability, the contract: within a block, warp w owns the contiguous part
// w of the pairs. A pass counts each warp's digits, takes the exclusive scan
// over digits and then over warps in warp order, and each warp walks its part
// in order, 32 pairs a step: __match_any_sync groups the lanes of one digit,
// a lane's rank is the number of its peers on lower lanes, and the group's
// lowest lane moves the warp's count for the digit on by the group's size
// before the next step. So a pair lands after every earlier pair of its
// digit. The output is a permutation, so a rerun gives the same bits; the
// table's sums are exact integers in a fixed order.
//
// Left for later work: decoupled look-back (one sweep a pass), more bits a
// pass, TMA loads, and the skip of a pass whose digit is constant.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;  // threads per block: one per digit bin
constexpr int WARPS = THREADS / 32;
constexpr int RADIX = 256;
constexpr int TILE = 4096;     // pairs of a tile in regime (b)
constexpr int SEG_MAX = TILE;  // longest segment of regime (a)
constexpr unsigned FULL = 0xffffffffu;

// shared memory besides the pair buffers: per-warp counts, digit bases,
// the tile's global bases, the scan's warp totals
constexpr size_t AUX_INTS = (size_t)WARPS * RADIX + RADIX + RADIX + WARPS;

__host__ __device__ inline size_t shared_bytes(int len) {
  return (4 * (size_t)len + AUX_INTS) * sizeof(unsigned);
}

__device__ __forceinline__ unsigned digit_of(unsigned key, unsigned pay, int shift, int from_pay) {
  return ((from_pay ? pay : key) >> shift) & 255u;
}

// Exclusive prefix sum over the block's THREADS values, one per thread in
// thread order; *total gets the sum. `warp_tot` holds WARPS ints.
__device__ __forceinline__ int block_exclusive_scan(int v, int* warp_tot, int* total) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(FULL, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_tot[w] = x;
  __syncthreads();
  int before = 0, all = 0;
#pragma unroll
  for (int i = 0; i < WARPS; ++i) {
    const int t = warp_tot[i];
    before += i < w ? t : 0;
    all += t;
  }
  __syncthreads();  // the caller may reuse warp_tot
  *total = all;
  return before + x - v;
}

// One stable counting-sort pass of the `len` pairs (sk, sp) into (dk, dp),
// all in shared memory, by the digit at `shift` of the key or the payload.
// On return, bin_base[d] is the first place of digit d in (dk, dp).
__device__ void local_pass(const unsigned* sk, const unsigned* sp, unsigned* dk, unsigned* dp,
                           int len, int shift, int from_pay, int* cnt, int* bin_base,
                           int* warp_tot) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int part = (len + WARPS - 1) / WARPS;
  const int lo = min(w * part, len), hi = min(lo + part, len);
  const unsigned below = (1u << lane) - 1u;
  int* mine = cnt + w * RADIX;
  for (int d = lane; d < RADIX; d += 32) mine[d] = 0;
  __syncwarp();
  // 1. the warp's digit counts; one lane per digit group adds, so no atomics
  for (int s = lo; s < hi; s += 32) {
    const int i = s + lane;
    const unsigned dig = i < hi ? digit_of(sk[i], sp[i], shift, from_pay) : 256u + lane;
    const unsigned peers = __match_any_sync(FULL, dig);
    if (i < hi && (peers & below) == 0) mine[dig] += __popc(peers);
    __syncwarp();
  }
  __syncthreads();
  // 2. thread d: the digit's total, its base over digits, each warp's start
  const int d = threadIdx.x;
  int total = 0;
  for (int v = 0; v < WARPS; ++v) total += cnt[v * RADIX + d];
  int all;
  int run = block_exclusive_scan(total, warp_tot, &all);
  bin_base[d] = run;
  for (int v = 0; v < WARPS; ++v) {
    const int c = cnt[v * RADIX + d];
    cnt[v * RADIX + d] = run;
    run += c;
  }
  __syncthreads();
  // 3. each warp places its part in order, 32 pairs a step
  for (int s = lo; s < hi; s += 32) {
    const int i = s + lane;
    const bool valid = i < hi;
    unsigned k = 0, p = 0, dig = 256u + lane;  // lanes past the part match nothing
    if (valid) {
      k = sk[i];
      p = sp[i];
      dig = digit_of(k, p, shift, from_pay);
    }
    const unsigned peers = __match_any_sync(FULL, dig);
    const int rank = __popc(peers & below);
    const int at = valid ? mine[dig] : 0;
    __syncwarp();
    if (valid && rank == 0) mine[dig] = at + __popc(peers);
    __syncwarp();
    if (valid) {
      dk[at + rank] = k;
      dp[at + rank] = p;
    }
  }
  __syncthreads();
}

// Regime (a): block b sorts segment b entirely in shared memory.
__global__ void __launch_bounds__(THREADS)
    segment_sort_kernel(const unsigned* __restrict__ keys, const unsigned* __restrict__ pays,
                        unsigned* __restrict__ out_k, unsigned* __restrict__ out_p, int seg_len,
                        int pay_bytes) {
  extern __shared__ unsigned smem[];
  unsigned* k0 = smem;
  unsigned* p0 = k0 + seg_len;
  unsigned* k1 = p0 + seg_len;
  unsigned* p1 = k1 + seg_len;
  int* cnt = reinterpret_cast<int*>(p1 + seg_len);
  int* bin_base = cnt + WARPS * RADIX;
  int* warp_tot = bin_base + 2 * RADIX;
  const long long off = (long long)blockIdx.x * seg_len;
  for (int i = threadIdx.x; i < seg_len; i += THREADS) {
    k0[i] = keys[off + i];
    p0[i] = pays ? pays[off + i] : (unsigned)i;
  }
  __syncthreads();
  for (int q = 0; q < pay_bytes + 4; ++q) {
    const int from_pay = q < pay_bytes;
    local_pass(k0, p0, k1, p1, seg_len, 8 * (from_pay ? q : q - pay_bytes), from_pay, cnt,
               bin_base, warp_tot);
    unsigned* t = k0;
    k0 = k1;
    k1 = t;
    t = p0;
    p0 = p1;
    p1 = t;
  }
  for (int i = threadIdx.x; i < seg_len; i += THREADS) {
    out_k[off + i] = k0[i];
    out_p[off + i] = p0[i];
  }
}

// Regime (b), step 1: the digit histogram of each tile, table[d][tile].
__global__ void __launch_bounds__(THREADS)
    tile_hist_kernel(const unsigned* __restrict__ src, long long n, int shift,
                     unsigned* __restrict__ table, int tiles) {
  __shared__ int hist[RADIX];
  const int lane = threadIdx.x & 31;
  hist[threadIdx.x] = 0;
  __syncthreads();
  const long long t0 = (long long)blockIdx.x * TILE;
  const int len = (int)min((long long)TILE, n - t0);
  for (int s = 0; s < len; s += THREADS) {
    const int i = s + threadIdx.x;
    const unsigned dig = i < len ? (src[t0 + i] >> shift) & 255u : 256u + lane;
    const unsigned peers = __match_any_sync(FULL, dig);
    if (i < len && (peers & ((1u << lane) - 1u)) == 0) atomicAdd(&hist[dig], __popc(peers));
  }
  __syncthreads();
  table[(long long)threadIdx.x * tiles + blockIdx.x] = hist[threadIdx.x];
}

// Regime (b), step 2: block d turns row d of the table into its exclusive
// prefix sum over tiles, in tile order, and writes the row's total.
__global__ void __launch_bounds__(THREADS)
    scan_rows_kernel(unsigned* __restrict__ table, int tiles, unsigned* __restrict__ totals) {
  constexpr int ITEMS = 16;
  __shared__ unsigned chunk[THREADS * ITEMS];
  __shared__ int warp_tot[WARPS];
  unsigned* row = table + (long long)blockIdx.x * tiles;
  unsigned carry = 0;
  for (int s = 0; s < tiles; s += THREADS * ITEMS) {
    for (int j = threadIdx.x; j < THREADS * ITEMS; j += THREADS)
      chunk[j] = s + j < tiles ? row[s + j] : 0u;
    __syncthreads();
    unsigned* mine = chunk + threadIdx.x * ITEMS;
    int sum = 0;
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) sum += (int)mine[j];
    int all;
    unsigned run = carry + (unsigned)block_exclusive_scan(sum, warp_tot, &all);
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) {
      const unsigned c = mine[j];
      mine[j] = run;
      run += c;
    }
    __syncthreads();
    for (int j = threadIdx.x; j < THREADS * ITEMS; j += THREADS)
      if (s + j < tiles) row[s + j] = chunk[j];
    carry += (unsigned)all;
    __syncthreads();
  }
  if (threadIdx.x == 0) totals[blockIdx.x] = carry;
}

// Regime (b), step 3: rank each tile stably and scatter it. A null sp_g
// generates the payload: the pair's position.
__global__ void __launch_bounds__(THREADS)
    tile_scatter_kernel(const unsigned* __restrict__ sk_g, const unsigned* __restrict__ sp_g,
                        unsigned* __restrict__ dk_g, unsigned* __restrict__ dp_g, long long n,
                        int shift, int from_pay, const unsigned* __restrict__ table,
                        const unsigned* __restrict__ totals, int tiles) {
  extern __shared__ unsigned smem[];
  unsigned* k0 = smem;
  unsigned* p0 = k0 + TILE;
  unsigned* k1 = p0 + TILE;
  unsigned* p1 = k1 + TILE;
  int* cnt = reinterpret_cast<int*>(p1 + TILE);
  int* bin_base = cnt + WARPS * RADIX;
  int* gofs = bin_base + RADIX;
  int* warp_tot = gofs + RADIX;
  const long long t0 = (long long)blockIdx.x * TILE;
  const int len = (int)min((long long)TILE, n - t0);
  for (int i = threadIdx.x; i < len; i += THREADS) {
    k0[i] = sk_g[t0 + i];
    p0[i] = sp_g ? sp_g[t0 + i] : (unsigned)(t0 + i);
  }
  // where this tile's run of each digit starts in the output
  const int d = threadIdx.x;
  int all;
  const int base = block_exclusive_scan((int)totals[d], warp_tot, &all);
  gofs[d] = base + (int)table[(long long)d * tiles + blockIdx.x];
  __syncthreads();
  local_pass(k0, p0, k1, p1, len, shift, from_pay, cnt, bin_base, warp_tot);
  for (int j = threadIdx.x; j < len; j += THREADS) {
    const unsigned k = k1[j], p = p1[j];
    const unsigned dig = digit_of(k, p, shift, from_pay);
    const long long at = (long long)gofs[dig] + (j - bin_base[dig]);
    dk_g[at] = k;
    dp_g[at] = p;
  }
}

bool valid_shape(long long n_segments, int seg_len, int pay_bytes, bool has_pays) {
  if (n_segments < 0 || seg_len < 1 || pay_bytes < 0 || pay_bytes > 4) return false;
  if (!has_pays && pay_bytes != 0) return false;
  if (seg_len > SEG_MAX && n_segments > 1) return false;
  return n_segments <= 0x7fffffffLL;
}

long long tiles_of(int seg_len) { return ((long long)seg_len + TILE - 1) / TILE; }

}  // namespace

extern "C" {

// Longest segment sorted by one block in shared memory (regime a).
int heat_radix_seg_max() { return SEG_MAX; }

// 32-bit words of device scratch the caller allocates for a sort of this
// shape: none in regime (a); in regime (b) the second key and payload
// buffers, the (256 x tiles) table and the 256 digit totals.
long long heat_radix_scratch_words(long long n_segments, int seg_len) {
  if (n_segments < 1 || seg_len <= SEG_MAX) return 0;
  return 2LL * seg_len + (long long)RADIX * tiles_of(seg_len) + RADIX;
}

// keys, pays (null: the position within the segment), out_k, out_p:
// n_segments * seg_len u32 words each on `device`. Returns 0 or the CUDA
// error code of the first failing call.
int heat_radix_pair_sort(const unsigned* keys, const unsigned* pays, unsigned* out_k,
                         unsigned* out_p, unsigned* scratch, long long n_segments, int seg_len,
                         int pay_bytes, int device, void* stream) {
  if (!valid_shape(n_segments, seg_len, pay_bytes, pays != nullptr))
    return (int)cudaErrorInvalidValue;
  if (n_segments == 0) return 0;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int passes = pay_bytes + 4;
  if (seg_len <= SEG_MAX) {
    e = cudaFuncSetAttribute(segment_sort_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)shared_bytes(SEG_MAX));
    if (e != cudaSuccess) return (int)e;
    segment_sort_kernel<<<(unsigned)n_segments, THREADS, shared_bytes(seg_len), s>>>(
        keys, pays, out_k, out_p, seg_len, pay_bytes);
    return (int)cudaGetLastError();
  }
  if (scratch == nullptr) return (int)cudaErrorInvalidValue;
  e = cudaFuncSetAttribute(tile_scatter_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)shared_bytes(TILE));
  if (e != cudaSuccess) return (int)e;
  const long long n = seg_len;
  const int tiles = (int)tiles_of(seg_len);
  unsigned* tmp_k = scratch;
  unsigned* tmp_p = scratch + n;
  unsigned* table = scratch + 2 * n;
  unsigned* totals = table + (long long)RADIX * tiles;
  const unsigned* src_k = keys;
  const unsigned* src_p = pays;
  for (int q = 0; q < passes; ++q) {
    const int from_pay = q < pay_bytes;
    const int shift = 8 * (from_pay ? q : q - pay_bytes);
    // the last pass lands in the output
    const bool to_out = (passes - 1 - q) % 2 == 0;
    unsigned* dst_k = to_out ? out_k : tmp_k;
    unsigned* dst_p = to_out ? out_p : tmp_p;
    tile_hist_kernel<<<tiles, THREADS, 0, s>>>(from_pay ? src_p : src_k, n, shift, table, tiles);
    scan_rows_kernel<<<RADIX, THREADS, 0, s>>>(table, tiles, totals);
    tile_scatter_kernel<<<tiles, THREADS, shared_bytes(TILE), s>>>(
        src_k, src_p, dst_k, dst_p, n, shift, from_pay, table, totals, tiles);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    src_k = dst_k;
    src_p = dst_p;
  }
  return 0;
}

const char* heat_radix_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
