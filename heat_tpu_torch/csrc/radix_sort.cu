// Hand-written Hopper (sm_90a) kernel K4: a stable LSD radix-256 sort of
// (u32 key, u32 payload) pairs in independent segments, with the key
// transforms of the sort family folded into its first and last passes.
//
// heat_radix_sort  For n_segments segments of seg_len pairs each, gives in
//     every segment the stable order of the pairs, lexicographic in
//     (key, payload): pay_bytes 8-bit passes over the payload's low bytes
//     first, then four over the key. pay_bytes = 0 carries the payload and
//     orders stably by key alone; with no payload given, the payload is the
//     position within the segment (the argsort). Replaces
//     heat_tpu/kernels/sort.py:253 _pallas_block_call, the Pallas TPU kernel
//     that sorts independent 512-pair blocks in VMEM.
//
// The keys are read as u32 words (mode WORDS, the plain pair-sort contract)
// or as the raw bits of float32 or int32 values, which the pass that reads
// them turns into words in registers: lax.sort's comparator order for
// float32 (every NaN to all-ones, -0.0 onto +0.0), IEEE totalOrder for
// float32 (the order of lax.top_k), or the int32 sign flip; `descending`
// complements the word there too. The pass that writes the result writes
// the words, or the values through the inverse transform (the canonical
// +0.0 and quiet NaN in the comparator's tie classes), or nothing; and the
// payloads as u32 words or as int64 indices. So a float32 sort reads 4 B
// and writes 4 + 8 B a pair with no elementwise kernel around it.
//
// What bounds it on an H100 SXM, by the roofline: bytes. A pass does a few
// dozen integer operations a pair, far below the integer rate. The least a
// sort of n float32 values to values and int64 indices can move is 16 B a
// pair: 2.147 GB, 0.6410 ms at 3.35 TB/s for n = 2^27.
//
// Two regimes in one source:
// (a) seg_len <= SEG_MAX (4096 pairs): a group of G warps per segment, 8 / G
//     segments a block: up to 256 pairs a group of one warp, then 2, 4 or 8
//     warps of 8 pairs a lane (16 above 2048 pairs). The pairs stay in
//     registers; a pass ranks them with each warp's own 256 counters, scans
//     the group's counters and places the pairs in shared memory, from
//     where the next pass reads them. The segment is read once and written
//     once, coalesced: 16 B a pair for a float32 sort. The first design gave every
//     segment a block of 8 warps, whose passes cleared and scanned 8 x 256
//     counters for 512 pairs.
// (b) one segment of any length below 2^31: a one-sweep LSD sort in the
//     style of Onesweep (Adinets and Merrill, 2022):
//     1. one launch reads the keys once and counts the digits of every
//        place at once, in shared memory and then with integer atomics into
//        a (places x 256) table, exact in any order;
//     2. a one-block launch scans each place into its digit bases, and marks
//        a place whose digit is the same for all keys: its pass would keep
//        the order, so it is skipped, on the device, with no host read;
//     3. one launch a place. Each block claims the next tile of 4096 pairs
//        through an atomic counter (so a tile only ever waits on tiles
//        already running), loads it into shared memory with 16-byte loads,
//        ranks it stably, publishes its per-digit counts to 64-bit status
//        words (kind | pass tag | count), places the tile in digit order in
//        a second shared buffer, and looks back over its predecessors'
//        status words, four tiles a read, for its prefix (decoupled
//        look-back). Then it writes each digit's run, coalesced, to base +
//        prefix + rank. A thread keeps only the ranks of its 16 pairs, so
//        that three blocks of 74 KB fit an SM.
//     The first pass that runs reads the input; the last writes the output.
//     Between them the pairs ping-pong between a scratch buffer and the
//     output's own memory, in the parity that lands the last pass in the
//     output whatever passes were skipped; if every place is constant, the
//     last place runs alone. The status words are zeroed once a call; the
//     pass tag tells one pass's words from the last's. A float32 sort moves
//     4 (histogram) + 12 + 16 + 16 + 20 = 68 B a pair, plus 2 KB of status
//     words a tile a pass.
//
// What else bounds it: the stable rank. Each pass ranks every pair with a
// shared-memory atomic OR into a per-warp mask of its digit's lanes
// (rank_warp). Measured on the H100, the rank is the longest phase of a
// tile, and a tile's phases (load, rank, scan, look-back, scatter) overlap
// only across the three blocks an SM holds.
//
// Stability, the contract: within a group of warps (a) or a tile (b), warp
// w owns the contiguous part w of the pairs, and each lane holds the warp's
// pairs 32 i + lane. A pass ranks them 32 at a time: the digit's mask word
// gives the lanes of one digit, a lane's rank is the number of its peers on
// lower lanes, and the group's lowest lane moves the warp's count for the
// digit on by the group's size. The exclusive scan runs over digits, then
// over warps in warp order, then (b) over tiles in tile order. So a pair
// lands after every earlier pair of its digit. The output is a permutation and
// every sum is an exact integer, so a rerun gives the same bits.
//
// The first design stays below, unchanged, behind heat_radix_pair_sort_pr3
// (words only): a block of 8 warps a segment (a), and three launches a pass
// (b): per-tile histograms, a (256 x tiles) table scan and a scatter.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;  // threads per block: one per digit bin
constexpr int WARPS = THREADS / 32;
constexpr int RADIX = 256;
constexpr int TILE = 4096;     // pairs of a tile in regime (b)
constexpr int SEG_MAX = TILE;  // longest segment of regime (a)
constexpr unsigned FULL = 0xffffffffu;
constexpr int PLACES_MAX = 8;  // 8-bit places: up to 4 payload bytes and the 4 key bytes

// ------------------------------------------------------------------------
// key transforms (kernels/sort.py: to_sortable, sort_key, from_sortable)
// ------------------------------------------------------------------------
enum Mode { WORDS = 0, F32 = 1, F32_TOTAL = 2, I32 = 3 };

// The radix word of the raw bits s; `flip` (0 or all ones) complements it
// for a descending sort.
__device__ __forceinline__ unsigned to_key(unsigned s, int mode, unsigned flip) {
  if (mode == F32) {
    if ((s & 0x7fffffffu) > 0x7f800000u) return 0xffffffffu ^ flip;  // every NaN, tied, last
    if (s == 0x80000000u) s = 0u;                                   // -0.0 ties +0.0
  }
  if (mode == F32 || mode == F32_TOTAL) s ^= (unsigned)((int)s >> 31) | 0x80000000u;
  else if (mode == I32) s ^= 0x80000000u;
  return s ^ flip;
}

// The value bits of a radix word: the inverse of to_key, canonical in the
// comparator's tie classes (+0.0, the quiet NaN).
__device__ __forceinline__ unsigned from_key(unsigned k, int mode, unsigned flip) {
  const unsigned u = k ^ flip;
  if (mode == F32 && u == 0xffffffffu) return 0x7fc00000u;
  if (mode == F32 || mode == F32_TOTAL) return (u & 0x80000000u) ? u ^ 0x80000000u : ~u;
  if (mode == I32) return u ^ 0x80000000u;
  return u;
}

// Where the last pass writes: the words or values (or nothing), and the
// payloads as u32 words or int64 indices.
struct Out {
  unsigned* v;
  void* i;
  int words;  // v gets the radix words (1) or the values (0)
  int idx64;
};

__device__ __forceinline__ void put(const Out& o, int mode, unsigned flip, long long at, unsigned k,
                                    unsigned p) {
  if (o.v) o.v[at] = o.words ? k : from_key(k, mode, flip);
  if (o.idx64)
    static_cast<long long*>(o.i)[at] = (long long)p;
  else
    static_cast<unsigned*>(o.i)[at] = p;
}

// The digit of place q: payload bytes first, then the key's.
__device__ __forceinline__ unsigned digit_at(unsigned k, unsigned p, int q, int pay_bytes) {
  return q < pay_bytes ? (p >> (8 * q)) & 255u : (k >> (8 * (q - pay_bytes))) & 255u;
}

// Exclusive prefix sum over the block's NT values, one per thread in
// thread order; *total gets the sum. `warp_tot` holds NT / 32 ints.
template <int NT = THREADS>
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
  for (int i = 0; i < NT / 32; ++i) {
    const int t = warp_tot[i];
    before += i < w ? t : 0;
    all += t;
  }
  __syncthreads();  // the caller may reuse warp_tot
  *total = all;
  return before + x - v;
}

// Stable rank of the warp's pairs: item i of a lane is the warp's pair
// 32 i + lane, dig[i] its digit (256 + lane for none). `cnt` holds the
// warp's 256 counts, 0 on entry; loc[i] gets the number of the warp's
// earlier pairs of the same digit. For each item in turn, each lane ORs its
// bit into its digit's word of `mm` (the warp's 256 mask words in shared
// memory, zero on entry and on return) and reads back the lanes that share
// its digit; the group's lowest lane moves the warp's count for the digit
// on by the group's size and clears the word. One shared atomic a pair and
// pass: measured on the H100 faster than eight ballots a pair (one a bit)
// or __match_any_sync, and never slower on skewed digits. The rank bounds
// both regimes.
template <int ITEMS>
__device__ __forceinline__ void rank_warp(const unsigned (&dig)[ITEMS], int (&loc)[ITEMS], int* cnt, unsigned* mm) {
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    const unsigned d = dig[i];
    const bool valid = d < RADIX;
    if (valid) atomicOr(&mm[d], 1u << lane);
    __syncwarp();
    const unsigned peers = valid ? mm[d] : 1u << lane;
    const int leader = __ffs(peers) - 1;
    __syncwarp();  // every lane has read its word before the leader clears it
    int at = 0;
    if (lane == leader && valid) {
      at = cnt[d];
      cnt[d] = at + __popc(peers);
      mm[d] = 0u;
    }
    loc[i] = __shfl_sync(FULL, at, leader) + __popc(peers & below);
    __syncwarp();
  }
}

// ------------------------------------------------------------------------
// regime (a): a group of G warps per segment, up to 16 pairs a lane
// ------------------------------------------------------------------------
struct Segs {
  const unsigned* in_k;
  const unsigned* in_p;  // null: the position within the segment
  Out out;
  long long n_segments;
  int seg_len;
  int pay_bytes;
  int mode;
  unsigned flip;
};

template <int G>
__device__ __forceinline__ void group_sync(int grp) {
  if (G == 1)
    __syncwarp();
  else
    asm volatile("bar.sync %0, %1;" ::"r"(1 + grp), "r"(32 * G) : "memory");
}

// The group's counts cnt[g][d] (warp g of the group, digit d) become the
// first place of warp g's pairs of digit d in the segment's digit order.
template <int G>
__device__ __forceinline__ void group_scan(int* cnt, int* gsum, int grp) {
  constexpr int DPT = RADIX / (32 * G);  // digits a thread
  const int lane = threadIdx.x & 31, gw = (threadIdx.x >> 5) % G;
  const int t = gw * 32 + lane;
  int tot[DPT];
  int run = 0;
#pragma unroll
  for (int e = 0; e < DPT; ++e) {
    const int d = t * DPT + e;
    int s = 0;
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const int c = cnt[g * RADIX + d];
      cnt[g * RADIX + d] = s;
      s += c;
    }
    tot[e] = s;
    run += s;
  }
  int x = run;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(FULL, x, o);
    if (lane >= o) x += y;
  }
  int before = 0;
  if (G > 1) {
    if (lane == 31) gsum[gw] = x;
    group_sync<G>(grp);
    for (int g = 0; g < gw; ++g) before += gsum[g];
  }
  int excl = before + x - run;
#pragma unroll
  for (int e = 0; e < DPT; ++e) {
    const int d = t * DPT + e;
#pragma unroll
    for (int g = 0; g < G; ++g) cnt[g * RADIX + d] += excl;
    excl += tot[e];
  }
}

template <int ITEMS>
constexpr size_t seg_smem_bytes() {
  return (2 * (size_t)WARPS * 32 * ITEMS + 2 * (size_t)WARPS * RADIX + WARPS) * sizeof(unsigned);
}

template <int ITEMS, int G>
__global__ void __launch_bounds__(THREADS, ITEMS <= 8 ? 4 : 1) seg_sort_kernel(Segs a) {
  constexpr int PART = 32 * ITEMS, CAP = PART * G, GROUPS = WARPS / G;
  extern __shared__ unsigned seg_smem[];
  unsigned* bk = seg_smem;               // the groups' keys
  unsigned* bp = bk + WARPS * PART;      // and payloads
  int* cnt = reinterpret_cast<int*>(bp + WARPS * PART);
  unsigned* masks = reinterpret_cast<unsigned*>(cnt + WARPS * RADIX);
  int* gsum = reinterpret_cast<int*>(masks + WARPS * RADIX);
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5, grp = w / G, gw = w % G;
  const long long seg = (long long)blockIdx.x * GROUPS + grp;
  if (seg >= a.n_segments) return;  // the whole group: no other group waits on it
  const int len = a.seg_len;
  const long long off = seg * len;
  unsigned* sk = bk + grp * CAP;
  unsigned* sp = bp + grp * CAP;
  int* mine = cnt + w * RADIX;
  unsigned* mm = masks + w * RADIX;
  for (int d = lane; d < RADIX; d += 32) mm[d] = 0u;
  unsigned k[ITEMS], p[ITEMS];
  int loc[ITEMS];
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    const int pos = gw * PART + 32 * i + lane;
    k[i] = p[i] = 0u;
    if (pos < len) {
      k[i] = to_key(a.in_k[off + pos], a.mode, a.flip);
      p[i] = a.in_p ? a.in_p[off + pos] : (unsigned)pos;
    }
  }
  const int places = a.pay_bytes + 4;
  for (int q = 0; q < places; ++q) {
    unsigned dig[ITEMS];
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) {
      const int pos = gw * PART + 32 * i + lane;
      dig[i] = pos < len ? digit_at(k[i], p[i], q, a.pay_bytes) : RADIX + lane;
    }
    for (int d = lane; d < RADIX; d += 32) mine[d] = 0;
    __syncwarp();
    rank_warp<ITEMS>(dig, loc, mine, mm);
    group_sync<G>(grp);
    group_scan<G>(cnt + grp * G * RADIX, gsum + grp * G, grp);
    group_sync<G>(grp);
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) {
      if (dig[i] < RADIX) {
        const int at = mine[dig[i]] + loc[i];
        sk[at] = k[i];
        sp[at] = p[i];
      }
    }
    group_sync<G>(grp);
    if (q + 1 < places) {
#pragma unroll
      for (int i = 0; i < ITEMS; ++i) {
        const int pos = gw * PART + 32 * i + lane;
        if (pos < len) {
          k[i] = sk[pos];
          p[i] = sp[pos];
        }
      }
    }
  }
  for (int i = gw * 32 + lane; i < len; i += 32 * G) put(a.out, a.mode, a.flip, off + i, sk[i], sp[i]);
}

// ------------------------------------------------------------------------
// regime (b): one sweep a place with decoupled look-back
// ------------------------------------------------------------------------
constexpr int SWEEP_TILE = 4096;  // pairs of a one-sweep tile
constexpr int SWEEP_THREADS = 256;
constexpr int SWEEP_WARPS = SWEEP_THREADS / 32;
constexpr int SWEEP_ITEMS = SWEEP_TILE / SWEEP_THREADS;  // pairs a thread
static_assert(SWEEP_THREADS >= RADIX && SWEEP_TILE % SWEEP_THREADS == 0, "a thread a digit, whole items a thread");
// status word: kind (2 bits) | pass tag (30 bits) | count (32 bits)
constexpr unsigned long long AGGREGATE = 1ull << 62;
constexpr unsigned long long INCLUSIVE = 2ull << 62;
constexpr unsigned long long TAG_MASK = ((1ull << 62) - 1) & ~0xffffffffull;

// The look-back's loads and stores are strong (never served from a stale
// L1 line) and relaxed: the kind, the pass tag and the count travel in one
// 64-bit word written by one store, so a reader can never pair a flag with
// a stale count, and nothing else a tile writes is read by another tile
// within the pass. Acquire and release would add fences to the chain that
// bounds the pass.
__device__ __forceinline__ void store_status(unsigned long long* p, unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ unsigned long long load_status(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

constexpr int LOOKBACK = 4;  // predecessors a look-back step reads at once

struct Sweep {
  const unsigned* in_k;  // keys of the first pass that runs: words or raw bits
  const unsigned* in_p;  // given payloads, or null: the position
  unsigned* tk0;        // ping-pong keys and payloads: 0 the scratch,
  unsigned* tp0;        // 1 the output's memory
  unsigned* tk1;
  unsigned* tp1;
  Out out;
  long long n;
  int pay_bytes;
  int mode;
  unsigned flip;
  const int* plan;             // per place: index among the passes that run, or -1; [PLACES_MAX]: how many run
  const unsigned* bases;       // [PLACES_MAX][RADIX] first place of each digit in the output
  unsigned long long* status;  // [tiles][RADIX]
  unsigned* tile_ctr;          // [PLACES_MAX]
};

// `len` words from `src` into shared `dst`, 16 bytes a load where aligned.
__device__ __forceinline__ void load_tile(const unsigned* __restrict__ src, int len, unsigned* dst) {
  int done = 0;
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const uint4* s4 = reinterpret_cast<const uint4*>(src);
    uint4* d4 = reinterpret_cast<uint4*>(dst);
    for (int i = threadIdx.x; i < (len >> 2); i += SWEEP_THREADS) d4[i] = __ldg(s4 + i);
    done = len & ~3;
  }
  for (int i = done + threadIdx.x; i < len; i += SWEEP_THREADS) dst[i] = __ldg(src + i);
}

__device__ __forceinline__ void count_key(unsigned* h, unsigned k, int pay_bytes) {
#pragma unroll
  for (int b = 0; b < 4; ++b) atomicAdd(&h[(pay_bytes + b) * RADIX + ((k >> (8 * b)) & 255u)], 1u);
}

// Step 1: the digit counts of every place, into hist[place][digit].
__global__ void __launch_bounds__(THREADS)
    sweep_hist_kernel(const unsigned* __restrict__ in_k, const unsigned* __restrict__ in_p, long long n,
                      int pay_bytes, int mode, unsigned flip, unsigned* __restrict__ hist) {
  __shared__ unsigned h[PLACES_MAX * RADIX];
  for (int i = threadIdx.x; i < PLACES_MAX * RADIX; i += THREADS) h[i] = 0u;
  __syncthreads();
  const long long stride = (long long)gridDim.x * THREADS;
  const long long first = (long long)blockIdx.x * THREADS + threadIdx.x;
  long long done = 0;
  if ((reinterpret_cast<uintptr_t>(in_k) & 15) == 0) {
    const uint4* k4 = reinterpret_cast<const uint4*>(in_k);
    for (long long i = first; i < n / 4; i += stride) {
      const uint4 v = __ldg(k4 + i);
      count_key(h, to_key(v.x, mode, flip), pay_bytes);
      count_key(h, to_key(v.y, mode, flip), pay_bytes);
      count_key(h, to_key(v.z, mode, flip), pay_bytes);
      count_key(h, to_key(v.w, mode, flip), pay_bytes);
    }
    done = n & ~3LL;
  }
  for (long long i = done + first; i < n; i += stride) count_key(h, to_key(__ldg(in_k + i), mode, flip), pay_bytes);
  if (in_p != nullptr && pay_bytes > 0) {
    for (long long i = first; i < n; i += stride) {
      const unsigned p = __ldg(in_p + i);
      for (int b = 0; b < pay_bytes; ++b) atomicAdd(&h[b * RADIX + ((p >> (8 * b)) & 255u)], 1u);
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < (pay_bytes + 4) * RADIX; i += THREADS)
    if (h[i]) atomicAdd(&hist[i], h[i]);
}

// Step 2 (one block): each place's digit bases, and which places run.
__global__ void __launch_bounds__(THREADS)
    sweep_plan_kernel(const unsigned* __restrict__ hist, unsigned* __restrict__ bases, int* __restrict__ plan,
                      int places, long long n) {
  __shared__ int warp_tot[WARPS];
  __shared__ int constant[PLACES_MAX];
  const int d = threadIdx.x;
  for (int q = 0; q < places; ++q) {
    const unsigned c = hist[q * RADIX + d];
    int all;
    bases[q * RADIX + d] = (unsigned)block_exclusive_scan((int)c, warp_tot, &all);
    const int same = __syncthreads_or((long long)c == n);
    if (d == 0) constant[q] = same;
  }
  __syncthreads();
  if (d == 0) {
    int runs = 0;
    for (int q = 0; q < places; ++q) plan[q] = constant[q] ? -1 : runs++;
    if (runs == 0) {  // every digit constant: the last place still lands the output
      plan[places - 1] = 0;
      runs = 1;
    }
    plan[PLACES_MAX] = runs;
  }
}

// Step 3: one stable counting-sort pass of the whole segment by place q.
// The tile lies in shared memory twice: as loaded (the first pass writes
// the transformed keys and the generated payloads back there) and in digit
// order; a thread keeps only the ranks of its 16 pairs, two to a register,
// so that three blocks fit an SM.
constexpr size_t SWEEP_SMEM = 4 * SWEEP_TILE * sizeof(unsigned);

__global__ void __launch_bounds__(SWEEP_THREADS, 768 / SWEEP_THREADS) sweep_pass_kernel(Sweep a, int q) {
  extern __shared__ __align__(16) unsigned sweep_smem[];
  unsigned* ld_k = sweep_smem;
  unsigned* ld_p = ld_k + SWEEP_TILE;
  unsigned* st_k = ld_p + SWEEP_TILE;
  unsigned* st_p = st_k + SWEEP_TILE;
  __shared__ int cnt[SWEEP_WARPS * RADIX];
  __shared__ int gofs[RADIX];
  __shared__ int warp_tot[SWEEP_WARPS];
  __shared__ int s_tile;
  const int j = a.plan[q], runs = a.plan[PLACES_MAX];
  if (j < 0) return;  // a constant digit: this pass would keep the order
  const bool first = j == 0, last = j == runs - 1;
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  if (tid == 0) s_tile = (int)atomicAdd(&a.tile_ctr[q], 1u);
  // the rank's mask words live in st_k until the tile is placed there
  for (int i = tid; i < SWEEP_WARPS * RADIX; i += SWEEP_THREADS) {
    cnt[i] = 0;
    st_k[i] = 0u;
  }
  __syncthreads();
  const int tile = s_tile;
  const long long t0 = (long long)tile * SWEEP_TILE;
  const int len = (int)min((long long)SWEEP_TILE, a.n - t0);
  // pass j reads what pass j - 1 wrote; the last pass reads buffer 0
  const bool from1 = ((runs - 1 - j) & 1) != 0;
  const unsigned* sk = first ? a.in_k : from1 ? a.tk1 : a.tk0;
  const unsigned* sp = first ? a.in_p : from1 ? a.tp1 : a.tp0;
  const bool generated = sp == nullptr;
  load_tile(sk + t0, len, ld_k);
  if (!generated) load_tile(sp + t0, len, ld_p);
  __syncthreads();
  int* mine = cnt + w * RADIX;
  int loc[SWEEP_ITEMS];
  {
    unsigned dig[SWEEP_ITEMS];
#pragma unroll
    for (int i = 0; i < SWEEP_ITEMS; ++i) {
      const int pos = w * 32 * SWEEP_ITEMS + 32 * i + lane;
      dig[i] = RADIX + lane;
      if (pos < len) {
        unsigned k = ld_k[pos], p = 0u;
        if (first) {
          k = to_key(k, a.mode, a.flip);
          ld_k[pos] = k;
        }
        if (generated) {
          p = (unsigned)(t0 + pos);
          ld_p[pos] = p;
        } else if (q < a.pay_bytes) {
          p = ld_p[pos];
        }
        dig[i] = digit_at(k, p, q, a.pay_bytes);
      }
    }
    rank_warp<SWEEP_ITEMS>(dig, loc, mine, st_k + w * RADIX);
  }
  __syncthreads();
  // thread d < 256: the tile's count of digit d, published at once, and
  // the first place of each warp's pairs of digit d in the tile's digit order
  const int d = tid;
  int tot = 0;
  const unsigned long long tag = (unsigned long long)(q + 1) << 32;
  unsigned long long* status = a.status + (long long)tile * RADIX + (d & (RADIX - 1));
  if (d < RADIX) {
#pragma unroll
    for (int v = 0; v < SWEEP_WARPS; ++v) {
      const int c = cnt[v * RADIX + d];
      cnt[v * RADIX + d] = tot;
      tot += c;
    }
    store_status(status, (tile == 0 ? INCLUSIVE : AGGREGATE) | tag | (unsigned)tot);
  }
  int all;
  const int start = block_exclusive_scan<SWEEP_THREADS>(tot, warp_tot, &all);
  if (d < RADIX) {
#pragma unroll
    for (int v = 0; v < SWEEP_WARPS; ++v) cnt[v * RADIX + d] += start;
  }
  __syncthreads();
  // the tile in digit order
#pragma unroll
  for (int i = 0; i < SWEEP_ITEMS; ++i) {
    const int pos = w * 32 * SWEEP_ITEMS + 32 * i + lane;
    if (pos < len) {
      const unsigned k = ld_k[pos], p = ld_p[pos];
      const int at = mine[digit_at(k, p, q, a.pay_bytes)] + loc[i];
      st_k[at] = k;
      st_p[at] = p;
    }
  }
  // decoupled look-back: the pairs of digit d in all earlier tiles, read
  // LOOKBACK tiles at a time, down to the first inclusive prefix
  long long excl = 0;
  if (tile > 0 && d < RADIX) {
    for (long long t = tile - 1;; t -= LOOKBACK) {
      unsigned long long v[LOOKBACK];
#pragma unroll
      for (int b = 0; b < LOOKBACK; ++b) v[b] = t - b >= 0 ? load_status(a.status + (t - b) * RADIX + d) : 0ull;
      bool found = false;
#pragma unroll
      for (int b = 0; b < LOOKBACK; ++b) {
        if (found || t - b < 0) continue;
        while ((v[b] & TAG_MASK) != tag) v[b] = load_status(a.status + (t - b) * RADIX + d);
        excl += (unsigned)v[b];
        found = (v[b] >> 62) == 2;
      }
      if (found) break;
    }
    store_status(status, INCLUSIVE | tag | (unsigned)(excl + tot));
  }
  if (d < RADIX) gofs[d] = (int)((long long)a.bases[q * RADIX + d] + excl - start);
  __syncthreads();
  // each digit's run to its place, neighbouring threads on neighbouring words
  unsigned* dk = from1 ? a.tk0 : a.tk1;  // pass j writes what pass j + 1 reads
  unsigned* dp = from1 ? a.tp0 : a.tp1;
  for (int i = tid; i < len; i += SWEEP_THREADS) {
    const unsigned k = st_k[i], p = st_p[i];
    const long long at = (long long)gofs[digit_at(k, p, q, a.pay_bytes)] + i;
    if (last) {
      put(a.out, a.mode, a.flip, at, k, p);
    } else {
      dk[at] = k;
      dp[at] = p;
    }
  }
}

// ------------------------------------------------------------------------
// The first design, kept for comparison (words only)
// ------------------------------------------------------------------------
// shared memory besides the pair buffers: per-warp counts, digit bases,
// the tile's global bases, the scan's warp totals
constexpr size_t AUX_INTS = (size_t)WARPS * RADIX + RADIX + RADIX + WARPS;

__host__ __device__ inline size_t shared_bytes(int len) {
  return (4 * (size_t)len + AUX_INTS) * sizeof(unsigned);
}

__device__ __forceinline__ unsigned digit_of(unsigned key, unsigned pay, int shift, int from_pay) {
  return ((from_pay ? pay : key) >> shift) & 255u;
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

// ------------------------------------------------------------------------
// host side
// ------------------------------------------------------------------------
bool valid_shape(long long n_segments, int seg_len, int pay_bytes, bool has_pays) {
  if (n_segments < 0 || seg_len < 1 || pay_bytes < 0 || pay_bytes > 4) return false;
  if (!has_pays && pay_bytes != 0) return false;
  if (seg_len > SEG_MAX && n_segments > 1) return false;
  return n_segments <= 0x7fffffffLL;
}

long long tiles_of(int seg_len, int tile = TILE) { return ((long long)seg_len + tile - 1) / tile; }

// words of regime (b)'s state after the scratch key and payload buffers:
// histograms, bases, plan and tile counters, then the 64-bit status words
constexpr long long STATE_HEAD = 2LL * PLACES_MAX * RADIX + 32;

template <int ITEMS, int G>
cudaError_t launch_segments(const Segs& a, cudaStream_t s) {
  constexpr int GROUPS = WARPS / G;
  constexpr size_t bytes = seg_smem_bytes<ITEMS>();
  if (bytes > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(seg_sort_kernel<ITEMS, G>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return e;
  }
  const long long blocks = (a.n_segments + GROUPS - 1) / GROUPS;
  seg_sort_kernel<ITEMS, G><<<(unsigned)blocks, THREADS, bytes, s>>>(a);
  return cudaGetLastError();
}

cudaError_t sort_segments(const Segs& a, cudaStream_t s) {
  const int len = a.seg_len;
  if (len <= 32) return launch_segments<1, 1>(a, s);
  if (len <= 64) return launch_segments<2, 1>(a, s);
  if (len <= 128) return launch_segments<4, 1>(a, s);
  if (len <= 256) return launch_segments<8, 1>(a, s);
  if (len <= 512) return launch_segments<8, 2>(a, s);
  if (len <= 1024) return launch_segments<8, 4>(a, s);
  if (len <= 2048) return launch_segments<8, 8>(a, s);
  return launch_segments<16, 8>(a, s);
}

}  // namespace

extern "C" {

// Longest segment sorted by one group of warps in shared memory (regime a).
int heat_radix_seg_max() { return SEG_MAX; }

// 32-bit words of device scratch the caller allocates for a sort of this
// shape: none in regime (a); in regime (b) a key and a payload buffer, the
// histograms, plan and tile counters, and two words a digit a tile of
// status. The caller allocates; the sort zeroes what it needs.
long long heat_radix_scratch_words(long long n_segments, int seg_len) {
  if (n_segments < 1 || seg_len <= SEG_MAX) return 0;
  return 2LL * seg_len + STATE_HEAD + 2LL * RADIX * tiles_of(seg_len, SWEEP_TILE);
}

// The sort. keys: u32 words (mode 0) or the raw bits of float32 (1: the
// comparator's order; 2: totalOrder) or int32 (3) values; pays: u32 words,
// or null for the position within the segment. out_v gets the radix words
// (out_words = 1) or the values through the inverse transform (0), or
// nothing when null; out_i the payloads, as int64 (idx64 = 1) or u32 words.
// descending complements the radix word. Every array holds n_segments *
// seg_len elements on `device`; in regime (b), out_i (as int64) or out_v
// and out_i (as words) also serve as the second ping-pong buffer. Returns 0
// or the CUDA error code of the first failing call.
int heat_radix_sort(const unsigned* keys, const unsigned* pays, unsigned* out_v, void* out_i,
                    unsigned* scratch, long long n_segments, int seg_len, int pay_bytes, int mode,
                    int descending, int out_words, int idx64, int device, void* stream) {
  if (!valid_shape(n_segments, seg_len, pay_bytes, pays != nullptr) || mode < 0 || mode > 3 ||
      out_i == nullptr || (!idx64 && out_v == nullptr))
    return (int)cudaErrorInvalidValue;
  if (n_segments == 0) return 0;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned flip = descending ? 0xffffffffu : 0u;
  const Out out{out_v, out_i, out_words, idx64};
  if (seg_len <= SEG_MAX) {
    const Segs a{keys, pays, out, n_segments, seg_len, pay_bytes, mode, flip};
    return (int)sort_segments(a, s);
  }
  if (scratch == nullptr) return (int)cudaErrorInvalidValue;
  const long long n = seg_len;
  const int tiles = (int)tiles_of(seg_len, SWEEP_TILE);
  const int places = pay_bytes + 4;
  unsigned* hist = scratch + 2 * n;
  unsigned* bases = hist + PLACES_MAX * RADIX;
  int* plan = reinterpret_cast<int*>(bases + PLACES_MAX * RADIX);
  unsigned* tile_ctr = reinterpret_cast<unsigned*>(plan + 16);
  unsigned long long* status = reinterpret_cast<unsigned long long*>(tile_ctr + 16);
  e = cudaMemsetAsync(hist, 0, (STATE_HEAD + 2LL * RADIX * tiles) * sizeof(unsigned), s);
  if (e != cudaSuccess) return (int)e;
  int sms = 0;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return (int)e;
  const long long want = (n + 16LL * THREADS - 1) / (16LL * THREADS);
  const int hist_blocks = (int)(want < 8LL * sms ? want : 8LL * sms);
  sweep_hist_kernel<<<hist_blocks, THREADS, 0, s>>>(keys, pays, n, pay_bytes, mode, flip, hist);
  sweep_plan_kernel<<<1, THREADS, 0, s>>>(hist, bases, plan, places, n);
  Sweep a{};
  a.in_k = keys;
  a.in_p = pays;
  a.tk0 = scratch;
  a.tp0 = scratch + n;
  if (idx64) {
    a.tk1 = static_cast<unsigned*>(out_i);
    a.tp1 = static_cast<unsigned*>(out_i) + n;
  } else {
    a.tk1 = out_v;
    a.tp1 = static_cast<unsigned*>(out_i);
  }
  a.out = out;
  a.n = n;
  a.pay_bytes = pay_bytes;
  a.mode = mode;
  a.flip = flip;
  a.plan = plan;
  a.bases = bases;
  a.status = status;
  a.tile_ctr = tile_ctr;
  e = cudaFuncSetAttribute(sweep_pass_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SWEEP_SMEM);
  if (e != cudaSuccess) return (int)e;
  for (int q = 0; q < places; ++q) sweep_pass_kernel<<<tiles, SWEEP_THREADS, SWEEP_SMEM, s>>>(a, q);
  return (int)cudaGetLastError();
}

// The first design's scratch: the second key and payload buffers, the (256 x tiles)
// table and the 256 digit totals in regime (b).
long long heat_radix_scratch_words_pr3(long long n_segments, int seg_len) {
  if (n_segments < 1 || seg_len <= SEG_MAX) return 0;
  return 2LL * seg_len + (long long)RADIX * tiles_of(seg_len) + RADIX;
}

// The first design's sort of u32 words, kept to time it beside the new.
int heat_radix_pair_sort_pr3(const unsigned* keys, const unsigned* pays, unsigned* out_k,
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
