// Hand-written Hopper (sm_90a) kernel of K8, the brick SDDMM, on the tensor
// cores in 3xTF32: for every (8, 128) brick t of a DBCSR slab,
//     out[t] = sdata[t] * (u[8 brow[t] : +8] @ v[128 bcol[t] : +128]^T),
// with u (m, d) and v (n, d) row-major float32, read as zero past their
// last rows. Replaces heat_tpu/kernels/spmm.py::_brick_sddmm_call (:265).
// It serves d % 4 == 0 with u, sdata and out on 16 bytes (TMA's rule);
// every other d keeps spmm.cu's kernel (brick_sddmm_kernel).
//
// What bounds it on an H100 SXM. Each brick is read and written once (8 KB)
// and takes 2 * 1024 * d operations. At the card-scale shape (1,048,576
// bricks, d = 64) that is 8.6 GB (2.56 ms at 3.35 TB/s) against 137 GFLOP:
// 2.05 ms on the CUDA cores' 67 TFLOP/s, which is why spmm.cu's FP32 kernel
// cannot keep pace with the bytes, and 3 x 137 GFLOP / 495 TFLOP/s = 0.83 ms
// as 3xTF32 on the tensor cores. So the design has to stream bricks at the
// memory's rate and keep the products and every per-brick step under it.
//
// Design (one block of two consumer warpgroups and one producer warp a
// slice of the bricks, a persistent grid sized to the card):
// * Orientation: out[t]^T = v-brick (128 x d) @ u-brick^T (d x 8), so M =
//   the brick's 128 columns (64 a consumer warpgroup), N = its 8 rows, K =
//   d in steps of 8 (wgmma m64nNk8 tf32). The bricks of one brick column
//   share v's 128 rows, so up to G = 4 consecutive bricks of a column are
//   multiplied together (N = 32): one product a group, not a brick.
// * Work: corder lists every brick grouped by column (cached on the
//   matrix). The grid is one block an SM, and block b takes the b-th equal
//   slice of corder, whatever the columns inside it: uneven column runs
//   cost nothing, and a column that crosses a slice edge is merely started
//   twice. The producer warp reads the slice's indices 32 at a time (each
//   lane one brick: corder, then bcol and brow, no chain of dependent
//   loads a brick) and cuts them into groups (a group ends at G bricks, a
//   column change or the end of the 32); it writes each group's column and
//   bricks into the stage's header, so the consumers read no index.
// * Operand A, v: K-major as v lies. Each thread loads its fragments of the
//   column's 128 rows once a column change (64 of d at a time) and splits
//   them into TF32 halves in registers: 64 registers at d = 64, kept for
//   the whole column run (about 1024 bricks at card scale).
// * Operand B, u: the group's 8-row slices of u arrive by TMA (two boxes
//   of 32 columns x 8 rows, 128-byte swizzle, zero-filled past m and past
//   d), K-major as they lie, and the 256 consumer threads split them into
//   halves in shared memory (8 values a thread a group) before the
//   products. Every pass runs all 8 steps along d: the zeros past d cost
//   nothing that matters, and a product skipped on a condition would make
//   ptxas serialise the wgmmas.
// * Streaming: the producer warp keeps a ring of ST stages in flight, each
//   one group: its u slices and its bricks' sdata, each brick one 4 KB
//   cp.async.bulk. The stage's mbarrier counts the bytes.
// * Epilogue: each thread scales its accumulators by sdata in place in the
//   stage (the layout the brick has in memory) and the bricks leave as one
//   4 KB bulk store each. The stage is handed back to the producer once the
//   next group's stores are issued and this group's have read it
//   (cp.async.bulk.wait_group.read 1), so stores overlap the next group.
// * d > 64: the slice is walked once for each 64 columns of d, v's fragments
//   reloaded for each; each pass adds to what the earlier ones wrote through
//   plain stores by the same thread, and the last one scales by sdata,
//   read from device memory (no bulk copies then).
// * Precision, 3xTF32: x = big + small, both rounded to TF32, and each
//   product is three TF32 products into one float32 accumulator, the small
//   terms first: vs ub + vb us + vb ub (the dropped term is 2^-22 of the
//   product). One TF32 pass would leave about 5e-4 relative error.
// * Each output element is computed by one thread in a fixed order, with
//   no atomics: a rerun repeats the bits.

#include "sm90_common.cuh"

namespace {

using namespace sm90;

constexpr int BR = 8;                          // brick rows
constexpr int BC = 128;                        // brick columns
constexpr int G = 4;                           // bricks of one column multiplied together
constexpr int DV = 64;                         // columns of d a pass holds in registers
constexpr int ST = 6;                          // stages of the ring: five groups in flight ahead
constexpr int NCONS = 256;                     // consumer threads: two warpgroups
constexpr int NT = NCONS + 32;                 // and the producer warp
constexpr uint32_t U_CHUNK = G * BR * 128;     // 32 columns of d of a group's u rows: 4 KB
constexpr uint32_t U_BYTES = 2 * U_CHUNK;      // 64 columns of d: 8 KB
constexpr uint32_t BRICK = BR * BC * 4;        // 4 KB
constexpr uint32_t STAGE = U_BYTES + G * BRICK;  // u as landed, then G bricks of sdata: 24 KB
constexpr size_t SMEM = (size_t)ST * STAGE + 2 * U_BYTES + 1024;  // + u's halves, + alignment

struct Args {
  const float* sdata;
  const int* brow;
  const int* bcol;
  const int* corder;
  const float* v;
  float* out;
  long long nbricks, n;
  int d;
  long long slice;  // bricks of corder a block takes
};

// What the producer tells the consumers of a group, in its stage
struct Header {
  int cnt, col;  // bricks (1 .. G) and their brick column
  int t[G];      // the bricks
};

__global__ void __launch_bounds__(NT, 1) sddmm_sm90_kernel(const __grid_constant__ CUtensorMap tu, const Args a) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[2 * ST];
  __shared__ Header hdr[ST];

  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;  // swizzled tiles sit on 1024 bytes
  uint8_t* const gbase = smem_raw + (base - smem_u32(smem_raw));  // the same bytes, as a generic pointer
  auto u_at = [&](int s) { return (uint32_t)s * STAGE; };        // offsets from base
  auto sd_at = [&](int s) { return (uint32_t)s * STAGE + U_BYTES; };
  const uint32_t ub_at = ST * STAGE, us_at = ST * STAGE + U_BYTES;  // u's TF32 halves
  auto full = [&](int s) { return smem_u32(&bars[s]); };
  auto empty = [&](int s) { return smem_u32(&bars[ST + s]); };

  const long long i0 = (long long)blockIdx.x * a.slice;
  const long long i1 = min(a.nbricks, i0 + a.slice);
  const bool single = a.d <= DV;

  if (threadIdx.x == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 1);  // one arrival: the consumer thread that hands the stage back
    }
    mbar_init_fence();
  }
  __syncthreads();
  if (i0 >= i1) return;

  if (threadIdx.x >= NCONS) {
    // ------------------------------------------------------------ producer
    const int lane = threadIdx.x & 31;
    long long q = 0;  // groups so far, over all passes
    for (int j0 = 0; j0 < a.d; j0 += DV) {
      for (long long p = i0; p < i1; p += 32) {
        const int nb = (int)min(32LL, i1 - p);
        int t = 0, col = -1, row = 0;
        if (lane < nb) {
          t = __ldg(a.corder + p + lane);
          col = __ldg(a.bcol + t);
          row = BR * __ldg(a.brow + t);
        }
        for (int k = 0; k < nb; ++q) {
          const int c = __shfl_sync(0xffffffffu, col, k);
          int cnt = 1;
          while (cnt < G && k + cnt < nb && __shfl_sync(0xffffffffu, col, k + cnt) == c) ++cnt;
          const int s = (int)(q % ST);
          if (lane == 0) {
            mbar_wait(empty(s), (uint32_t)((q / ST) & 1) ^ 1u);  // the first round finds every stage empty
            hdr[s].cnt = cnt;
            hdr[s].col = c;
          }
          __syncwarp();
          if (lane >= k && lane < k + cnt) hdr[s].t[lane - k] = t;
          __syncwarp();
          if (lane == 0) mbar_expect_tx(full(s), (uint32_t)cnt * (2048u + (single ? BRICK : 0u)));  // releases the header
          __syncwarp();
          if (lane >= k && lane < k + cnt) {
            const uint32_t b = lane - k;
            tma_load_2d(base + u_at(s) + b * 1024u, &tu, full(s), j0, row);
            tma_load_2d(base + u_at(s) + U_CHUNK + b * 1024u, &tu, full(s), j0 + 32, row);
            if (single) bulk_load(base + sd_at(s) + b * BRICK, a.sdata + (long long)t * (BR * BC), BRICK, full(s));
          }
          k += cnt;
        }
      }
    }
    return;
  }

  // -------------------------------------------------------------- consumers
  const int tid = threadIdx.x;
  const int w = tid >> 7;                    // consumer warpgroup: brick columns 64 w .. 64 w + 63
  const int warp = (tid >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int c0 = 64 * w + 16 * warp + g;     // this thread's brick columns: c0 and c0 + 8

  uint32_t vb[32], vs[32];                   // v's halves: 8 steps of 8 along d, 4 registers each
  float acc[16];
  long long q = 0;
  int prev_s = -1;
  for (int j0 = 0; j0 < a.d; j0 += DV) {
    const bool first = j0 == 0, last = j0 + DV >= a.d;
    int loaded = -1;  // the brick column whose v rows are in registers
    for (long long i = i0; i < i1; ++q) {
      const int s = (int)(q % ST);
      mbar_wait(full(s), (uint32_t)((q / ST) & 1));
      const int cnt = hdr[s].cnt, col = hdr[s].col;
      if (col != loaded) {
        // fragments of v's rows 128 col + c0 (+ 8), columns j0 + 8 kk + t4 (+ 4)
#pragma unroll
        for (int kk = 0; kk < 8; ++kk)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const long long row = (long long)col * BC + c0 + 8 * (e & 1);
            const int k = j0 + 8 * kk + t4 + 4 * (e >> 1);
            const float x = row < a.n && k < a.d ? __ldg(a.v + row * a.d + k) : 0.f;
            tf32_split_alu(x, vb[4 * kk + e], vs[4 * kk + e]);
          }
        loaded = col;
      }
      // u's halves, in the swizzled places TMA gave the rows
      {
        const float4* src = reinterpret_cast<const float4*>(gbase + u_at(s));
        uint4* hb = reinterpret_cast<uint4*>(gbase + ub_at);
        uint4* hs = reinterpret_cast<uint4*>(gbase + us_at);
#pragma unroll
        for (int k = 0; k < (int)(U_BYTES / 16) / NCONS; ++k) {
          const int idx = tid + NCONS * k;
          const float4 x = src[idx];
          uint4 hi, lo;
          tf32_split_alu(x.x, hi.x, lo.x);
          tf32_split_alu(x.y, hi.y, lo.y);
          tf32_split_alu(x.z, hi.z, lo.z);
          tf32_split_alu(x.w, hi.w, lo.w);
          hb[idx] = hi;
          hs[idx] = lo;
        }
      }
      fence_async_smem();
      named_sync(1);  // both halves written; the landed u is read

      // out^T of the group: three passes of 8 steps of 8 along d
      // (32 bytes apart in a 32-column chunk), the small terms first
#pragma unroll
      for (int i2 = 0; i2 < 16; ++i2) acc[i2] = 0.f;
      const uint64_t db = desc(base + ub_at, 16, 1024), ds = desc(base + us_at, 16, 1024);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 8; ++kk)
        wgmma_tf32_n32(acc, &vs[4 * kk], db + (((kk >> 2) * U_CHUNK + (kk & 3) * 32u) >> 4));
#pragma unroll
      for (int kk = 0; kk < 8; ++kk)
        wgmma_tf32_n32(acc, &vb[4 * kk], ds + (((kk >> 2) * U_CHUNK + (kk & 3) * 32u) >> 4));
#pragma unroll
      for (int kk = 0; kk < 8; ++kk)
        wgmma_tf32_n32(acc, &vb[4 * kk], db + (((kk >> 2) * U_CHUNK + (kk & 3) * 32u) >> 4));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      fence_regs(vb);
      fence_regs(vs);

      // acc[4 b + e]: brick b of the group, row 2 t4 + e % 2, column c0 + 8 (e / 2)
      if (single) {
        float* sd = reinterpret_cast<float*>(gbase + sd_at(s));
#pragma unroll
        for (int b = 0; b < G; ++b)
          if (b < cnt)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              float& x = sd[b * (BR * BC) + (2 * t4 + (e & 1)) * BC + c0 + 8 * (e >> 1)];
              x *= acc[4 * b + e];
            }
        fence_async_smem();
      } else {
#pragma unroll
        for (int b = 0; b < G; ++b)
          if (b < cnt) {
            const long long t = hdr[s].t[b];
            float* o = a.out + t * (BR * BC);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int idx = (2 * t4 + (e & 1)) * BC + c0 + 8 * (e >> 1);
              float x = acc[4 * b + e];
              if (!first) x += o[idx];
              if (last) x *= __ldg(a.sdata + t * (BR * BC) + idx);
              o[idx] = x;
            }
          }
      }
      named_sync(2);  // the group's bricks are scaled; both warpgroups are done with u's halves
      if (!single && tid == 0) mbar_arrive(empty(s));  // header and u are read: hand the stage back
      if (single && tid == 0) {
        for (int b = 0; b < cnt; ++b)
          bulk_store(a.out + (long long)hdr[s].t[b] * (BR * BC), base + sd_at(s) + b * BRICK, BRICK);
        bulk_commit();
        if (prev_s >= 0) {  // the previous group's stores have read their stage: hand it back
          bulk_wait_read<1>();
          mbar_arrive(empty(prev_s));
        }
        prev_s = s;
      }
      i += cnt;
    }
  }
  if (single && tid == 0) bulk_wait_all();
}

}  // namespace

extern "C" {

// out (B, 8, 128) = sdata * (u-brick @ v-brick^T) per brick. brow, bcol and
// corder (B,) int32, corder listing the bricks grouped by brick column; u
// (m, d) and v (n, d) float32 row-major; d % 4 == 0, m >= 1, and u, sdata
// and out on 16 bytes. Returns 0, the CUDA error code of the launch, or
// 100000 + the CUresult of a refused tensor map.
int heat_brick_sddmm_sm90(const float* sdata, const int* brow, const int* bcol, const int* corder, const float* u,
                          const float* v, float* out, long long nbricks, long long m, long long n, int d, int device,
                          void* stream) {
  if (nbricks < 1 || m < 1 || m > 0x7fffffffLL || n < 0 || d < 4 || d % 4 != 0 ||
      reinterpret_cast<uintptr_t>(u) % 16 || reinterpret_cast<uintptr_t>(sdata) % 16 ||
      reinterpret_cast<uintptr_t>(out) % 16)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  CUtensorMap tu;
  const int rc = encode_2d_f32(&tu, u, m, d, d, 32, BR, true);
  if (rc != 0) return rc;
  e = cudaFuncSetAttribute(sddmm_sm90_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM);
  if (e != cudaSuccess) return (int)e;
  int sms = 0, per_sm = 0;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return (int)e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, sddmm_sm90_kernel, NT, SMEM);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  long long blocks = (long long)sms * per_sm;
  const long long groups = (nbricks + G - 1) / G;
  if (blocks > groups) blocks = groups;
  const Args a{sdata, brow, bcol, corder, v, out, nbricks, n, d, (nbricks + blocks - 1) / blocks};
  sddmm_sm90_kernel<<<(unsigned)blocks, NT, SMEM, static_cast<cudaStream_t>(stream)>>>(tu, a);
  return (int)cudaGetLastError();
}

const char* heat_spmm_error_string(int code) { return error_string(code); }

}  // extern "C"
