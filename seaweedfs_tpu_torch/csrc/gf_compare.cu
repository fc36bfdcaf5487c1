// Masked byte compare with a per-row count and first index, for stripe
// verify on Hopper (sm_90a):
//
//   rows r < R of N lanes each, lane n at the global position offset + n:
//     hit[r, n]  = a[r, n] != b[r, n]  and  offset + n < limits[r]
//     counts[r]  = number of hits in row r
//     firsts[r]  = the least position of a hit in row r, 0 where there is none
//
// a and b are [R, N] uint8 and contiguous (R = B * P: a bucket's recomputed
// and stored parity, or a re-encoded stripe's parity and its survivors);
// limits, counts and firsts are [R] int32. offset is where this block of
// lanes starts in its row: a card holds lanes [offset, offset + N) of a row
// split over the mesh's sp axis, and its counts and firsts combine with the
// other cards' by a sum and a minimum over the blocks that hit.
//
// Replaces the XLA program seaweedfs_tpu/parallel/mesh_fleet.py:234
// (_mesh_compare_fn): the chained verify dispatch that compares the parity
// still on the device against the stored parity, so that only [B, P] counts
// and first indices cross back to the host.
//
// What bounds it on the H100: bytes. Each lane below the limit is read once
// from a and once from b, 2 * R * N bytes at 3.35 TB/s when every limit is
// full; the compare is a few instructions per 4 bytes. Lanes at or past a
// row's limit are not read at all.
//
// Design:
//   - each thread takes 16 lanes at a time with one uint4 load from each
//     input (coalesced across the warp), compares 4 bytes per instruction
//     (__vcmpne4 gives 0xFF in each byte that differs), masks the bytes at
//     or past the limit, and adds __popc / 8. Its first hit is the lowest
//     set byte (__ffs) of the first word that hits, since a thread walks
//     its units in increasing order.
//   - a block works on one row (blockIdx.y, striding by gridDim.y past 65535
//     rows) and a strided share of its units (blockIdx.x). The warp reduces
//     with __reduce_add_sync / __reduce_min_sync, the block through shared
//     memory, and one thread merges the block into the row with atomicAdd
//     and atomicMin. Integer sums and minima do not depend on the order, so
//     the result is exact and the same on every run.
//   - three launches on the caller's stream: set counts to 0 and firsts to
//     INT_MAX, compare, then map a first of INT_MAX (no hit) to 0.
//   - N not a multiple of 16, or rows not 16-byte aligned, take a byte-wise
//     path that reads only lanes below N. N = 0 gives counts 0 and firsts 0.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnitsPerThread = 4;  // 16-lane units per thread, at least
constexpr long long kMaxRowBlocks = 65535;
constexpr long long kMaxLaneBlocks = 1 << 20;
constexpr unsigned kFull = 0xFFFFFFFFu;

__global__ void init_rows(int* counts, int* firsts, long long R) {
  for (long long r = blockIdx.x * (long long)kThreads + threadIdx.x; r < R;
       r += (long long)gridDim.x * kThreads) {
    counts[r] = 0;
    firsts[r] = INT_MAX;
  }
}

__global__ void finish_rows(int* firsts, long long R) {
  for (long long r = blockIdx.x * (long long)kThreads + threadIdx.x; r < R;
       r += (long long)gridDim.x * kThreads)
    if (firsts[r] == INT_MAX) firsts[r] = 0;
}

// The bytes of one 4-byte word that lie below the limit, when `left` lanes
// from the word's first byte are below it (left may be <= 0 or >= 4).
__device__ __forceinline__ uint32_t byte_mask(long long left) {
  return left >= 4 ? kFull : left <= 0 ? 0u : (1u << (8 * left)) - 1u;
}

__global__ void __launch_bounds__(kThreads)
compare_rows(const uint8_t* __restrict__ a, const uint8_t* __restrict__ b,
             const int* __restrict__ limits, long long R, long long N,
             long long offset, bool vec, int* counts, int* firsts) {
  __shared__ unsigned s_count[kWarps];
  __shared__ int s_first[kWarps];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  for (long long r = blockIdx.y; r < R; r += gridDim.y) {
    // lanes of this block's part of row r that are below the row's limit
    long long valid = (long long)limits[r] - offset;
    if (valid > N) valid = N;
    unsigned count = 0;
    int first = INT_MAX;
    const long long units = valid > 0 ? (valid + 15) / 16 : 0;
    const uint8_t* ra = a + r * N;
    const uint8_t* rb = b + r * N;
    for (long long u = blockIdx.x * (long long)kThreads + threadIdx.x;
         u < units; u += (long long)gridDim.x * kThreads) {
      const long long col = u * 16;
      uint32_t x[4], y[4];
      if (vec && col + 16 <= N) {
        const uint4 p = __ldg(reinterpret_cast<const uint4*>(ra + col));
        const uint4 q = __ldg(reinterpret_cast<const uint4*>(rb + col));
        x[0] = p.x, x[1] = p.y, x[2] = p.z, x[3] = p.w;
        y[0] = q.x, y[1] = q.y, y[2] = q.z, y[3] = q.w;
      } else {
        const long long len = N - col;  // > 0
#pragma unroll
        for (int k = 0; k < 4; k++) x[k] = y[k] = 0;
#pragma unroll
        for (int k = 0; k < 16; k++)
          if (k < len) {
            x[k >> 2] |= (uint32_t)ra[col + k] << ((k & 3) * 8);
            y[k >> 2] |= (uint32_t)rb[col + k] << ((k & 3) * 8);
          }
      }
      const long long left = valid - col;  // > 0
#pragma unroll
      for (int k = 0; k < 4; k++) {
        const uint32_t m = __vcmpne4(x[k], y[k]) & byte_mask(left - 4 * k);
        if (m) {
          count += __popc(m) >> 3;
          if (first == INT_MAX)
            first = (int)(offset + col + 4 * k + ((__ffs(m) - 1) >> 3));
        }
      }
    }
    count = __reduce_add_sync(kFull, count);
    first = __reduce_min_sync(kFull, first);
    if (lane == 0) {
      s_count[warp] = count;
      s_first[warp] = first;
    }
    __syncthreads();
    if (warp == 0) {
      count = lane < kWarps ? s_count[lane] : 0u;
      first = lane < kWarps ? s_first[lane] : INT_MAX;
      count = __reduce_add_sync(kFull, count);
      first = __reduce_min_sync(kFull, first);
      if (lane == 0 && count != 0) {
        atomicAdd(counts + r, (int)count);
        atomicMin(firsts + r, first);
      }
    }
    __syncthreads();  // s_count and s_first are reused by the next row
  }
}

unsigned row_grid(long long R) {
  const long long blocks = (R + kThreads - 1) / kThreads;
  return (unsigned)(blocks < 1024 ? blocks : 1024);
}

}  // namespace

// a, b: [R, N] uint8; limits, counts, firsts: [R] int32, all on the device.
// offset + N must fit in an int (positions are int32). Returns a
// cudaError_t value: 0 when every launch was accepted.
extern "C" int gf_compare_launch(const void* a, const void* b,
                                 const void* limits, void* counts,
                                 void* firsts, long long R, long long N,
                                 long long offset, void* stream) {
  if (R < 0 || N < 0 || offset < 0 || offset + N > INT_MAX)
    return (int)cudaErrorInvalidValue;
  if (R == 0) return (int)cudaSuccess;
  auto st = static_cast<cudaStream_t>(stream);
  auto* c = static_cast<int*>(counts);
  auto* f = static_cast<int*>(firsts);
  init_rows<<<row_grid(R), kThreads, 0, st>>>(c, f, R);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  if (N > 0) {
    const long long units = (N + 15) / 16;
    long long gx = (units + kThreads * kUnitsPerThread - 1) /
                   (kThreads * kUnitsPerThread);
    if (gx > kMaxLaneBlocks) gx = kMaxLaneBlocks;
    const long long gy = R < kMaxRowBlocks ? R : kMaxRowBlocks;
    const bool vec = N % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(a) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(b) % 16 == 0;
    compare_rows<<<dim3((unsigned)gx, (unsigned)gy), kThreads, 0, st>>>(
        static_cast<const uint8_t*>(a), static_cast<const uint8_t*>(b),
        static_cast<const int*>(limits), R, N, offset, vec, c, f);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  finish_rows<<<row_grid(R), kThreads, 0, st>>>(f, R);
  return (int)cudaGetLastError();
}
