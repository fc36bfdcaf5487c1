// GF(2^8) linear map for Reed-Solomon encode, rebuild and degraded reads on
// Hopper (sm_90a):
//
//     out[b, o, n] = XOR_s  C[o, s] * data[b, s, n]      over GF(2^8), poly 0x11D
//
// C is [O, S] with O, S <= 14 (RS(10,4): encode O=4, S=10; decode O<=4,
// S=10); data is [B, S, N] and out [B, O, N], uint8, contiguous; any N >= 0.
//
// Replaces the TPU kernel seaweedfs_tpu/ops/rs_pallas.py:45 (_kernel,
// launched by _call, the tree's only pl.pallas_call) and the XLA einsum
// seaweedfs_tpu/ops/rs_kernel.py::gf_linear that computes the same map in
// another bit order. Both lift the map to GF(2) bit-planes so it runs as one
// int8 matmul on the TPU's matrix unit: the TPU has no fast gather. Hopper
// has shared memory, so this kernel looks the products up in tables.
//
// What bounds it on the H100:
//   - bytes: each input byte is read once and each output byte written
//     once, (S + O) * B * N bytes at 3.35 TB/s. An encode of N = 64 Mi
//     lanes moves 14 * 64 MiB and takes at least 0.28 ms.
//   - shared-memory wavefronts and instructions, if the tables are laid out
//     naively. A 256-byte product table per coefficient costs O * S = 40
//     byte lookups per lane for an encode, and the 32 random bytes of a
//     warp's lookup hit both words of some bank almost always: about 2
//     wavefronts per lookup, 64 Mi * 40 / 32 * 2 = 168 M wavefronts, 0.64-
//     0.72 ms at one wavefront per SM clock on 132 SMs (1.98-1.755 GHz);
//     and about 4 instructions per lookup, 160 per lane, where the card
//     executes about 124 per lane in the time of the byte bound.
//
// Design:
//   - packed-output nibble tables. c * x = c * (x & 0x0F) ^ c * (x & 0xF0),
//     so the host builds, per group g of 4 output rows, input row s, half h
//     and nibble v, one 32-bit word whose byte o is C[4g + o, s] * (v << 4h):
//     [G][S][2][16] words, G = ceil(O / 4). One lookup gives the products of
//     up to 4 output rows, so a lane costs 2 lookups and one 3-input XOR per
//     input row into one u32 accumulator: 20 lookups per lane for an encode.
//   - conflict-free without copies: the 16 words of one (s, h) table lie in
//     16 distinct banks, and lanes that read the same word get it by
//     broadcast, so every lookup of a warp is one wavefront. A block copies
//     the [G][S][2][16] words as they are (S * 128 bytes per group, 1.25 KiB
//     for an encode) into shared memory; a small launch (a degraded read, N
//     about 1 KiB) reads no more. The data's nibbles are taken pre-scaled
//     by 4, (x << 2) & 0x3C3C3C3C and (x >> 2) & 0x3C3C3C3C, so a lookup is
//     one byte extract (PRMT) and one LDS at a constant offset. An encode of
//     64 Mi lanes is 42 M wavefronts (about 0.17 ms) and about 90
//     instructions per lane, both under the byte bound: what is left is the
//     memory stream itself.
//   - O > 4 (off the main path) loops over the output groups, reading the
//     input again for each.
//   - each thread owns 16 consecutive lanes of one batch row: it loads 16
//     bytes (one uint4, coalesced across the warp) of each input row, with
//     S a template parameter so that all S loads are in flight at once, and
//     a 4x4 byte transpose (__byte_perm) turns the 16 lanes' packed words
//     into one uint4 per output row. The launch bound keeps S <= 10 at 80
//     registers, so 3 blocks of 256 threads fit an SM's 64 Ki registers.
//   - the grid is as many blocks as the card holds at once (the occupancy
//     API times the SM count, asked once per instantiation and device), and
//     the B * ceil(N / 16) units go in even contiguous ranges, one per
//     block, so no SM runs a whole extra wave while the others idle.
//   - the ragged tail (N % 16) and unaligned rows take a byte-wise path
//     that masks past N; offsets are 64-bit (a flattened 256 MiB slab has
//     S * N > 2^31).

#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxRows = 14;
constexpr int kMaxDevices = 64;
constexpr int kMaxGroups = (kMaxRows + 3) / 4;
constexpr int kGroupWords = 2 * 16;  // table words per input row and group

// Byte j of x, zero-extended.
__device__ __forceinline__ uint32_t byte_of(uint32_t x, int j) {
  return __byte_perm(x, 0, 0x4440 | j);
}

// a[k] holds output row o of lane k in byte o; r[o] gets lane k in byte k.
__device__ __forceinline__ void transpose4(const uint32_t* a, uint32_t* r) {
  const uint32_t t0 = __byte_perm(a[0], a[1], 0x5140);  // a0.0 a1.0 a0.1 a1.1
  const uint32_t t1 = __byte_perm(a[0], a[1], 0x7362);  // a0.2 a1.2 a0.3 a1.3
  const uint32_t t2 = __byte_perm(a[2], a[3], 0x5140);
  const uint32_t t3 = __byte_perm(a[2], a[3], 0x7362);
  r[0] = __byte_perm(t0, t2, 0x5410);
  r[1] = __byte_perm(t0, t2, 0x7632);
  r[2] = __byte_perm(t1, t3, 0x5410);
  r[3] = __byte_perm(t1, t3, 0x7632);
}

template <int S>
__global__ void __launch_bounds__(kThreads, S <= 10 ? 3 : 2)
gf_linear_kernel(const uint32_t* __restrict__ tables, int O,
                 const uint8_t* __restrict__ data, uint8_t* __restrict__ out,
                 long long B, long long N, bool vec) {
  extern __shared__ uint32_t tab[];  // [G][S][2][16] words, as on the device
  const int groups = (O + 3) / 4;
  for (int i = threadIdx.x; i < groups * S * kGroupWords; i += kThreads)
    tab[i] = __ldg(tables + i);
  __syncthreads();

  const long long nvec = (N + 15) / 16;
  const long long total = B * nvec;
  const long long first = total * blockIdx.x / gridDim.x;
  const long long last = total * (blockIdx.x + 1) / gridDim.x;
  for (int g = 0; g < groups; g++) {
    const int rows = min(4, O - g * 4);
    // byte addresses: nibble v of table (s, h) is its word at byte 4v
    const char* gtab =
        reinterpret_cast<const char*>(tab + g * S * kGroupWords);
    long long u = first + threadIdx.x;
    long long b = u / nvec;
    long long c = u - b * nvec;
    for (; u < last; u += kThreads) {
      const long long col = c * 16;
      const uint8_t* src = data + b * S * N + col;
      uint8_t* dst = out + (b * O + g * 4) * N + col;
      const bool full = vec && col + 16 <= N;
      const long long len = N - col;  // > 0; only read when !full

      uint32_t w[S][4];
      if (full) {
#pragma unroll
        for (int s = 0; s < S; s++) {
          const uint4 q = __ldg(reinterpret_cast<const uint4*>(src + s * N));
          w[s][0] = q.x;
          w[s][1] = q.y;
          w[s][2] = q.z;
          w[s][3] = q.w;
        }
      } else {
#pragma unroll
        for (int s = 0; s < S; s++) {
          w[s][0] = w[s][1] = w[s][2] = w[s][3] = 0;
#pragma unroll
          for (int k = 0; k < 16; k++)
            if (k < len)
              w[s][k >> 2] |= (uint32_t)src[s * N + k] << ((k & 3) * 8);
        }
      }

      uint32_t acc[16];
#pragma unroll
      for (int k = 0; k < 16; k++) acc[k] = 0;
#pragma unroll
      for (int s = 0; s < S; s++) {
        const char* lo_tab = gtab + s * kGroupWords * 4;
        const char* hi_tab = lo_tab + 16 * 4;
#pragma unroll
        for (int q = 0; q < 4; q++) {
          const uint32_t lo4 = (w[s][q] << 2) & 0x3C3C3C3Cu;  // 4 * low nibbles
          const uint32_t hi4 = (w[s][q] >> 2) & 0x3C3C3C3Cu;  // 4 * high nibbles
#pragma unroll
          for (int j = 0; j < 4; j++)
            acc[q * 4 + j] ^=
                *reinterpret_cast<const uint32_t*>(lo_tab + byte_of(lo4, j)) ^
                *reinterpret_cast<const uint32_t*>(hi_tab + byte_of(hi4, j));
        }
      }

      if (full) {
        uint32_t r[4][4];  // r[j][o]: lanes 4j..4j+3 of output row o
#pragma unroll
        for (int j = 0; j < 4; j++) transpose4(acc + j * 4, r[j]);
#pragma unroll
        for (int o = 0; o < 4; o++)
          if (o < rows)
            *reinterpret_cast<uint4*>(dst + o * N) =
                make_uint4(r[0][o], r[1][o], r[2][o], r[3][o]);
      } else {
#pragma unroll
        for (int o = 0; o < 4; o++)
          if (o < rows) {
#pragma unroll
            for (int k = 0; k < 16; k++)
              if (k < len) dst[o * N + k] = (uint8_t)(acc[k] >> (o * 8));
          }
      }

      c += kThreads;
      if (c >= nvec) {
        if (nvec >= kThreads) {  // c < 2 * nvec
          c -= nvec;
          b++;
        } else {  // both below 2 * kThreads
          b += (unsigned)c / (unsigned)nvec;
          c = (unsigned)c % (unsigned)nvec;
        }
      }
    }
  }
}

template <int S>
cudaError_t launch(const uint32_t* tables, int O, const uint8_t* data,
                   uint8_t* out, long long B, long long N,
                   cudaStream_t stream) {
  constexpr int kMaxSmem = kMaxGroups * S * kGroupWords * 4;
  static std::atomic<int> resident[kMaxDevices];  // blocks; 0 = not asked
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  int grid = dev < kMaxDevices ? resident[dev].load() : 0;
  if (grid == 0) {
    int per_sm = 0, sms = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, gf_linear_kernel<S>, kThreads, kMaxSmem);
    if (e != cudaSuccess) return e;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
    grid = per_sm * sms;
    if (grid <= 0) return cudaErrorInvalidConfiguration;
    if (dev < kMaxDevices) resident[dev].store(grid);
  }
  const long long need = (B * ((N + 15) / 16) + kThreads - 1) / kThreads;
  const unsigned blocks = (unsigned)(need < grid ? need : grid);
  const bool vec = N % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(data) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const int smem = (O + 3) / 4 * S * kGroupWords * 4;
  gf_linear_kernel<S><<<blocks, kThreads, smem, stream>>>(
      tables, O, data, out, B, N, vec);
  return cudaGetLastError();
}

}  // namespace

// tables: [ceil(O/4), S, 2, 16] uint32 on the device, 16-byte aligned; byte
// o of word [g, s, h, v] is C[4g + o, s] * (v << 4h) (0 past row O).
// Returns a cudaError_t value: 0 when the kernel launched.
extern "C" int gf_linear_launch(const void* tables, int O, int S,
                                const void* data, void* out, long long B,
                                long long N, void* stream) {
  if (O < 1 || O > kMaxRows || S < 1 || S > kMaxRows || B < 0 || N < 0 ||
      reinterpret_cast<uintptr_t>(tables) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || N == 0) return (int)cudaSuccess;
  const auto* t = static_cast<const uint32_t*>(tables);
  const auto* d = static_cast<const uint8_t*>(data);
  auto* o = static_cast<uint8_t*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  switch (S) {
    case 1: return (int)launch<1>(t, O, d, o, B, N, st);
    case 2: return (int)launch<2>(t, O, d, o, B, N, st);
    case 3: return (int)launch<3>(t, O, d, o, B, N, st);
    case 4: return (int)launch<4>(t, O, d, o, B, N, st);
    case 5: return (int)launch<5>(t, O, d, o, B, N, st);
    case 6: return (int)launch<6>(t, O, d, o, B, N, st);
    case 7: return (int)launch<7>(t, O, d, o, B, N, st);
    case 8: return (int)launch<8>(t, O, d, o, B, N, st);
    case 9: return (int)launch<9>(t, O, d, o, B, N, st);
    case 10: return (int)launch<10>(t, O, d, o, B, N, st);
    case 11: return (int)launch<11>(t, O, d, o, B, N, st);
    case 12: return (int)launch<12>(t, O, d, o, B, N, st);
    case 13: return (int)launch<13>(t, O, d, o, B, N, st);
    default: return (int)launch<14>(t, O, d, o, B, N, st);
  }
}
