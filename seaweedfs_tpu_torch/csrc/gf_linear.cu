// GF(2^8) linear map for Reed-Solomon encode, rebuild and degraded reads on
// Hopper (sm_90a):
//
//     out[b, o, n] = XOR_s  C[o, s] * data[b, s, n]      over GF(2^8), poly 0x11D
//
// C is [O, S] with O, S <= 14 (RS(10,4): encode O=4, S=10; decode O<=4,
// S=10); data is [B, S, N] and out [B, O, N], uint8, contiguous; any N >= 0.
//
// Replaces the TPU kernel seaweedfs_tpu/ops/rs_pallas.py::_kernel (launched
// by _call, the tree's only pl.pallas_call) and the XLA einsum
// seaweedfs_tpu/ops/rs_kernel.py::gf_linear that computes the same map in
// another bit order. Both lift the map to GF(2) bit-planes so it runs as one
// int8 matmul on the TPU's matrix unit.
//
// Bound on the H100: memory. The map reads each input byte once and writes
// each output byte once, (S + O) * B * N bytes, at 3.35 TB/s: an encode of
// N = 64 Mi lanes takes at least 14 * 64 MiB / 3.35 TB/s = 0.28 ms. Its
// arithmetic is O * S table lookups per lane, far below any peak rate.
//
// Design (simple and exact; the tensor-core bit-plane form is later work):
//   - the host builds, per coefficient C[o, s], the 256-byte product table
//     mul(C[o, s], x) for every x; a block copies all O * S tables into
//     shared memory once (<= 14 * 14 * 256 = 50,176 bytes, dynamic);
//   - each thread owns 16 consecutive lanes of one batch row: it loads 16
//     bytes (one uint4, coalesced across the warp) of every input row, XORs
//     the table lookups into O x 16 accumulator bytes held in registers (O is
//     a template parameter so the accumulators never spill), and stores 16
//     bytes per output row;
//   - the ragged tail (N % 16) and unaligned rows take a byte-wise path that
//     masks past N; a grid-stride loop covers any B * N with 64-bit offsets
//     (a flattened 256 MiB slab has S * N > 2^31).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxRows = 14;
constexpr long long kMaxBlocks = 4096;

template <int O>
__global__ void __launch_bounds__(kThreads)
gf_linear_kernel(const uint8_t* __restrict__ tables, int S,
                 const uint8_t* __restrict__ data, uint8_t* __restrict__ out,
                 long long B, long long N, bool vec) {
  extern __shared__ __align__(16) uint8_t tab[];
  const int n_tab16 = O * S * 16;  // 256 bytes per (o, s) = 16 uint4
  for (int i = threadIdx.x; i < n_tab16; i += blockDim.x)
    reinterpret_cast<uint4*>(tab)[i] =
        reinterpret_cast<const uint4*>(tables)[i];
  __syncthreads();

  const long long nvec = (N + 15) / 16;
  const long long total = B * nvec;
  for (long long v = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       v < total; v += (long long)gridDim.x * blockDim.x) {
    const long long b = v / nvec;
    const long long col = (v - b * nvec) * 16;
    const uint8_t* src = data + b * S * N + col;
    uint8_t* dst = out + b * O * N + col;
    const bool full = vec && col + 16 <= N;
    const long long len = N - col;  // > 0; only read when !full

    uint32_t acc[O][4];
#pragma unroll
    for (int o = 0; o < O; o++)
      acc[o][0] = acc[o][1] = acc[o][2] = acc[o][3] = 0;

    for (int s = 0; s < S; s++) {
      const uint8_t* row = src + s * N;
      uint32_t w[4];
      if (full) {
        const uint4 q = __ldg(reinterpret_cast<const uint4*>(row));
        w[0] = q.x;
        w[1] = q.y;
        w[2] = q.z;
        w[3] = q.w;
      } else {
        w[0] = w[1] = w[2] = w[3] = 0;
#pragma unroll
        for (int k = 0; k < 16; k++)
          if (k < len) w[k >> 2] |= (uint32_t)row[k] << ((k & 3) * 8);
      }
#pragma unroll
      for (int o = 0; o < O; o++) {
        const uint8_t* t = tab + (o * S + s) * 256;
#pragma unroll
        for (int k = 0; k < 4; k++) {
          const uint32_t x = w[k];
          acc[o][k] ^= (uint32_t)t[x & 0xFF] |
                       ((uint32_t)t[(x >> 8) & 0xFF] << 8) |
                       ((uint32_t)t[(x >> 16) & 0xFF] << 16) |
                       ((uint32_t)t[x >> 24] << 24);
        }
      }
    }

#pragma unroll
    for (int o = 0; o < O; o++) {
      uint8_t* orow = dst + o * N;
      if (full) {
        *reinterpret_cast<uint4*>(orow) =
            make_uint4(acc[o][0], acc[o][1], acc[o][2], acc[o][3]);
      } else {
#pragma unroll
        for (int k = 0; k < 16; k++)
          if (k < len) orow[k] = (uint8_t)(acc[o][k >> 2] >> ((k & 3) * 8));
      }
    }
  }
}

template <int O>
cudaError_t launch(const uint8_t* tables, int S, const uint8_t* data,
                   uint8_t* out, long long B, long long N,
                   cudaStream_t stream) {
  const int smem = O * S * 256;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        gf_linear_kernel<O>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return e;
  }
  const long long total = B * ((N + 15) / 16);
  long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  const bool vec = N % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(data) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  gf_linear_kernel<O><<<(unsigned)blocks, kThreads, smem, stream>>>(
      tables, S, data, out, B, N, vec);
  return cudaGetLastError();
}

}  // namespace

// tables: [O, S, 256] uint8 on the device (tables[o][s][x] = C[o,s] * x),
// 16-byte aligned. Returns a cudaError_t value: 0 when the kernel launched.
extern "C" int gf_linear_launch(const void* tables, int O, int S,
                                const void* data, void* out, long long B,
                                long long N, void* stream) {
  if (O < 1 || O > kMaxRows || S < 1 || S > kMaxRows || B < 0 || N < 0 ||
      reinterpret_cast<uintptr_t>(tables) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || N == 0) return (int)cudaSuccess;
  const auto* t = static_cast<const uint8_t*>(tables);
  const auto* d = static_cast<const uint8_t*>(data);
  auto* o = static_cast<uint8_t*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  switch (O) {
    case 1: return (int)launch<1>(t, S, d, o, B, N, st);
    case 2: return (int)launch<2>(t, S, d, o, B, N, st);
    case 3: return (int)launch<3>(t, S, d, o, B, N, st);
    case 4: return (int)launch<4>(t, S, d, o, B, N, st);
    case 5: return (int)launch<5>(t, S, d, o, B, N, st);
    case 6: return (int)launch<6>(t, S, d, o, B, N, st);
    case 7: return (int)launch<7>(t, S, d, o, B, N, st);
    case 8: return (int)launch<8>(t, S, d, o, B, N, st);
    case 9: return (int)launch<9>(t, S, d, o, B, N, st);
    case 10: return (int)launch<10>(t, S, d, o, B, N, st);
    case 11: return (int)launch<11>(t, S, d, o, B, N, st);
    case 12: return (int)launch<12>(t, S, d, o, B, N, st);
    case 13: return (int)launch<13>(t, S, d, o, B, N, st);
    default: return (int)launch<14>(t, S, d, o, B, N, st);
  }
}
