// Packed-int4 weight-only matmul (K4), bf16 x in / f32 out, written for
// Hopper (sm_90a) and bound to Python with ctypes.
//
// Replaces eventgpt_tpu/ops/int4_matmul.py::_int4_kernel (the Pallas TPU
// kernel launched by int4_matmul). It computes the same function:
//   out[m, n] = sum_g s[g, n] * (sum_{r in g} x[m, 2r] * hi[r, n] + x[m, 2r+1] * lo[r, n])
// with x in bf16, hi/lo the centred nibbles of q4[r, n] (high nibble = row
// 2r, low nibble = row 2r+1, offset-binary +8), the per-group partial dot
// accumulated in f32 and multiplied by the f32 group scale in f32. The
// scale is never folded into bf16 weights.
//
// Bound on an H100 SXM (3.35 TB/s, 989 TFLOP/s bf16):
//   * decode, M = 4: bytes. The packed weight and its f32 scales are 0.53
//     bytes per weight: 4096 x 11008 moves 24 MB -> 7.1 us; a whole 7B
//     decode step (225 launches) moves 3.51 GB -> 1.05 ms;
//   * prefill, M = 3396, 4096 -> 11008: operations. 306 GFLOP -> 0.31 ms.
//
// Design (a plain first version). The product runs on the tensor cores
// through mma.sync m16n8k16 (bf16 in, f32 accumulate). Nibbles become bf16
// in registers: OR-ing a nibble into the mantissa of bf16 128.0 gives
// 128 + n exactly, and one bf16x2 subtraction of 136 centres both nibbles
// of a byte at once. A byte's two nibbles are rows 2r and 2r+1, which is
// exactly the k-pair that one register of the mma's B fragment holds, so
// the packed layout needs no shuffle. Inside a block tile the 32 output
// columns of a warp are permuted (fragment column c of n-tile j is column
// 4c + j), so that one 32-bit load gives a thread its four B bytes and two
// float4 loads its eight group scales. Each warp keeps an f32 per-group
// partial beside its f32 accumulator and folds the partial in with the
// scale at the end of every group, the Pallas kernel's order.
//   * Decode (M <= 16): one 16-row tile with 8 warps that split the groups
//     of K between them and add their accumulators through shared memory,
//     so that 32 columns of a 4096-wide weight still give 128 blocks and
//     each block keeps 8 warps of loads in flight.
//   * Prefill (M > 16): a 64 x 128 block tile, 4 warps side by side in N,
//     each with four 16-row m-tiles that share one B fragment.
// No shared-memory staging, cp.async, TMA or wgmma yet: those are for a
// later version.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARP_N = 32;  // output columns per warp (4 n-tiles of 8)

__device__ __forceinline__ void mma_bf16(float d[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One packed byte -> bf16x2 {hi - 8, lo - 8}; the low half (the mma's
// lower k index) is the high nibble, row 2r.
__device__ __forceinline__ uint32_t unpack_byte(uint32_t byte) {
  const uint32_t pair = 0x43004300u | (byte >> 4) | ((byte & 0xFu) << 16);
  __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(&pair);
  v = __hsub2(v, __floats2bfloat162_rn(136.f, 136.f));
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// MT: 16-row m-tiles per warp. KSPLIT: warps that split the groups of K
// (their sums meet in shared memory). NSPLIT: warps side by side in N.
template <int MT, int KSPLIT, int NSPLIT>
__global__ void __launch_bounds__(KSPLIT * NSPLIT * 32)
int4_mm_kernel(const __nv_bfloat16* __restrict__ x,
               const uint8_t* __restrict__ q4,
               const float* __restrict__ s,
               float* __restrict__ out,
               int M, int K, int N, int group) {
  constexpr int BM = 16 * MT;
  constexpr int RED_LD = WARP_N + 1;  // padded against bank conflicts
  // k16 steps in flight: 8 keep a decode warp's loads busy; the 64-row
  // tile's 128 accumulator registers leave room for 2.
  constexpr int UNROLL = MT == 1 ? 8 : 2;
  __shared__ float red[KSPLIT > 1 ? KSPLIT * BM * RED_LD : 1];

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int warp_k = warp / NSPLIT;
  const int warp_n = warp % NSPLIT;
  const int g = lane / 4;   // row of the fragment / B column
  const int t4 = lane % 4;  // column pair of the fragment / B k pair
  const int n0 = (blockIdx.x * NSPLIT + warp_n) * WARP_N;
  const int m0 = blockIdx.y * BM;
  if (KSPLIT == 1 && n0 >= N) return;  // ragged last block in N (no barrier follows)

  const int n_groups = K / group;
  const int ksteps = group / 16;

  // This thread's A rows: g and g + 8 of each m-tile; rows past M read 0.
  const __nv_bfloat16* xrow[MT][2];
  bool live[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = m0 + mt * 16 + g + 8 * h;
      live[mt][h] = r < M;
      xrow[mt][h] = x + (long)(r < M ? r : 0) * K;
    }
  }

  float acc[MT][4][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][j][e] = 0.f;

  const uint8_t* qcol = q4 + n0 + 4 * g;
  for (int gi = warp_k; gi < n_groups; gi += KSPLIT) {
    float part[MT][4][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[mt][j][e] = 0.f;

#pragma unroll UNROLL
    for (int ks = 0; ks < ksteps; ++ks) {
      const int k0 = gi * group + ks * 16;  // logical contraction row
      const int r0 = k0 / 2;                // packed row
      const uint32_t w0 = __ldg(reinterpret_cast<const unsigned int*>(
          qcol + (long)(r0 + t4) * N));
      const uint32_t w1 = __ldg(reinterpret_cast<const unsigned int*>(
          qcol + (long)(r0 + 4 + t4) * N));
      uint32_t a[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        a[mt][0] = live[mt][0] ? ld32(xrow[mt][0] + k0 + 2 * t4) : 0u;
        a[mt][1] = live[mt][1] ? ld32(xrow[mt][1] + k0 + 2 * t4) : 0u;
        a[mt][2] = live[mt][0] ? ld32(xrow[mt][0] + k0 + 8 + 2 * t4) : 0u;
        a[mt][3] = live[mt][1] ? ld32(xrow[mt][1] + k0 + 8 + 2 * t4) : 0u;
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint32_t b0 = unpack_byte((w0 >> (8 * j)) & 0xFFu);
        const uint32_t b1 = unpack_byte((w1 >> (8 * j)) & 0xFFu);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) mma_bf16(part[mt][j], a[mt], b0, b1);
      }
    }

    // acc += partial * s[gi, col]. Accumulator element e of n-tile j sits
    // at fragment column 2*t4 + (e & 1), i.e. column n0 + 8*t4 + 4*(e&1) + j.
    const float4 s0 = __ldg(reinterpret_cast<const float4*>(s + (long)gi * N + n0 + 8 * t4));
    const float4 s1 = __ldg(reinterpret_cast<const float4*>(s + (long)gi * N + n0 + 8 * t4 + 4));
    const float se[4] = {s0.x, s0.y, s0.z, s0.w};
    const float so[4] = {s1.x, s1.y, s1.z, s1.w};
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[mt][j][e] += part[mt][j][e] * ((e & 1) ? so[j] : se[j]);
  }

  if constexpr (KSPLIT == 1) {
    // Each thread holds 8 consecutive columns n0 + 8*t4 .. +7 of its rows.
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = m0 + mt * 16 + g + 8 * h;
        if (r >= M) continue;
        float* o = out + (long)r * N + n0 + 8 * t4;
        *reinterpret_cast<float4*>(o) = make_float4(
            acc[mt][0][2 * h], acc[mt][1][2 * h], acc[mt][2][2 * h], acc[mt][3][2 * h]);
        *reinterpret_cast<float4*>(o + 4) = make_float4(
            acc[mt][0][2 * h + 1], acc[mt][1][2 * h + 1], acc[mt][2][2 * h + 1],
            acc[mt][3][2 * h + 1]);
      }
    }
  } else {
    // KSPLIT > 1 (then NSPLIT == 1): add the warps' accumulators.
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = mt * 16 + g + ((e & 2) ? 8 : 0);
          const int col = 8 * t4 + 4 * (e & 1) + j;
          red[(warp_k * BM + row) * RED_LD + col] = acc[mt][j][e];
        }
    __syncthreads();
    for (int i = threadIdx.x; i < BM * WARP_N; i += KSPLIT * NSPLIT * 32) {
      const int row = i / WARP_N;
      const int col = i % WARP_N;
      if (m0 + row >= M) continue;
      float v = 0.f;
#pragma unroll
      for (int w = 0; w < KSPLIT; ++w) v += red[(w * BM + row) * RED_LD + col];
      out[(long)(m0 + row) * N + n0 + col] = v;
    }
  }
}

}  // namespace

// x: (M, K) bf16; q4: (K/2, N) uint8; s: (K/group, N) f32; out: (M, N) f32;
// all contiguous and 16-byte aligned, N % 32 == 0, group % 16 == 0 and
// K % group == 0. Launches on `stream` and returns the launch's cudaError_t
// (0 on success); never synchronizes.
extern "C" int egpt_int4_matmul(const void* x, const void* q4, const void* s,
                                void* out, int M, int K, int N, int group,
                                void* stream) {
  if (M == 0 || N == 0) return 0;
  if (N % WARP_N || group <= 0 || group % 16 || K % group) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = (cudaStream_t)stream;
  const __nv_bfloat16* xp = (const __nv_bfloat16*)x;
  const uint8_t* qp = (const uint8_t*)q4;
  const float* sp = (const float*)s;
  float* op = (float*)out;
  if (M <= 16) {
    dim3 grid(N / WARP_N, 1);
    int4_mm_kernel<1, 8, 1><<<grid, 8 * 32, 0, st>>>(xp, qp, sp, op, M, K, N, group);
  } else {
    constexpr int NSPLIT = 4;
    dim3 grid((N + NSPLIT * WARP_N - 1) / (NSPLIT * WARP_N), (M + 63) / 64);
    int4_mm_kernel<4, 1, NSPLIT><<<grid, NSPLIT * 32, 0, st>>>(xp, qp, sp, op, M, K, N, group);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* egpt_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
