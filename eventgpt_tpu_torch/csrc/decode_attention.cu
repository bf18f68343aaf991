// Single-query GQA decode attention over the stacked int8 KV cache (K2),
// written for Hopper (sm_90a) and bound to Python with ctypes.
//
// Replaces eventgpt_tpu/ops/decode_attention.py::_decode_attn_kernel (the
// Pallas TPU kernel launched by decode_attention_int8). It computes the
// same function for one (batch row b, KV head h) per block:
//   * q rounded to bf16; score[g, j] = (q[g] . k8[j]) in f32, times
//     (k_s[j] * scale) in f32 -- the per-vector scale applied after the dot;
//   * slots j >= n_valid[b] take the finite NEG_INF = -FLT_MAX, so a row
//     with n_valid = 0 averages all S slots, as the Pallas kernel does;
//   * p = exp(score - max), l = sum p; p * v_s[j] is rounded to bf16
//     before the P.V dot with the int8 values;
//   * out = (P.V) / max(l, 1e-30), in bf16 or f32 (q's dtype).
// The kernel takes the full (L, B, S, KV, hd) buffers and the layer index
// li and offsets to layer li itself, so no per-layer copy is made.
//
// Bound on an H100 SXM at the 7B decode shape (B = 4, KV = 32, G = 1,
// hd = 128, ~850 visible slots a row): the int8 K and V payloads plus
// their f32 scales over the visible slots, about 28 MB -> 8.5 us at
// 3.35 TB/s. The work is ~0.03 GFLOP, so the kernel is bound by bytes.
//
// Design (a plain first version): one block of 8 warps per (b, h), the
// Pallas grid (B, KV). Two passes over the visible slots, with the f32
// scores of the G query rows kept in shared memory between them, so the
// softmax is computed exactly as in the Pallas kernel (no online
// rescaling of the bf16-rounded p * v_s).
//   1. Scores: hd/16 lanes share one key, each loading 16 int8 bytes with
//      one 16-byte load; four keys per lane are in flight at a time. The
//      int8 -> f32 cast happens in registers; the partial dots meet by
//      warp shuffles.
//   2. Max, exp, row sums and the bf16 rounding of p * v_s, in place.
//   3. P.V: each warp takes every 8th key, each lane hd/32 consecutive
//      dims of it (one coalesced 128-byte row per warp and key, eight keys
//      in flight); the 8 warps' sums meet in shared memory.
// Decode attention is far below the card's ridge point, so the tensor
// cores are not used.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

namespace {

constexpr int NWARPS = 8;
constexpr int THREADS = NWARPS * 32;
constexpr int GMAX = 8;  // query heads per KV head
constexpr float NEG_INF = -FLT_MAX;  // finfo(float32).min
constexpr int MAX_SMEM = 232448;     // 227 KB, the most a block can use

template <int N> struct Bytes;
template <> struct Bytes<1> { using T = uint8_t; };
template <> struct Bytes<2> { using T = uint16_t; };
template <> struct Bytes<4> { using T = uint32_t; };

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffff, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffff, v, o));
  return v;
}

// Reduce one value per thread over the block (sum or max); every thread
// gets the result. `stat` holds NWARPS floats.
template <bool MAX>
__device__ __forceinline__ float block_reduce(float v, float* stat) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  v = MAX ? warp_max(v) : warp_sum(v);
  __syncthreads();  // stat is free
  if (lane == 0) stat[warp] = v;
  __syncthreads();
  float r = stat[0];
#pragma unroll
  for (int w = 1; w < NWARPS; ++w) r = MAX ? fmaxf(r, stat[w]) : r + stat[w];
  return r;
}

template <int HD>
__global__ void __launch_bounds__(THREADS)
decode_int8_kernel(const __nv_bfloat16* __restrict__ q,
                   const int8_t* __restrict__ kq, const float* __restrict__ ks,
                   const int8_t* __restrict__ vq, const float* __restrict__ vs,
                   const int* __restrict__ n_valid, void* __restrict__ out,
                   int out_bf16, int li, int B, int S, int KV, int G,
                   float scale) {
  extern __shared__ __align__(16) float smem[];
  float* qf = smem;                   // [G][HD]  q as f32 of its bf16
  float* sc = qf + G * HD;            // [G][S]   scores, then bf16(p * v_s)
  float* red = sc + G * S;            // [NWARPS][G][HD]  P.V partial sums
  float* stat = red + NWARPS * G * HD;  // [NWARPS]
  float* row_l = stat + NWARPS;         // [GMAX]

  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int nv = n_valid[b];
  // Slots >= nv contribute exp(NEG_INF - max) = 0 unless no slot is
  // visible; then every slot of the row counts with p = 1.
  const int n_loop = nv > 0 ? min(nv, S) : S;

  const long slot0 = ((long)li * B + b) * S;  // first slot of (li, b)
  const long pitch = (long)KV * HD;           // bytes between slots
  const int8_t* kbase = kq + slot0 * pitch + (long)h * HD;
  const int8_t* vbase = vq + slot0 * pitch + (long)h * HD;
  const float* ksb = ks + slot0 * KV + h;
  const float* vsb = vs + slot0 * KV + h;

  const __nv_bfloat16* qb = q + ((long)b * KV + h) * G * HD;
  for (int i = threadIdx.x; i < G * HD; i += THREADS) qf[i] = __bfloat162float(qb[i]);
  __syncthreads();

  // 1. Scores.
  constexpr int LPK = HD / 16;    // lanes per key
  constexpr int KPW = 32 / LPK;   // keys per warp and step
  constexpr int UNR = 4;          // steps in flight
  constexpr int STEP = NWARPS * KPW;
  const int part = lane % LPK;
  const int sub = lane / LPK;
  for (int j0 = warp * KPW; j0 < n_loop; j0 += STEP * UNR) {
    int4 raw[UNR];
#pragma unroll
    for (int u = 0; u < UNR; ++u) {
      const int j = j0 + u * STEP + sub;
      raw[u] = j < n_loop
                   ? *reinterpret_cast<const int4*>(kbase + (long)j * pitch + part * 16)
                   : make_int4(0, 0, 0, 0);
    }
#pragma unroll
    for (int u = 0; u < UNR; ++u) {
      const int j = j0 + u * STEP + sub;
      const bool in = j < n_loop;
      const float kscale = in ? ksb[(long)j * KV] * scale : 0.f;
      const int8_t* k8 = reinterpret_cast<const int8_t*>(&raw[u]);
#pragma unroll
      for (int g = 0; g < GMAX; ++g) {
        if (g >= G) break;
        const float4* qg = reinterpret_cast<const float4*>(qf + g * HD + part * 16);
        float dot = 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float4 qv = qg[i];
          dot = fmaf((float)k8[4 * i + 0], qv.x, dot);
          dot = fmaf((float)k8[4 * i + 1], qv.y, dot);
          dot = fmaf((float)k8[4 * i + 2], qv.z, dot);
          dot = fmaf((float)k8[4 * i + 3], qv.w, dot);
        }
#pragma unroll
        for (int o = LPK / 2; o > 0; o >>= 1) dot += __shfl_xor_sync(0xffffffff, dot, o);
        if (part == 0 && in) sc[g * S + j] = j < nv ? dot * kscale : NEG_INF;
      }
    }
  }
  __syncthreads();

  // 2. Softmax numerators, rounded to bf16 after the v_s scale.
  for (int g = 0; g < G; ++g) {
    float* row = sc + g * S;
    float mx = NEG_INF;
    for (int j = threadIdx.x; j < n_loop; j += THREADS) mx = fmaxf(mx, row[j]);
    mx = block_reduce<true>(mx, stat);
    float l = 0.f;
    for (int j = threadIdx.x; j < n_loop; j += THREADS) {
      const float p = expf(row[j] - mx);
      l += p;
      row[j] = __bfloat162float(__float2bfloat16_rn(p * vsb[(long)j * KV]));
    }
    l = block_reduce<false>(l, stat);
    if (threadIdx.x == 0) row_l[g] = l;
  }
  __syncthreads();

  // 3. P.V over the int8 values.
  constexpr int DPL = HD / 32;  // dims per lane
  using VT = typename Bytes<DPL>::T;
  constexpr int VUNR = 8;
  float acc[GMAX][DPL];
#pragma unroll
  for (int g = 0; g < GMAX; ++g)
#pragma unroll
    for (int d = 0; d < DPL; ++d) acc[g][d] = 0.f;
  for (int j0 = warp; j0 < n_loop; j0 += NWARPS * VUNR) {
    VT raw[VUNR];
#pragma unroll
    for (int u = 0; u < VUNR; ++u) {
      const int j = j0 + u * NWARPS;
      raw[u] = j < n_loop ? *reinterpret_cast<const VT*>(vbase + (long)j * pitch + lane * DPL)
                          : VT(0);
    }
#pragma unroll
    for (int u = 0; u < VUNR; ++u) {
      const int j = j0 + u * NWARPS;
      if (j >= n_loop) break;
      const int8_t* v8 = reinterpret_cast<const int8_t*>(&raw[u]);
#pragma unroll
      for (int g = 0; g < GMAX; ++g) {
        if (g >= G) break;
        const float p = sc[g * S + j];
#pragma unroll
        for (int d = 0; d < DPL; ++d) acc[g][d] = fmaf(p, (float)v8[d], acc[g][d]);
      }
    }
  }
#pragma unroll
  for (int g = 0; g < GMAX; ++g) {
    if (g >= G) break;
#pragma unroll
    for (int d = 0; d < DPL; ++d) red[(warp * G + g) * HD + lane * DPL + d] = acc[g][d];
  }
  __syncthreads();

  const long obase = ((long)b * KV + h) * G * HD;
  for (int i = threadIdx.x; i < G * HD; i += THREADS) {
    float o = 0.f;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) o += red[w * G * HD + i];
    o = o / fmaxf(row_l[i / HD], 1e-30f);
    if (out_bf16) {
      reinterpret_cast<__nv_bfloat16*>(out)[obase + i] = __float2bfloat16_rn(o);
    } else {
      reinterpret_cast<float*>(out)[obase + i] = o;
    }
  }
}

size_t smem_bytes(int S, int G, int HD) {
  return sizeof(float) * ((size_t)G * HD + (size_t)G * S + (size_t)NWARPS * G * HD +
                          NWARPS + GMAX);
}

template <int HD>
int launch(const void* q, const void* kq, const void* ks, const void* vq,
           const void* vs, const void* n_valid, void* out, int out_bf16, int li,
           int B, int S, int KV, int G, float scale, cudaStream_t stream) {
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        decode_int8_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  dim3 grid(B, KV);
  decode_int8_kernel<HD><<<grid, THREADS, smem_bytes(S, G, HD), stream>>>(
      (const __nv_bfloat16*)q, (const int8_t*)kq, (const float*)ks,
      (const int8_t*)vq, (const float*)vs, (const int*)n_valid, out, out_bf16,
      li, B, S, KV, G, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q: (B, KV, G, HD) bf16; kq/vq: (L, B, S, KV, HD) int8; ks/vs:
// (L, B, S, KV, 1) f32; n_valid: (B,) int32; out: (B, KV, G, HD) bf16 when
// out_bf16 else f32. All contiguous and 16-byte aligned; HD in {32, 64,
// 128}; 1 <= G <= 8; 0 <= li < L. Launches on `stream` and returns the
// launch's cudaError_t (0 on success); never synchronizes.
extern "C" int egpt_decode_attention_int8(const void* q, const void* kq,
                                          const void* ks, const void* vq,
                                          const void* vs, const void* n_valid,
                                          void* out, int out_bf16, int li, int B,
                                          int S, int KV, int G, int HD,
                                          float scale, void* stream) {
  if (B == 0 || KV == 0) return 0;
  if (S <= 0 || G < 1 || G > GMAX || smem_bytes(S, G, HD) > (size_t)MAX_SMEM) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = (cudaStream_t)stream;
  switch (HD) {
    case 32: return launch<32>(q, kq, ks, vq, vs, n_valid, out, out_bf16, li, B, S, KV, G, scale, st);
    case 64: return launch<64>(q, kq, ks, vq, vs, n_valid, out, out_bf16, li, B, S, KV, G, scale, st);
    case 128: return launch<128>(q, kq, ks, vq, vs, n_valid, out, out_bf16, li, B, S, KV, G, scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* egpt_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
