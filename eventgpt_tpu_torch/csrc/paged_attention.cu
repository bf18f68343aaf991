// Single-query GQA decode attention over the paged int8 KV arena (K3),
// written for Hopper (sm_90a) and bound to Python with ctypes.
//
// Replaces eventgpt_tpu/ops/decode_attention.py::_paged_attn_kernel (the
// Pallas TPU kernel launched by decode_attention_int8_paged). The arena is
// (L, N, bs, KV, HD) int8 with one f32 scale per cached vector; a row's
// logical slot p lives at slot p % bs of pool block bt[b, p / bs]. For one
// (batch row b, KV head h) per block it computes, table entry by table
// entry, what the Pallas grid computes along its sequential entry axis:
//   * q rounded to bf16; score[g, j] = (q[g] . k8[j]) in f32, times
//     (k_s[j] * scale) -- the per-vector scale after the dot;
//   * logical slots >= n_valid[b] take the finite NEG_INF = -FLT_MAX;
//   * the running state (m, l, acc) of each query row: m_new = max(m, the
//     entry's max), alpha = exp(m - m_new), p = exp(s - m_new),
//     l = l * alpha + sum p, acc = acc * alpha + bf16(p * v_s) . v8;
//   * out = acc / max(l, 1e-30), in bf16 or f32 (q's dtype).
// With n_valid > 0, an entry past the last visible slot adds exactly
// nothing once m is finite (p = exp(NEG_INF - m) = 0, alpha = 1), so the
// walk stops after ceil(n_valid / bs) entries, and the masked slots of the
// last entry are not read. With n_valid = 0 every slot of every entry has
// s = NEG_INF, m stays NEG_INF and p = 1: the whole table is walked and
// every slot counts with weight 1, as in the Pallas kernel.
//
// Bound on an H100 SXM at the 7B serving shape (B = 4, KV = 32, G = 1,
// HD = 128, bs = 64, 16 table entries, ~860 visible slots a row): the int8
// K and V payloads and their f32 scales over the visible slots, about
// 29 MB -> 8.6 us at 3.35 TB/s. The work is ~0.03 GFLOP, so the kernel is
// bound by bytes.
//
// Design (a plain first version): one block of 8 warps per (b, h), the
// Pallas grid's (B, KV) axes; the entry axis is a loop inside the block,
// three barriers per entry.
//   1. Scores of the entry's bs slots: HD/16 lanes share one key, each
//      loading 16 int8 bytes at once; the partial dots meet by shuffles.
//   2. Warp g owns query row g: the entry's max, the new running max, the
//      rescale alpha, p and bf16(p * v_s) in place, the running sum.
//   3. P.V: warp w takes keys w, w + 8, ..., each lane HD/32 consecutive
//      dims (one coalesced row per warp and key, eight keys in flight);
//      every thread rescales its partial context by alpha first. The 8
//      warps' partials meet in shared memory after the last entry.
// A table entry outside [0, N) is never dereferenced: the block writes NaN
// for its (b, h) instead. Decode attention is far below the card's ridge
// point, so the tensor cores are not used.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NWARPS = 8;
constexpr int THREADS = NWARPS * 32;
constexpr int GMAX = 8;              // query heads per KV head
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

template <int HD>
__global__ void __launch_bounds__(THREADS)
paged_int8_kernel(const __nv_bfloat16* __restrict__ q,
                  const int8_t* __restrict__ kq, const float* __restrict__ ks,
                  const int8_t* __restrict__ vq, const float* __restrict__ vs,
                  const int* __restrict__ bt, const int* __restrict__ n_valid,
                  void* __restrict__ out, int out_bf16, int li, int N, int bs,
                  int nbpr, int KV, int G, float scale) {
  extern __shared__ __align__(16) float smem[];
  float* qf = smem;                     // [G][HD]  q as f32 of its bf16
  float* sc = qf + G * HD;              // [G][bs]  scores, then bf16(p * v_s)
  float* red = sc + G * bs;             // [NWARPS][G][HD]  P.V partial sums
  float* row_m = red + NWARPS * G * HD;  // [GMAX] running max
  float* row_l = row_m + GMAX;          // [GMAX] running sum
  float* row_a = row_l + GMAX;          // [GMAX] this entry's rescale

  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int nv = n_valid[b];
  const int n_ent = nv > 0 ? min((nv - 1) / bs + 1, nbpr) : nbpr;
  const int* btr = bt + (long)b * nbpr;
  const long obase = ((long)b * KV + h) * G * HD;

  int bad = 0;
  for (int i = threadIdx.x; i < n_ent; i += THREADS) bad |= btr[i] < 0 || btr[i] >= N;
  if (__syncthreads_or(bad)) {
    for (int i = threadIdx.x; i < G * HD; i += THREADS) {
      if (out_bf16) {
        reinterpret_cast<__nv_bfloat16*>(out)[obase + i] = __float2bfloat16_rn(NAN);
      } else {
        reinterpret_cast<float*>(out)[obase + i] = NAN;
      }
    }
    return;
  }

  const __nv_bfloat16* qb = q + obase;
  for (int i = threadIdx.x; i < G * HD; i += THREADS) qf[i] = __bfloat162float(qb[i]);
  if (threadIdx.x < GMAX) {
    row_m[threadIdx.x] = NEG_INF;
    row_l[threadIdx.x] = 0.f;
  }
  __syncthreads();

  const long pitch = (long)KV * HD;  // bytes between slots
  constexpr int LPK = HD / 16;       // lanes per key
  constexpr int KPW = 32 / LPK;      // keys per warp and step
  constexpr int STEP = NWARPS * KPW;
  const int part = lane % LPK;
  const int sub = lane / LPK;
  constexpr int DPL = HD / 32;       // dims per lane in P.V
  using VT = typename Bytes<DPL>::T;
  constexpr int VUNR = 8;
  float acc[GMAX][DPL];
#pragma unroll
  for (int g = 0; g < GMAX; ++g)
#pragma unroll
    for (int d = 0; d < DPL; ++d) acc[g][d] = 0.f;

  for (int ni = 0; ni < n_ent; ++ni) {
    const long slot0 = ((long)li * N + btr[ni]) * bs;  // first slot of the block
    const int8_t* kbase = kq + slot0 * pitch + (long)h * HD;
    const int8_t* vbase = vq + slot0 * pitch + (long)h * HD;
    const float* ksb = ks + slot0 * KV + h;
    const float* vsb = vs + slot0 * KV + h;
    // Visible slots of this entry, and the slots whose V the product needs
    // (all of them when nothing is visible: each weighs 1).
    const int n_vis = nv > 0 ? min(bs, nv - ni * bs) : 0;
    const int n_pv = nv > 0 ? n_vis : bs;

    // 1. Scores; masked slots read nothing.
    for (int j0 = warp * KPW; j0 < bs; j0 += 2 * STEP) {
      int4 raw[2];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int j = j0 + u * STEP + sub;
        raw[u] = j < n_vis
                     ? *reinterpret_cast<const int4*>(kbase + (long)j * pitch + part * 16)
                     : make_int4(0, 0, 0, 0);
      }
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int j = j0 + u * STEP + sub;
        const bool vis = j < n_vis;
        const float kscale = vis ? ksb[(long)j * KV] * scale : 0.f;
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
          if (part == 0 && j < bs) sc[g * bs + j] = vis ? dot * kscale : NEG_INF;
        }
      }
    }
    __syncthreads();

    // 2. The online-softmax update of query row `warp`.
    if (warp < G) {
      float* row = sc + warp * bs;
      float mx = NEG_INF;
      for (int j = lane; j < bs; j += 32) mx = fmaxf(mx, row[j]);
      mx = warp_max(mx);
      const float m_old = row_m[warp];
      const float m_new = fmaxf(m_old, mx);
      const float alpha = expf(m_old - m_new);
      float l = 0.f;
      for (int j = lane; j < bs; j += 32) {
        const float p = expf(row[j] - m_new);
        l += p;
        // Past n_pv, p is exactly 0 (m_new is finite there).
        row[j] = j < n_pv ? __bfloat162float(__float2bfloat16_rn(p * vsb[(long)j * KV])) : 0.f;
      }
      l = warp_sum(l);
      __syncwarp();
      if (lane == 0) {
        row_m[warp] = m_new;
        row_l[warp] = row_l[warp] * alpha + l;
        row_a[warp] = alpha;
      }
    }
    __syncthreads();

    // 3. acc = acc * alpha + P.V over the int8 values.
#pragma unroll
    for (int g = 0; g < GMAX; ++g) {
      if (g >= G) break;
      const float a = row_a[g];
#pragma unroll
      for (int d = 0; d < DPL; ++d) acc[g][d] *= a;
    }
    for (int j0 = warp; j0 < n_pv; j0 += NWARPS * VUNR) {
      VT raw[VUNR];
#pragma unroll
      for (int u = 0; u < VUNR; ++u) {
        const int j = j0 + u * NWARPS;
        raw[u] = j < n_pv ? *reinterpret_cast<const VT*>(vbase + (long)j * pitch + lane * DPL)
                          : VT(0);
      }
#pragma unroll
      for (int u = 0; u < VUNR; ++u) {
        const int j = j0 + u * NWARPS;
        if (j >= n_pv) break;
        const int8_t* v8 = reinterpret_cast<const int8_t*>(&raw[u]);
#pragma unroll
        for (int g = 0; g < GMAX; ++g) {
          if (g >= G) break;
          const float p = sc[g * bs + j];
#pragma unroll
          for (int d = 0; d < DPL; ++d) acc[g][d] = fmaf(p, (float)v8[d], acc[g][d]);
        }
      }
    }
    __syncthreads();  // sc and row_a are rewritten by the next entry
  }

#pragma unroll
  for (int g = 0; g < GMAX; ++g) {
    if (g >= G) break;
#pragma unroll
    for (int d = 0; d < DPL; ++d) red[(warp * G + g) * HD + lane * DPL + d] = acc[g][d];
  }
  __syncthreads();

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

size_t smem_bytes(int bs, int G, int HD) {
  return sizeof(float) * ((size_t)G * HD + (size_t)G * bs + (size_t)NWARPS * G * HD + 3 * GMAX);
}

template <int HD>
int launch(const void* q, const void* kq, const void* ks, const void* vq, const void* vs,
           const void* bt, const void* n_valid, void* out, int out_bf16, int li, int B,
           int N, int bs, int nbpr, int KV, int G, float scale, cudaStream_t stream) {
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        paged_int8_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  dim3 grid(B, KV);
  paged_int8_kernel<HD><<<grid, THREADS, smem_bytes(bs, G, HD), stream>>>(
      (const __nv_bfloat16*)q, (const int8_t*)kq, (const float*)ks, (const int8_t*)vq,
      (const float*)vs, (const int*)bt, (const int*)n_valid, out, out_bf16, li, N, bs, nbpr,
      KV, G, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q: (B, KV, G, HD) bf16; kq/vq: (L, N, bs, KV, HD) int8; ks/vs:
// (L, N, bs, KV, 1) f32; bt: (B, nbpr) int32; n_valid: (B,) int32; out:
// (B, KV, G, HD) bf16 when out_bf16 else f32. All contiguous and 16-byte
// aligned; HD in {32, 64, 128}; 1 <= G <= 8; 0 <= li < L. Launches on
// `stream` and returns the launch's cudaError_t (0 on success); never
// synchronizes.
extern "C" int egpt_decode_attention_int8_paged(const void* q, const void* kq, const void* ks,
                                                const void* vq, const void* vs, const void* bt,
                                                const void* n_valid, void* out, int out_bf16,
                                                int li, int B, int N, int bs, int nbpr, int KV,
                                                int G, int HD, float scale, void* stream) {
  if (B == 0 || KV == 0) return 0;
  if (N <= 0 || bs <= 0 || nbpr <= 0 || G < 1 || G > GMAX ||
      smem_bytes(bs, G, HD) > (size_t)MAX_SMEM) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = (cudaStream_t)stream;
  switch (HD) {
    case 32: return launch<32>(q, kq, ks, vq, vs, bt, n_valid, out, out_bf16, li, B, N, bs, nbpr, KV, G, scale, st);
    case 64: return launch<64>(q, kq, ks, vq, vs, bt, n_valid, out, out_bf16, li, B, N, bs, nbpr, KV, G, scale, st);
    case 128: return launch<128>(q, kq, ks, vq, vs, bt, n_valid, out, out_bf16, li, B, N, bs, nbpr, KV, G, scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* egpt_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
