// Flash attention forward for prefill, bf16 in / bf16 out, head_dim 128,
// written for Hopper (sm_90a) and bound to Python with ctypes.
//
// Replaces eventgpt_tpu/ops/flash_attention.py::_flash_kernel (the Pallas
// TPU kernel launched by _flash_forward). It computes the same function:
// causal + key-padding masked softmax attention with an online softmax in
// f32, never materializing the (S, S) scores in device memory.
//
//   * scores are q.k in f32 times 1/sqrt(hd) in f32. bf16 x bf16 products
//     are exact in the f32 accumulator, so scaling the f32 scores equals
//     scaling q in f32 before the dot (the Pallas kernel's order) up to
//     f32 rounding;
//   * masked scores are the finite NEG_INF = finfo(f32).min, never -inf,
//     so a fully masked tile gives exp(0) terms that a later real maximum
//     wipes out, as in the Pallas kernel, and never NaN;
//   * l is clamped at 1e-30 before the division;
//   * the KV loop stops at the causal diagonal;
//   * query rows whose valid flag is 0 are written as exact zeros.
//
// Bound on an H100 SXM at the 7B prefill shape (B=4, S=849, H=32, hd=128):
// q, k, v and out move 111 MB -> 33 us at 3.35 TB/s; the causal work is
// 23.6 GFLOP -> 24 us at 989 TFLOP/s bf16. The kernel is bound by bytes.
//
// Design (a plain first version): one block of 4 warps per (b*h, 64-row
// q tile). Each warp owns 16 query rows and keeps its Q fragments, its
// running max/sum and its 16x128 f32 output accumulator in registers.
// K and V tiles of 64 keys are staged in shared memory (row pitch padded
// to 136 elements against bank conflicts); both products run on the
// tensor cores through mma.sync m16n8k16 (bf16 in, f32 accumulate), and P
// is rounded to bf16 for the P.V product. Q, K and V are read straight
// from the (B, S, H, hd) layout, so no transpose pass is needed.
// wgmma, TMA and a pipelined K/V ring are left for a later version.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

namespace {

constexpr int HD = 128;       // head dim (the only one supported)
constexpr int BQ = 64;        // query rows per block
constexpr int BK = 64;        // keys per K/V tile
constexpr int WARPS = 4;      // 16 query rows per warp
constexpr int LD = HD + 8;    // padded shared-memory row pitch (elements)
constexpr float NEG_INF = -FLT_MAX;  // finfo(float32).min

constexpr int SMEM_BYTES = 3 * BQ * LD * sizeof(__nv_bfloat16) + BK * sizeof(int);

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_raw(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  __nv_bfloat162 v;
  v.x = lo;
  v.y = hi;
  return *reinterpret_cast<uint32_t*>(&v);
}

// D = A(16x16 bf16, row) * B(16x8 bf16, col) + D, f32 accumulate.
__device__ __forceinline__ void mma_bf16(float d[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Copy rows [row0, row0 + 64) of one head into shared memory; rows at or
// past S are zero-filled. 16-byte vector loads: 16 per 256-byte row.
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src,
                                          int row0, int S, long row_stride) {
  for (int c = threadIdx.x; c < BQ * (HD / 8); c += WARPS * 32) {
    const int r = c / (HD / 8);
    const int col = (c % (HD / 8)) * 8;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (row0 + r < S) {
      val = *reinterpret_cast<const uint4*>(src + (long)(row0 + r) * row_stride + col);
    }
    *reinterpret_cast<uint4*>(dst + r * LD + col) = val;
  }
}

__global__ void __launch_bounds__(WARPS * 32)
flash_fwd_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 const uint8_t* __restrict__ valid,
                 __nv_bfloat16* __restrict__ out,
                 int S, int H, int causal, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* ks = qs + BQ * LD;
  __nv_bfloat16* vs = ks + BK * LD;
  int* kvalid = reinterpret_cast<int*>(vs + BK * LD);

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh % H;
  const int q0 = blockIdx.y * BQ;
  const long row_stride = (long)H * HD;  // elements between sequence rows
  const long head_base = (long)b * S * row_stride + (long)h * HD;
  const uint8_t* valid_b = valid + (long)b * S;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;   // row within the 8-row group of a fragment
  const int t4 = lane % 4;  // column pair within the fragment

  load_tile(qs, q + head_base, q0, S, row_stride);
  __syncthreads();

  // Q fragments for the warp's 16 rows, all 8 k-steps of hd = 128.
  uint32_t qf[HD / 16][4];
  const __nv_bfloat16* qw = qs + (warp * 16) * LD;
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    qf[kk][0] = ld32(qw + g * LD + kk * 16 + t4 * 2);
    qf[kk][1] = ld32(qw + (g + 8) * LD + kk * 16 + t4 * 2);
    qf[kk][2] = ld32(qw + g * LD + kk * 16 + t4 * 2 + 8);
    qf[kk][3] = ld32(qw + (g + 8) * LD + kk * 16 + t4 * 2 + 8);
  }

  float o[HD / 8][4];
#pragma unroll
  for (int d = 0; d < HD / 8; ++d) {
    o[d][0] = o[d][1] = o[d][2] = o[d][3] = 0.f;
  }
  float m[2] = {NEG_INF, NEG_INF};
  float l[2] = {0.f, 0.f};  // this thread's share of the row sums
  const int row[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};

  const int n_kv = (S + BK - 1) / BK;
  // KV tiles past the diagonal contribute nothing under the causal mask.
  const int n_kv_eff = causal ? min((q0 + BQ - 1) / BK + 1, n_kv) : n_kv;

  for (int kb = 0; kb < n_kv_eff; ++kb) {
    const int k0 = kb * BK;
    __syncthreads();  // the previous tile is no longer read
    load_tile(ks, k + head_base, k0, S, row_stride);
    load_tile(vs, v + head_base, k0, S, row_stride);
    for (int j = threadIdx.x; j < BK; j += WARPS * 32) {
      kvalid[j] = (k0 + j < S) ? (int)valid_b[k0 + j] : 0;
    }
    __syncthreads();

    // Scores: 16 rows x 64 keys per warp, 8 n-tiles of 8 keys.
    float s[BK / 8][4];
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
      const __nv_bfloat16* kr = ks + (n * 8 + g) * LD + t4 * 2;
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        mma_bf16(s[n], qf[kk], ld32(kr + kk * 16), ld32(kr + kk * 16 + 8));
      }
    }

    // Scale, mask, and this tile's row maxima.
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key_local = n * 8 + t4 * 2 + (e & 1);
        const int r = e >> 1;
        const bool keep = kvalid[key_local] != 0 &&
                          (!causal || k0 + key_local <= row[r]);
        const float val = keep ? s[n][e] * scale : NEG_INF;
        s[n][e] = val;
        mx[r] = fmaxf(mx[r], val);
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffff, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffff, mx[r], 2));
    }

    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_new = fmaxf(m[r], mx[r]);
      corr[r] = expf(m[r] - m_new);
      m[r] = m_new;
      l[r] *= corr[r];
    }
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const float p = expf(s[n][e] - m[r]);
        s[n][e] = p;
        l[r] += p;
      }
    }
#pragma unroll
    for (int d = 0; d < HD / 8; ++d) {
      o[d][0] *= corr[0];
      o[d][1] *= corr[0];
      o[d][2] *= corr[1];
      o[d][3] *= corr[1];
    }

    // O += P . V; P comes straight from the score accumulators.
#pragma unroll
    for (int j = 0; j < BK / 16; ++j) {
      uint32_t pa[4];
      pa[0] = pack_bf16(s[2 * j][0], s[2 * j][1]);
      pa[1] = pack_bf16(s[2 * j][2], s[2 * j][3]);
      pa[2] = pack_bf16(s[2 * j + 1][0], s[2 * j + 1][1]);
      pa[3] = pack_bf16(s[2 * j + 1][2], s[2 * j + 1][3]);
      const __nv_bfloat16* v0 = vs + (j * 16 + t4 * 2) * LD + g;
#pragma unroll
      for (int d = 0; d < HD / 8; ++d) {
        const __nv_bfloat16* vp = v0 + d * 8;
        const uint32_t b0 = pack_raw(vp[0], vp[LD]);
        const uint32_t b1 = pack_raw(vp[8 * LD], vp[9 * LD]);
        mma_bf16(o[d], pa, b0, b1);
      }
    }
  }

  // Full row sums across the 4 threads that share a row.
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffff, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffff, l[r], 2);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row[r] >= S) continue;
    const bool live = valid_b[row[r]] != 0;
    const float inv = 1.f / fmaxf(l[r], 1e-30f);
    __nv_bfloat16* orow = out + head_base + (long)row[r] * row_stride + t4 * 2;
#pragma unroll
    for (int d = 0; d < HD / 8; ++d) {
      const float x0 = live ? o[d][2 * r] * inv : 0.f;
      const float x1 = live ? o[d][2 * r + 1] * inv : 0.f;
      *reinterpret_cast<uint32_t*>(orow + d * 8) = pack_bf16(x0, x1);
    }
  }
}

}  // namespace

// q, k, v, out: (B, S, H, 128) bf16, contiguous, 16-byte aligned.
// valid: (B, S) uint8 (0 = padding). Launches on `stream` and returns the
// launch's cudaError_t (0 on success); never synchronizes.
extern "C" int egpt_flash_attention_fwd_bf16(const void* q, const void* k,
                                             const void* v, const void* valid,
                                             void* out, int B, int S, int H,
                                             int causal, float scale,
                                             void* stream) {
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  if (B == 0 || S == 0 || H == 0) return 0;
  dim3 grid(B * H, (S + BQ - 1) / BQ);
  flash_fwd_kernel<<<grid, WARPS * 32, SMEM_BYTES, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, (const uint8_t*)valid, (__nv_bfloat16*)out, S,
      H, causal, scale);
  return (int)cudaGetLastError();
}

extern "C" const char* egpt_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
