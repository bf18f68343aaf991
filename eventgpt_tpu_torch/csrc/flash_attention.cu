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
// What bounds it on an H100 SXM. At the 7B prefill shape (B=4, S=849,
// H=32, hd=128) q, k, v and out move 111 MB -> 33 us at 3.35 TB/s, and the
// causal work is 23.6 GFLOP -> 24 us at 989 TFLOP/s bf16: bytes bound it
// on paper. In practice latency bounds it (about 4x the byte bound):
// every 64-key tile costs a warp 128 mma.sync, 32 expf per thread, the
// masking and the rescale of its 16 x 128 f32 accumulator, and a K and V
// tile from L2. The 4 warps of a block run these phases in step between
// the per-tile barriers, and 226 registers a thread leave 2 blocks (8
// warps) an SM to hide each phase's latency; no one phase dominates.
//
// Design. One block of 4 warps per (b*h, 64-row q tile); each warp owns 16
// query rows and keeps its Q fragments, running max/sum and 16 x 128 f32
// output accumulator in registers. Both products run on the tensor cores
// through mma.sync m16n8k16 (bf16 in, f32 accumulate); P is rounded to
// bf16 for the P.V product.
//   * Fragments come from ldmatrix: Q's A operands and K's B operands
//     through ldmatrix.x4, V's B operands through ldmatrix.x4.trans, one
//     instruction per two mma.sync. Rows keep the 136-element (272-byte)
//     pitch, so the 8 rows of each 8x8 matrix fall in 8 distinct 16-byte
//     bank groups: no bank conflict.
//   * A 2-stage cp.async ring of K and V tiles: tile kb + 1 is in flight
//     while tile kb computes, with one block barrier per tile. Rows at or
//     past S are zero-filled by the src-size form of cp.async. Q is staged
//     in stage 1 before the loop, read into registers, and then given back
//     to the ring. 68 KB of shared memory per block.
//   * The tile's 64 key flags become one 64-bit mask in a register: each
//     lane loads two flag bytes one tile ahead, and two warp ballots pack
//     them. The mask test reads that register, not shared memory, and a
//     tile whose every key is valid and at or before the warp's first row
//     skips the test (it would keep every score).
//   * The output leaves through shared memory: each warp stages its 16 rows
//     in the stage the last tile left free and stores them 16 bytes a
//     lane, a 256-byte row per half warp.
//   * Heaviest first: under causal, block y computes q tile
//     n_qtiles - 1 - y, so the blocks that walk the most KV tiles (the
//     last q tiles of every head, B*H on x) start in the first wave and
//     the one-tile blocks fill the tail.
//
// Bit identity with the first version of this kernel (the plain-load
// design). Each output row depends only on the values in the fragment
// registers, the order of the mma.sync chains (n tiles, then k16 steps
// for Q.K; j, then d for P.V), the 64-key tile order, expf on the scaled
// f32 score, the element order of the row sums and the two shuffle
// reductions. The redesign keeps all of them and only changes how the
// same values reach the same registers and when blocks run; each warp
// still walks KV tiles 0 .. q0 / 64 of its own 64-row q tile.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

namespace {

constexpr int HD = 128;       // head dim (the only one supported)
constexpr int BQ = 64;        // query rows per block
constexpr int BK = 64;        // keys per K/V tile
constexpr int WARPS = 4;      // 16 query rows per warp
constexpr int THREADS = WARPS * 32;
constexpr int LD = HD + 8;    // padded shared-memory row pitch (elements)
constexpr int TILE_BYTES = BK * LD * 2;
constexpr int STAGES = 2;     // each stage: a K tile, then a V tile
constexpr float NEG_INF = -FLT_MAX;  // finfo(float32).min

constexpr int SMEM_BYTES = STAGES * 2 * TILE_BYTES;
static_assert(BQ == BK, "Q is staged in a K slot of the ring");

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
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

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte copy from device to shared memory; with `pred` false it reads
// nothing and writes 16 zero bytes.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(pred ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(PENDING) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// Start copying rows [row0, row0 + 64) of one head into the tile at `dst`;
// rows at or past S are zero-filled. 16 bytes a copy, 16 copies a row: a
// thread copies the same 16 columns of every 8th row, so its addresses
// step by constants.
constexpr int ROWS_PER_PASS = THREADS / (HD / 8);
__device__ __forceinline__ void load_tile_async(uint32_t dst, const __nv_bfloat16* src,
                                                int row0, int S, long row_stride) {
  const int r0 = threadIdx.x / (HD / 8);
  const int col = (threadIdx.x % (HD / 8)) * 8;
  const __nv_bfloat16* p = src + (long)(row0 + r0) * row_stride + col;
  dst += (r0 * LD + col) * 2;
#pragma unroll
  for (int i = 0; i < BK / ROWS_PER_PASS; ++i) {
    const bool ok = row0 + r0 + i * ROWS_PER_PASS < S;
    cp_async16(dst + i * ROWS_PER_PASS * LD * 2, ok ? p : src, ok);
    p += ROWS_PER_PASS * row_stride;
  }
}

// One key flag byte, 0 at or past S.
__device__ __forceinline__ uint32_t key_flag(const uint8_t* valid_b, int key, int S) {
  return key < S ? valid_b[key] : 0u;
}

__global__ void __launch_bounds__(THREADS, 2)
flash_fwd_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 const uint8_t* __restrict__ valid,
                 __nv_bfloat16* __restrict__ out,
                 int S, int H, int causal, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t ring = smem_u32(smem);  // stage st: K at st * 2 tiles, V after it

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh % H;
  const int q_tile = causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int q0 = q_tile * BQ;
  const long row_stride = (long)H * HD;  // elements between sequence rows
  const long head_base = (long)b * S * row_stride + (long)h * HD;
  const uint8_t* valid_b = valid + (long)b * S;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;   // row within the 8-row group of a fragment
  const int t4 = lane % 4;  // column pair within the fragment

  const int n_kv = (S + BK - 1) / BK;
  // KV tiles past the diagonal contribute nothing under the causal mask.
  const int n_kv_eff = causal ? min((q0 + BQ - 1) / BK + 1, n_kv) : n_kv;

  // Q into stage 1's K slot, KV tile 0 into stage 0, tile 0's key flags
  // into registers.
  load_tile_async(ring + 2 * TILE_BYTES, q + head_base, q0, S, row_stride);
  cp_async_commit();
  load_tile_async(ring, k + head_base, 0, S, row_stride);
  load_tile_async(ring + TILE_BYTES, v + head_base, 0, S, row_stride);
  cp_async_commit();
  uint32_t flag_lo = key_flag(valid_b, lane, S);
  uint32_t flag_hi = key_flag(valid_b, lane + 32, S);
  cp_async_wait<1>();
  __syncthreads();

  // Q fragments for the warp's 16 rows, all 8 k-steps of hd = 128: lanes
  // 0-15 address rows 0-15 at column 0 (a0, a1), lanes 16-31 at column 8
  // (a2, a3).
  uint32_t qf[HD / 16][4];
  {
    const uint32_t qa = ring + 2 * TILE_BYTES +
                        ((warp * 16 + (lane & 15)) * LD + (lane >> 4) * 8) * 2;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) ldmatrix_x4(qf[kk], qa + kk * 32);
  }

  float o[HD / 8][4];
#pragma unroll
  for (int d = 0; d < HD / 8; ++d) {
    o[d][0] = o[d][1] = o[d][2] = o[d][3] = 0.f;
  }
  float m[2] = {NEG_INF, NEG_INF};
  float l[2] = {0.f, 0.f};  // this thread's share of the row sums
  const int row[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};

  // ldmatrix row addresses within a tile. K (non-transposed): lane l reads
  // key l % 8 at column (l / 8) * 8, so one x4 gives b0, b1 of two k16
  // steps of an 8-key n tile. V (transposed): lane l reads key l % 16 at
  // column (l / 16) * 8, so one x4 gives b0, b1 of two 8-column d tiles.
  const uint32_t k_lane = ((lane & 7) * LD + (lane >> 3) * 8) * 2;
  const uint32_t v_lane = TILE_BYTES + ((lane & 15) * LD + (lane >> 4) * 8) * 2;

  for (int kb = 0; kb < n_kv_eff; ++kb) {
    const int k0 = kb * BK;
    const uint32_t stage = ring + (kb & 1) * 2 * TILE_BYTES;
    // Bit j: key k0 + j exists and is valid.
    const uint64_t kmask =
        (uint64_t)__ballot_sync(0xffffffff, flag_lo != 0) |
        ((uint64_t)__ballot_sync(0xffffffff, flag_hi != 0) << 32);

    cp_async_wait<0>();
    // Tile kb is visible to every warp, and every warp is done with the
    // other stage (tile kb - 1, or Q before the loop).
    __syncthreads();
    if (kb + 1 < n_kv_eff) {
      const uint32_t next = ring + ((kb + 1) & 1) * 2 * TILE_BYTES;
      load_tile_async(next, k + head_base, k0 + BK, S, row_stride);
      load_tile_async(next + TILE_BYTES, v + head_base, k0 + BK, S, row_stride);
      flag_lo = key_flag(valid_b, k0 + BK + lane, S);
      flag_hi = key_flag(valid_b, k0 + BK + 32 + lane, S);
    }
    cp_async_commit();

    // Scores: 16 rows x 64 keys per warp, 8 n-tiles of 8 keys.
    float s[BK / 8][4];
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
      for (int kp = 0; kp < HD / 32; ++kp) {
        uint32_t kf[4];
        ldmatrix_x4(kf, stage + k_lane + (n * 8 * LD + kp * 32) * 2);
        mma_bf16(s[n], qf[2 * kp], kf[0], kf[1]);
        mma_bf16(s[n], qf[2 * kp + 1], kf[2], kf[3]);
      }
    }

    // Scale, mask, and this tile's row maxima. A tile whose every key is
    // valid and at or before the warp's first row keeps every score: the
    // same values without the per-element test.
    float mx[2] = {NEG_INF, NEG_INF};
    if (kmask == ~0ull && (!causal || k0 + BK - 1 <= q0 + warp * 16)) {
#pragma unroll
      for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[n][e] *= scale;
          mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
        }
      }
    } else {
      const uint64_t kbits = kmask >> (t4 * 2);  // bit n * 8 + c: key n * 8 + t4 * 2 + c
#pragma unroll
      for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key_local = n * 8 + t4 * 2 + (e & 1);
          const int r = e >> 1;
          const bool keep = ((kbits >> (n * 8 + (e & 1))) & 1) != 0 &&
                            (!causal || k0 + key_local <= row[r]);
          const float val = keep ? s[n][e] * scale : NEG_INF;
          s[n][e] = val;
          mx[r] = fmaxf(mx[r], val);
        }
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
#pragma unroll
      for (int dp = 0; dp < HD / 16; ++dp) {
        uint32_t vf[4];
        ldmatrix_x4_trans(vf, stage + v_lane + (j * 16 * LD + dp * 16) * 2);
        mma_bf16(o[2 * dp], pa, vf[0], vf[1]);
        mma_bf16(o[2 * dp + 1], pa, vf[2], vf[3]);
      }
    }
  }

  // Full row sums across the 4 threads that share a row.
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffff, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffff, l[r], 2);
  }

  // The warp's 16 output rows go through the stage that the last tile left
  // free (no copy is in flight into it, and every warp is done reading it),
  // then out with 16-byte stores, a 256-byte row per half warp.
  __nv_bfloat16* ow = reinterpret_cast<__nv_bfloat16*>(smem + (n_kv_eff & 1) * 2 * TILE_BYTES) +
                      warp * 16 * LD;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const bool live = row[r] < S && valid_b[row[r]] != 0;
    const float inv = 1.f / fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int d = 0; d < HD / 8; ++d) {
      const float x0 = live ? o[d][2 * r] * inv : 0.f;
      const float x1 = live ? o[d][2 * r + 1] * inv : 0.f;
      *reinterpret_cast<uint32_t*>(ow + (g + 8 * r) * LD + d * 8 + t4 * 2) = pack_bf16(x0, x1);
    }
  }
  __syncwarp();
#pragma unroll
  for (int i = 0; i < 16 * (HD / 8) / 32; ++i) {
    const int c = i * 32 + lane;
    const int rr = c / (HD / 8);
    const int col = (c % (HD / 8)) * 8;
    const int orow = q0 + warp * 16 + rr;
    if (orow < S) {
      *reinterpret_cast<uint4*>(out + head_base + (long)orow * row_stride + col) =
          *reinterpret_cast<const uint4*>(ow + rr * LD + col);
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
  flash_fwd_kernel<<<grid, THREADS, SMEM_BYTES, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, (const uint8_t*)valid, (__nv_bfloat16*)out, S,
      H, causal, scale);
  return (int)cudaGetLastError();
}

// The kernel's registers per thread, dynamic shared memory per block and
// resident blocks per SM on the current device; returns a cudaError_t.
extern "C" int egpt_flash_attention_occupancy(int* regs, int* smem_bytes,
                                              int* blocks_per_sm) {
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, flash_fwd_kernel);
  if (err != cudaSuccess) return (int)err;
  *regs = attr.numRegs;
  *smem_bytes = SMEM_BYTES;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, flash_fwd_kernel,
                                                            THREADS, SMEM_BYTES);
}

extern "C" const char* egpt_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
