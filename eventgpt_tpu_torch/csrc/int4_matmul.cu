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
//   * prefill, M = 3396: operations. 4096 -> 4096 is 114 GFLOP -> 0.115 ms,
//     4096 -> 11008 and 11008 -> 4096 are 306 GFLOP -> 0.310 ms each; one
//     7B prefill forward (128 + 64 + 32 launches) is 44.0 TFLOP -> 44.5 ms.
//
// Shared by both paths. The product runs on the tensor cores through
// mma.sync m16n8k16 (bf16 in, f32 accumulate). Nibbles become bf16 in
// registers: OR-ing a nibble into the mantissa of bf16 128.0 gives 128 + n
// exactly, and one bf16x2 subtraction of 136 centres both nibbles of a
// byte at once. A byte's two nibbles are rows 2r and 2r+1, which is
// exactly the k-pair that one register of the mma's B fragment holds, so
// the packed layout needs no shuffle. The 32 output columns of a warp are
// permuted (fragment column c of n-tile j is column 4c + j), so that one
// 32-bit load gives a thread its four B bytes and two float4 loads its
// eight group scales. Each warp keeps an f32 per-group partial beside its
// f32 accumulator and folds the partial in with the scale at the end of
// every group, k16 steps and groups in ascending order: the Pallas
// kernel's order, and the same sums in both paths.
//   * Decode (M <= 16, int4_mm_decode_kernel): one 16-row tile with 8
//     warps that split the groups of K between them and add their
//     accumulators through shared memory, so that 32 columns of a
//     4096-wide weight still give 128 blocks and each block keeps 8 warps
//     of loads in flight. Operands come straight from device memory.
//   * Prefill (M > 16, int4_mm_prefill_kernel): a 128 x 128 block tile of
//     8 warps, 2 in M x 4 in N, each warp 64 x 32 (four 16-row m-tiles
//     that share one B fragment). A 4-stage ring in dynamic shared memory
//     holds, per 64 contraction rows, the x tile (128 x 64 bf16, rows
//     padded to 144 B), the packed W tile (32 x 128 bytes, rows padded to
//     160 B) and the scale row of each k16 step that ends a group, filled
//     by 16-byte cp.async copies (zero-filled past M, K and N) three tiles
//     ahead of the tile being multiplied. A fragments come from shared
//     memory through ldmatrix.x4, B bytes through one 32-bit shared load
//     per k-pair row; both paddings keep a warp's 32 lanes on distinct
//     banks. Fragments are double-buffered over the k16 steps of a tile,
//     and the four bytes of a word are unpacked together (unpack_word).
//     x is read once per 128 output columns and W once per 128 rows. The
//     accumulator and the partial take 128 registers a thread, so an SM
//     holds one block, 8 warps, and each group's fold waits for the mma
//     pipe to drain: mma.sync at that occupancy, not the ring, sets the
//     pace.
// What remains: wgmma with TMA feeding the ring (a warpgroup's products
// are asynchronous, so a fold can overlap the next group's), and a
// persistent grid whose epilogue overlaps the next tile's loads.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

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

// ---- Decode (M <= 16): one 16-row tile, K split over 8 warps -------------

constexpr int DEC_BM = 16;     // rows of the one m-tile
constexpr int DEC_WARPS = 8;   // warps that split the groups of K
constexpr int DEC_UNROLL = 8;  // k16 steps in flight per warp

__global__ void __launch_bounds__(DEC_WARPS * 32)
int4_mm_decode_kernel(const __nv_bfloat16* __restrict__ x,
                      const uint8_t* __restrict__ q4,
                      const float* __restrict__ s,
                      float* __restrict__ out,
                      int M, int K, int N, int group) {
  constexpr int RED_LD = WARP_N + 1;  // padded against bank conflicts
  __shared__ float red[DEC_WARPS * DEC_BM * RED_LD];

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;   // row of the fragment / B column
  const int t4 = lane % 4;  // column pair of the fragment / B k pair
  const int n0 = blockIdx.x * WARP_N;
  const int m0 = blockIdx.y * DEC_BM;

  const int n_groups = K / group;
  const int ksteps = group / 16;

  // This thread's A rows: g and g + 8; rows past M read 0.
  const __nv_bfloat16* xrow[2];
  bool live[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = m0 + g + 8 * h;
    live[h] = r < M;
    xrow[h] = x + (long)(r < M ? r : 0) * K;
  }

  float acc[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  const uint8_t* qcol = q4 + n0 + 4 * g;
  for (int gi = warp; gi < n_groups; gi += DEC_WARPS) {
    float part[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) part[j][e] = 0.f;

#pragma unroll DEC_UNROLL
    for (int ks = 0; ks < ksteps; ++ks) {
      const int k0 = gi * group + ks * 16;  // logical contraction row
      const int r0 = k0 / 2;                // packed row
      const uint32_t w0 = __ldg(reinterpret_cast<const unsigned int*>(
          qcol + (long)(r0 + t4) * N));
      const uint32_t w1 = __ldg(reinterpret_cast<const unsigned int*>(
          qcol + (long)(r0 + 4 + t4) * N));
      uint32_t a[4];
      a[0] = live[0] ? ld32(xrow[0] + k0 + 2 * t4) : 0u;
      a[1] = live[1] ? ld32(xrow[1] + k0 + 2 * t4) : 0u;
      a[2] = live[0] ? ld32(xrow[0] + k0 + 8 + 2 * t4) : 0u;
      a[3] = live[1] ? ld32(xrow[1] + k0 + 8 + 2 * t4) : 0u;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint32_t b0 = unpack_byte((w0 >> (8 * j)) & 0xFFu);
        const uint32_t b1 = unpack_byte((w1 >> (8 * j)) & 0xFFu);
        mma_bf16(part[j], a, b0, b1);
      }
    }

    // acc += partial * s[gi, col]. Accumulator element e of n-tile j sits
    // at fragment column 2*t4 + (e & 1), i.e. column n0 + 8*t4 + 4*(e&1) + j.
    const float4 s0 = __ldg(reinterpret_cast<const float4*>(s + (long)gi * N + n0 + 8 * t4));
    const float4 s1 = __ldg(reinterpret_cast<const float4*>(s + (long)gi * N + n0 + 8 * t4 + 4));
    const float se[4] = {s0.x, s0.y, s0.z, s0.w};
    const float so[4] = {s1.x, s1.y, s1.z, s1.w};
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] += part[j][e] * ((e & 1) ? so[j] : se[j]);
  }

  // Add the warps' accumulators.
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = g + ((e & 2) ? 8 : 0);
      const int col = 8 * t4 + 4 * (e & 1) + j;
      red[(warp * DEC_BM + row) * RED_LD + col] = acc[j][e];
    }
  __syncthreads();
  for (int i = threadIdx.x; i < DEC_BM * WARP_N; i += DEC_WARPS * 32) {
    const int row = i / WARP_N;
    const int col = i % WARP_N;
    if (m0 + row >= M) continue;
    float v = 0.f;
#pragma unroll
    for (int w = 0; w < DEC_WARPS; ++w) v += red[(w * DEC_BM + row) * RED_LD + col];
    out[(long)(m0 + row) * N + n0 + col] = v;
  }
}

// ---- Prefill (M > 16): a cp.async ring in shared memory -------------------

constexpr int PF_BM = 128;                 // block rows: 2 warps of 64
constexpr int PF_BN = 128;                 // block columns: 4 warps of 32
constexpr int PF_BK = 64;                  // contraction rows per stage
constexpr int PF_STEPS = PF_BK / 16;       // k16 steps per stage
constexpr int PF_STAGES = 4;
constexpr int PF_THREADS = 256;
constexpr int PF_XLD = PF_BK + 8;          // x row pitch, bf16 (144 B)
constexpr int PF_WLD = PF_BN + 32;         // W row pitch, bytes (160 B)
constexpr int PF_X_BYTES = PF_BM * PF_XLD * 2;
constexpr int PF_W_BYTES = PF_BK / 2 * PF_WLD;
constexpr int PF_S_BYTES = PF_STEPS * PF_BN * 4;
constexpr int PF_STAGE_BYTES = PF_X_BYTES + PF_W_BYTES + PF_S_BYTES;
constexpr int PF_SMEM_BYTES = PF_STAGES * PF_STAGE_BYTES;
static_assert(PF_BK / 2 * PF_BN / 16 % PF_THREADS == 0, "whole W chunks per thread");
static_assert(PF_STEPS * PF_BN / 4 <= PF_THREADS, "one scale chunk per thread");
static_assert(PF_X_BYTES % 16 == 0 && PF_W_BYTES % 16 == 0 && PF_STAGE_BYTES % 16 == 0,
              "16-byte aligned sections");

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

__device__ __forceinline__ void ldmatrix_x4(uint32_t a[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(addr));
}

// The four bytes of one packed word -> bf16x2 {hi - 8, lo - 8} of byte j
// in b[j], the values unpack_byte gives: the nibbles of bytes 0 and 2 (and
// of 1 and 3) become bf16 128 + n two at a time, and one byte_perm pairs
// each byte's high and low nibble.
__device__ __forceinline__ void unpack_word(uint32_t w, uint32_t b[4]) {
  const uint32_t h02 = ((w >> 4) & 0x000F000Fu) | 0x43004300u;
  const uint32_t l02 = (w & 0x000F000Fu) | 0x43004300u;
  const uint32_t h13 = ((w >> 12) & 0x000F000Fu) | 0x43004300u;
  const uint32_t l13 = ((w >> 8) & 0x000F000Fu) | 0x43004300u;
  const uint32_t pairs[4] = {__byte_perm(h02, l02, 0x5410), __byte_perm(h13, l13, 0x5410),
                             __byte_perm(h02, l02, 0x7632), __byte_perm(h13, l13, 0x7632)};
  const __nv_bfloat162 off = __floats2bfloat162_rn(136.f, 136.f);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const __nv_bfloat162 v = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&pairs[j]), off);
    b[j] = *reinterpret_cast<const uint32_t*>(&v);
  }
}

// Where the k16 step that one thread stages scales for ends: its end row
// e = 64 kt + 16 step + 16 as e / group and e % group, advanced one tile
// at a time so that the loop divides by nothing.
struct GroupCursor {
  int row;
  int rem;
};

// Issue the copies of tile kt into one stage of the ring: x rows
// [m0, m0 + 128) x contraction rows [64 kt, 64 kt + 64), packed W rows
// [32 kt, 32 kt + 32) x columns [nb, nb + 128), and the scale row of each
// k16 step of the tile that ends a group (slot = step). Tiles are issued
// in order, each once, and `cur` moves on by one tile.
__device__ __forceinline__ void pf_load_stage(uint8_t* stage, const __nv_bfloat16* x,
                                              const uint8_t* q4, const float* s, int M, int K,
                                              int N, int group, int m0, int nb, int kt,
                                              GroupCursor& cur, int tile_rows, int tile_rem) {
  const int tid = threadIdx.x;
  const int k_base = kt * PF_BK;
  const uint32_t xs = smem_u32(stage);
#pragma unroll
  for (int i = 0; i < PF_BM * PF_BK / 8 / PF_THREADS; ++i) {
    const int c = tid + i * PF_THREADS;
    const int row = c / (PF_BK / 8);
    const int col = c % (PF_BK / 8) * 8;
    const bool ok = m0 + row < M && k_base + col < K;
    const __nv_bfloat16* src = ok ? x + (long)(m0 + row) * K + k_base + col : x;
    cp_async16(xs + (row * PF_XLD + col) * 2, src, ok);
  }
#pragma unroll
  for (int i = 0; i < PF_BK / 2 * PF_BN / 16 / PF_THREADS; ++i) {
    const int c = tid + i * PF_THREADS;
    const int row = c / (PF_BN / 16);
    const int col = c % (PF_BN / 16) * 16;
    const int pr = kt * (PF_BK / 2) + row;
    const bool ok = pr < K / 2 && nb + col < N;
    const uint8_t* src = ok ? q4 + (long)pr * N + nb + col : q4;
    cp_async16(xs + PF_X_BYTES + row * PF_WLD + col, src, ok);
  }
  if (tid < PF_STEPS * PF_BN / 4) {
    const int step = tid / (PF_BN / 4);
    const int col = tid % (PF_BN / 4) * 4;
    if (k_base + step * 16 < K && cur.rem == 0) {
      const bool ok = nb + col < N;
      const float* src = ok ? s + (long)(cur.row - 1) * N + nb + col : s;
      cp_async16(xs + PF_X_BYTES + PF_W_BYTES + (step * PF_BN + col) * 4, src, ok);
    }
    cur.row += tile_rows;
    cur.rem += tile_rem;
    if (cur.rem >= group) {
      cur.rem -= group;
      ++cur.row;
    }
  }
}

// One k16 step's fragments from a stage: the warp's four A m-tiles
// through ldmatrix.x4, and its two packed B words.
__device__ __forceinline__ void pf_load_frags(uint32_t (&a)[4][4], uint32_t (&w)[2], uint32_t xs,
                                              const uint8_t* ws, int a_row, int a_col, int t4,
                                              int ks) {
#pragma unroll
  for (int mt = 0; mt < 4; ++mt) {
    ldmatrix_x4(a[mt], xs + ((a_row + mt * 16) * PF_XLD + ks * 16 + a_col) * 2);
  }
  w[0] = *reinterpret_cast<const uint32_t*>(ws + (ks * 8 + t4) * PF_WLD);
  w[1] = *reinterpret_cast<const uint32_t*>(ws + (ks * 8 + 4 + t4) * PF_WLD);
}

__global__ void __launch_bounds__(PF_THREADS, 1)
int4_mm_prefill_kernel(const __nv_bfloat16* __restrict__ x,
                       const uint8_t* __restrict__ q4,
                       const float* __restrict__ s,
                       float* __restrict__ out,
                       int M, int K, int N, int group) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int warp_m = warp / (PF_BN / WARP_N);
  const int warp_n = warp % (PF_BN / WARP_N);
  const int g = lane / 4;   // row of the fragment / B column
  const int t4 = lane % 4;  // column pair of the fragment / B k pair
  const int m0 = blockIdx.y * PF_BM;
  const int nb = blockIdx.x * PF_BN;
  // A warp past N (ragged last block) multiplies zeros and stores nothing,
  // but reaches every barrier.
  const int n0 = nb + warp_n * WARP_N;
  const int n_tiles = (K + PF_BK - 1) / PF_BK;
  const int group_steps = group / 16;
  const int tile_rows = PF_BK / group;
  const int tile_rem = PF_BK % group;
  const int first_end = threadIdx.x / (PF_BN / 4) * 16 + 16;  // the scale stager's step
  GroupCursor cur = {first_end / group, first_end % group};

  float acc[4][4][4];
  float part[4][4][4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][j][e] = part[mt][j][e] = 0.f;

#pragma unroll
  for (int st = 0; st < PF_STAGES - 1; ++st) {
    if (st < n_tiles) {
      pf_load_stage(smem + st * PF_STAGE_BYTES, x, q4, s, M, K, N, group, m0, nb, st, cur,
                    tile_rows, tile_rem);
    }
    cp_async_commit();
  }

  // ldmatrix.x4 row addresses: lanes 0-15 rows 0-15 at column 0 (a0, a1),
  // lanes 16-31 the same rows at column 8 (a2, a3).
  const int a_row = warp_m * 64 + lane % 16;
  const int a_col = lane / 16 * 8;
  int fold_in = group_steps;  // k16 steps left in the current group

  for (int kt = 0; kt < n_tiles; ++kt) {
    cp_async_wait<PF_STAGES - 2>();
    __syncthreads();  // tile kt has landed; every warp is done with tile kt - 1
    const int next = kt + PF_STAGES - 1;
    if (next < n_tiles) {
      pf_load_stage(smem + next % PF_STAGES * PF_STAGE_BYTES, x, q4, s, M, K, N, group, m0, nb,
                    next, cur, tile_rows, tile_rem);
    }
    cp_async_commit();

    const uint8_t* stage = smem + kt % PF_STAGES * PF_STAGE_BYTES;
    const uint32_t xs = smem_u32(stage);
    const uint8_t* ws = stage + PF_X_BYTES + warp_n * WARP_N + 4 * g;
    const float* ss = reinterpret_cast<const float*>(stage + PF_X_BYTES + PF_W_BYTES) +
                      warp_n * WARP_N + 8 * t4;
    const int steps = min(PF_STEPS, (K - kt * PF_BK) / 16);
    // Fragments are double-buffered: step ks + 1's loads are in flight
    // while step ks multiplies, and its B bytes are unpacked after that.
    uint32_t a[2][4][4];
    uint32_t w[2];
    uint32_t b[2][2][4];
    pf_load_frags(a[0], w, xs, ws, a_row, a_col, t4, 0);
    unpack_word(w[0], b[0][0]);
    unpack_word(w[1], b[0][1]);
#pragma unroll
    for (int ks = 0; ks < PF_STEPS; ++ks) {
      if (ks >= steps) break;
      if (ks + 1 < steps) pf_load_frags(a[(ks + 1) & 1], w, xs, ws, a_row, a_col, t4, ks + 1);
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int mt = 0; mt < 4; ++mt) {
          mma_bf16(part[mt][j], a[ks & 1][mt], b[ks & 1][0][j], b[ks & 1][1][j]);
        }
      if (--fold_in == 0) {
        // The group ends: acc += partial * s[group, col], as in the decode
        // path; column n0 + 8*t4 + 4*(e&1) + j of element e of n-tile j.
        fold_in = group_steps;
        const float4 s0 = *reinterpret_cast<const float4*>(ss + ks * PF_BN);
        const float4 s1 = *reinterpret_cast<const float4*>(ss + ks * PF_BN + 4);
        const float se[4] = {s0.x, s0.y, s0.z, s0.w};
        const float so[4] = {s1.x, s1.y, s1.z, s1.w};
#pragma unroll
        for (int mt = 0; mt < 4; ++mt)
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              acc[mt][j][e] += part[mt][j][e] * ((e & 1) ? so[j] : se[j]);
              part[mt][j][e] = 0.f;
            }
      }
      if (ks + 1 < steps) {
        unpack_word(w[0], b[(ks + 1) & 1][0]);
        unpack_word(w[1], b[(ks + 1) & 1][1]);
      }
    }
  }
  cp_async_wait<0>();

  if (n0 >= N) return;
  // Each thread holds 8 consecutive columns n0 + 8*t4 .. +7 of its rows.
#pragma unroll
  for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = m0 + warp_m * 64 + mt * 16 + g + 8 * h;
      if (r >= M) continue;
      float* o = out + (long)r * N + n0 + 8 * t4;
      *reinterpret_cast<float4*>(o) = make_float4(
          acc[mt][0][2 * h], acc[mt][1][2 * h], acc[mt][2][2 * h], acc[mt][3][2 * h]);
      *reinterpret_cast<float4*>(o + 4) = make_float4(
          acc[mt][0][2 * h + 1], acc[mt][1][2 * h + 1], acc[mt][2][2 * h + 1],
          acc[mt][3][2 * h + 1]);
    }
  }
}

// The ring is above the 48 KB of dynamic shared memory a launch gets by
// default. The limit is raised once per device, before that device's
// first prefill launch; an error is returned and the next launch tries
// again.
constexpr int MAX_DEVICES = 64;
std::atomic<bool> pf_smem_set[MAX_DEVICES];

cudaError_t prefill_smem_ready() {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < MAX_DEVICES && pf_smem_set[dev].load(std::memory_order_acquire)) return cudaSuccess;
  err = cudaFuncSetAttribute(int4_mm_prefill_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, PF_SMEM_BYTES);
  if (err == cudaSuccess && dev < MAX_DEVICES) {
    pf_smem_set[dev].store(true, std::memory_order_release);
  }
  return err;
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
  if (M <= DEC_BM) {
    dim3 grid(N / WARP_N, 1);
    int4_mm_decode_kernel<<<grid, DEC_WARPS * 32, 0, st>>>(xp, qp, sp, op, M, K, N, group);
  } else {
    const cudaError_t err = prefill_smem_ready();
    if (err != cudaSuccess) return (int)err;
    dim3 grid((N + PF_BN - 1) / PF_BN, (M + PF_BM - 1) / PF_BM);
    int4_mm_prefill_kernel<<<grid, PF_THREADS, PF_SMEM_BYTES, st>>>(xp, qp, sp, op, M, K, N,
                                                                     group);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* egpt_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
