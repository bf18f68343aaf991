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
// kernel's order. Operands reach shared memory through a ring of 16-byte
// cp.async copies (zero-filled past N); every warp reaches every barrier.
//   * Decode (M <= 16, int4_mm_decode_kernel): bytes bound it, and a 7B
//     weight has too few columns to fill the card (4096 columns are 32
//     tiles of 128), so K is split too. The grid is (column tiles of 128,
//     8 splits), and the 8 splits of a column tile are one thread block
//     cluster. Split s takes groups s, s + 8, s + 16, ... and folds them
//     in ascending order; then each block stores 16 columns of its
//     partial into the shared memory of the block that combines them,
//     one cluster barrier, and each block sums its 16 columns of the 8
//     partials in split order from 0 and writes them out. One launch, no
//     atomics, two calls give equal bits, and the sums are those of one
//     block whose 8 warps take the groups in turn. A block of 4 warps
//     (32 columns each) stages up to 8 k16 steps of one group at a time:
//     their 64 packed rows of its 128 columns (a warp's copy covers 128
//     contiguous bytes of each of 4 rows), the x values of the rows < M,
//     and, in the group's last stage, its scale row; 2 stages, one in
//     flight while the other is multiplied; A fragments through
//     ldmatrix.x4. At 4096 x 4096 that is 256 blocks, ~2 an SM. A whole
//     7B decode step (225 launches) took 4.39 ms on an H100 80GB HBM3 at
//     700 W with the L2 flushed before each launch (chip_smoke.py), 24%
//     of its byte bound: each block's main loop runs at a fraction of the
//     bandwidth a bare copy of the same tiles reaches, and the cluster
//     barrier waits for the slowest of the 8 splits.
//   * Prefill (M > 16, int4_mm_prefill_kernel): a 128 x 128 block tile of
//     8 warps, 2 in M x 4 in N, each warp 64 x 32 (four 16-row m-tiles
//     that share one B fragment). A 4-stage ring in dynamic shared memory
//     holds, per 64 contraction rows, the x tile (128 x 64 bf16, rows
//     padded to 144 B), the packed W tile (32 x 128 bytes, rows padded to
//     160 B) and the scale row of each k16 step that ends a group, filled
//     three tiles ahead of the tile being multiplied. A fragments come
//     from shared memory through ldmatrix.x4, B bytes through one 32-bit
//     shared load per k-pair row; both paddings keep a warp's 32 lanes on
//     distinct banks. Fragments are double-buffered over the k16 steps of
//     a tile, and the four bytes of a word are unpacked together
//     (unpack_word). x is read once per 128 output columns and W once per
//     128 rows. The accumulator and the partial take 128 registers a
//     thread, so an SM holds one block, 8 warps, and each group's fold
//     waits for the mma pipe to drain: mma.sync at that occupancy, not the
//     ring, sets the pace.
// What remains: wgmma with TMA feeding the prefill ring (a warpgroup's
// products are asynchronous, so a fold can overlap the next group's), and
// a persistent grid whose epilogue overlaps the next tile's loads.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace cg = cooperative_groups;

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

// The four bytes of one packed word -> bf16x2 {hi - 8, lo - 8} of byte j
// in b[j]; the low half (the mma's lower k index) is the high nibble, row
// 2r. The nibbles of bytes 0 and 2 (and of 1 and 3) become bf16 128 + n
// two at a time, and one byte_perm pairs each byte's high and low nibble.
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

// ---- Decode (M <= 16): K split over a cluster of 8 blocks ----------------

constexpr int DEC_BM = 16;                      // rows of the one m-tile
constexpr int DEC_SPLITS = 8;                   // blocks of a cluster, one split each
constexpr int DEC_BN = 128;                     // block columns: 4 warps of 32
constexpr int DEC_THREADS = DEC_BN / WARP_N * 32;
constexpr int DEC_STEPS = 8;                    // k16 steps per stage, all of one group
constexpr int DEC_STAGES = 2;
constexpr int DEC_STEP_LANES = DEC_THREADS / DEC_STEPS;  // threads that stage one step
constexpr int DEC_WLD = DEC_BN + 32;            // W row pitch, bytes (160)
constexpr int DEC_XLD = DEC_STEPS * 16 * 2 + 16;  // x row pitch, bytes (272)
constexpr int DEC_W_BYTES = DEC_STEPS * 8 * DEC_WLD;
constexpr int DEC_X_BYTES = DEC_BM * DEC_XLD;
constexpr int DEC_S_BYTES = DEC_BN * 4;
constexpr int DEC_STAGE_BYTES = DEC_W_BYTES + DEC_X_BYTES + DEC_S_BYTES;
constexpr int DEC_SMEM_BYTES = DEC_STAGES * DEC_STAGE_BYTES;
constexpr int DEC_SLICE = DEC_BN / DEC_SPLITS;  // columns each block combines
// 16-byte chunks each staging thread copies for its step: W rows, x rows.
constexpr int DEC_W_CHUNKS = 8 * DEC_BN / 16 / DEC_STEP_LANES;
constexpr int DEC_X_CHUNKS = DEC_BM * 2 / DEC_STEP_LANES;
static_assert(DEC_W_CHUNKS * DEC_STEP_LANES == 8 * DEC_BN / 16 &&
              DEC_X_CHUNKS * DEC_STEP_LANES == DEC_BM * 2 && DEC_X_CHUNKS > 0,
              "whole chunks a thread");
static_assert(DEC_BN / 4 <= DEC_THREADS, "one scale chunk a thread");
static_assert(DEC_STEPS % 4 == 0, "x rows of one ldmatrix fall on distinct banks");
static_assert(DEC_SLICE % 4 == 0 && WARP_N % DEC_SLICE == 0, "whole float4s to one block");
static_assert(DEC_W_BYTES % 16 == 0 && DEC_X_BYTES % 16 == 0 && DEC_STAGE_BYTES % 16 == 0,
              "16-byte aligned sections");
static_assert(DEC_SMEM_BYTES + DEC_SPLITS * DEC_BM * DEC_SLICE * 4 <= 48 * 1024,
              "static shared memory");

// A split's k16 steps run over its groups in order, in stages of at most
// DEC_STEPS steps of one group: stage c of the split's q-th group (group
// split + 8 q) holds steps [8 c, min(8 c + 8, group / 16)). Moved on one
// stage at a time, so that the loop divides by nothing.
struct StageCursor {
  int q;
  int c;
};

__device__ __forceinline__ void next_stage(StageCursor& cur, int stages_per_group) {
  if (++cur.c == stages_per_group) {
    cur.c = 0;
    ++cur.q;
  }
}

// Start the copies of the stage at `cur` into one stage of the ring: thread
// tid stages step tid / DEC_STEP_LANES, its 8 packed rows of the block's
// 128 columns (16 lanes cover 128 contiguous bytes of a row, zero-filled
// past N) and the 16 x values of each row < M; in the group's last stage
// the first DEC_BN / 4 threads also stage the group's scale row.
__device__ __forceinline__ void dec_load_stage(uint8_t* stage, const __nv_bfloat16* x,
                                               const uint8_t* q4, const float* s, int M, int K,
                                               int N, int group, int split, int nb,
                                               const StageCursor& cur, int stages_per_group) {
  const int st = threadIdx.x / DEC_STEP_LANES;
  const int l = threadIdx.x % DEC_STEP_LANES;
  const int steps_per_group = group / 16;
  const long gi = split + (long)DEC_SPLITS * cur.q;
  const int ks = cur.c * DEC_STEPS + st;  // this thread's step in the group
  const uint32_t base = smem_u32(stage);
  if (ks < steps_per_group) {
    const long pr = gi * (group / 2) + ks * 8;  // the step's first packed row
#pragma unroll
    for (int i = 0; i < DEC_W_CHUNKS; ++i) {
      const int c = l + i * DEC_STEP_LANES;
      const int rr = c / (DEC_BN / 16);
      const int col = c % (DEC_BN / 16) * 16;
      const bool ok = nb + col < N;
      const uint8_t* src = ok ? q4 + (pr + rr) * N + nb + col : q4;
      cp_async16(base + (st * 8 + rr) * DEC_WLD + col, src, ok);
    }
    const long k0 = gi * group + ks * 16;
#pragma unroll
    for (int i = 0; i < DEC_X_CHUNKS; ++i) {
      const int c = l + i * DEC_STEP_LANES;
      const int row = c / 2;
      const int half = c % 2;
      if (row < M) {
        cp_async16(base + DEC_W_BYTES + row * DEC_XLD + (st * 16 + half * 8) * 2,
                   x + (long)row * K + k0 + half * 8, true);
      }
    }
  }
  if (cur.c == stages_per_group - 1 && threadIdx.x < DEC_BN / 4) {
    const int col = threadIdx.x * 4;
    const bool ok = nb + col < N;
    const float* src = ok ? s + gi * N + nb + col : s;
    cp_async16(base + DEC_W_BYTES + DEC_X_BYTES + col * 4, src, ok);
  }
}

__global__ void __cluster_dims__(1, DEC_SPLITS, 1) __launch_bounds__(DEC_THREADS)
int4_mm_decode_kernel(const __nv_bfloat16* __restrict__ x,
                      const uint8_t* __restrict__ q4,
                      const float* __restrict__ s,
                      float* __restrict__ out,
                      int M, int K, int N, int group) {
  __shared__ __align__(16) uint8_t smem[DEC_SMEM_BYTES];  // the ring
  // inbox[r]: split r's partial of the columns this block combines.
  __shared__ __align__(16) float inbox[DEC_SPLITS][DEC_BM][DEC_SLICE];
  cg::cluster_group cluster = cg::this_cluster();
  // Every block of the cluster has started once this barrier completes; it
  // is waited for only before the first store to a peer's inbox.
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;   // row of the fragment / B column
  const int t4 = lane % 4;  // column pair of the fragment / B k pair
  const int nb = blockIdx.x * DEC_BN;
  // The cluster spans the split axis, so a block's rank in its cluster is
  // its split.
  const int split = static_cast<int>(cluster.block_rank());
  const int n_groups = K / group;
  const int steps_per_group = group / 16;
  const int stages_per_group = (steps_per_group + DEC_STEPS - 1) / DEC_STEPS;
  const int my_groups = split < n_groups ? (n_groups - split + DEC_SPLITS - 1) / DEC_SPLITS : 0;
  const int n_tiles = my_groups * stages_per_group;

  float acc[4][4];
  float part[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = part[j][e] = 0.f;

  StageCursor load = {0, 0};  // the next stage to copy
#pragma unroll
  for (int t = 0; t < DEC_STAGES - 1; ++t) {
    if (t < n_tiles) {
      dec_load_stage(smem + t * DEC_STAGE_BYTES, x, q4, s, M, K, N, group, split, nb, load,
                     stages_per_group);
      next_stage(load, stages_per_group);
    }
    cp_async_commit();
  }

  // x rows M..15 of every stage stay zero (the copies write rows < M
  // only): ldmatrix reads all 16 rows. Stored while the first copies fly.
  const int zero_chunks = (DEC_BM - M) * DEC_XLD / 16;
  for (int i = threadIdx.x; i < DEC_STAGES * zero_chunks; i += DEC_THREADS) {
    *reinterpret_cast<uint4*>(smem + i / zero_chunks * DEC_STAGE_BYTES + DEC_W_BYTES +
                              M * DEC_XLD + i % zero_chunks * 16) = make_uint4(0u, 0u, 0u, 0u);
  }

  // ldmatrix.x4 row addresses: lanes 0-15 rows 0-15 at k 0 (a0, a1),
  // lanes 16-31 the same rows at k 8 (a2, a3).
  const int a_off = DEC_W_BYTES + lane % 16 * DEC_XLD + lane / 16 * 16;
  StageCursor use = {0, 0};  // the stage being multiplied

  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<DEC_STAGES - 2>();
    __syncthreads();  // stage t has landed; every warp is done with stage t - 1
    if (t + DEC_STAGES - 1 < n_tiles) {
      dec_load_stage(smem + (t + DEC_STAGES - 1) % DEC_STAGES * DEC_STAGE_BYTES, x, q4, s, M, K,
                     N, group, split, nb, load, stages_per_group);
      next_stage(load, stages_per_group);
    }
    cp_async_commit();

    const uint8_t* stage = smem + t % DEC_STAGES * DEC_STAGE_BYTES;
    const uint8_t* ws = stage + warp * WARP_N + 4 * g;
    const uint32_t xs = smem_u32(stage) + a_off;
    const int steps = min(DEC_STEPS, steps_per_group - use.c * DEC_STEPS);
#pragma unroll
    for (int st = 0; st < DEC_STEPS; ++st) {
      if (st >= steps) break;
      const uint32_t w0 = *reinterpret_cast<const uint32_t*>(ws + (st * 8 + t4) * DEC_WLD);
      const uint32_t w1 = *reinterpret_cast<const uint32_t*>(ws + (st * 8 + 4 + t4) * DEC_WLD);
      uint32_t a[4];
      ldmatrix_x4(a, xs + st * 32);
      uint32_t b0[4], b1[4];
      unpack_word(w0, b0);
      unpack_word(w1, b1);
#pragma unroll
      for (int j = 0; j < 4; ++j) mma_bf16(part[j], a, b0[j], b1[j]);
    }
    if (use.c == stages_per_group - 1) {
      // The group ends: acc += partial * s[group, col]. Accumulator
      // element e of n-tile j sits at fragment column 2*t4 + (e & 1),
      // i.e. column nb + 32*warp + 8*t4 + 4*(e&1) + j.
      const float* ss = reinterpret_cast<const float*>(stage + DEC_W_BYTES + DEC_X_BYTES) +
                        warp * WARP_N + 8 * t4;
      const float4 s0 = *reinterpret_cast<const float4*>(ss);
      const float4 s1 = *reinterpret_cast<const float4*>(ss + 4);
      const float se[4] = {s0.x, s0.y, s0.z, s0.w};
      const float so[4] = {s1.x, s1.y, s1.z, s1.w};
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          acc[j][e] += part[j][e] * ((e & 1) ? so[j] : se[j]);
          part[j][e] = 0.f;
        }
    }
    next_stage(use, stages_per_group);
  }
  cp_async_wait<0>();

  // Block r combines columns [16 r, 16 r + 16): each block stores its
  // partial of those columns, rows < M, into block r's inbox[split].
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = g + 8 * h;
    if (row >= M) continue;
#pragma unroll
    for (int odd = 0; odd < 2; ++odd) {
      const int e = 2 * h + odd;
      const int col = warp * WARP_N + 8 * t4 + 4 * odd;
      float* dst = cluster.map_shared_rank(&inbox[split][row][col % DEC_SLICE],
                                           col / DEC_SLICE);
      *reinterpret_cast<float4*>(dst) = make_float4(acc[0][e], acc[1][e], acc[2][e], acc[3][e]);
    }
  }
  cluster.sync();  // every partial is in its inbox

  // The splits summed in split order from 0, four columns a thread.
  for (int i = threadIdx.x; i < M * DEC_SLICE / 4; i += DEC_THREADS) {
    const int row = i / (DEC_SLICE / 4);
    const int c = i % (DEC_SLICE / 4) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int r = 0; r < DEC_SPLITS; ++r) {
      const float4 p = *reinterpret_cast<const float4*>(&inbox[r][row][c]);
      v.x += p.x;
      v.y += p.y;
      v.z += p.z;
      v.w += p.w;
    }
    const int col = nb + split * DEC_SLICE + c;
    if (col < N) *reinterpret_cast<float4*>(out + (long)row * N + col) = v;
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
    dim3 grid((N + DEC_BN - 1) / DEC_BN, DEC_SPLITS);
    int4_mm_decode_kernel<<<grid, DEC_THREADS, 0, st>>>(xp, qp, sp, op, M, K, N, group);
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
