// Split-sequence int8 decode attention for Hopper (sm_90a): the device code
// that K2 (decode_attention.cu, the stacked cache) and K3
// (paged_attention.cu, the paged arena) share. The two differ only in how
// a row's logical slot is addressed (a row base in the stacked cache
// against a block-table lookup in the arena) and in which max the softmax
// rounds against (one max for K2, a running max per table entry for K3).
//
// The function, for one (batch row b, KV head h) and its G query rows:
//   * q rounded to bf16; score[g, j] = (q[g] . k8[j]) in f32, times
//     (k_s[j] * scale) -- the per-vector scale after the dot;
//   * slots j >= n_valid[b] take the finite NEG_INF = -FLT_MAX, so a row
//     with n_valid = 0 averages all of its slots with weight 1;
//   * p = exp(score - m), l = sum p; p * v_s[j] is rounded to bf16 before
//     the P.V dot with the int8 values; out = (P.V) / max(l, 1e-30), in
//     bf16 or f32 (q's dtype). K2's m is the row's max (the Pallas
//     kernel's one-shot softmax); K3's is the running max up to and
//     including the slot's table entry, and each entry's sums are carried
//     by exp(m_entry - m_last), as the Pallas grid walks the table.
//
// Bound: bytes. At the 7B shapes (B = 4, KV = 32, G = 1, hd = 128, ~860
// visible slots a row) the visible slots' int8 K and V and their f32
// scales are ~29 MB, 8.6 us at 3.35 TB/s; the work is ~0.03 GFLOP, far
// below the card's ridge point, so there are no tensor cores here (no
// mma, no wgmma). The only aim is to keep enough bytes in flight.
//
// Design: the sequence is split across blocks, two launches in order, 4
// warps a block so that the whole grid is resident at once at the 7B
// shapes (~8 blocks an SM).
//   1. decode_scores_kernel, grid (B, KV, n_split): split sp takes logical
//      slots [sp * split, (sp + 1) * split). HD/16 lanes share a slot, each
//      loading 16 bytes of K; a thread issues the loads of 4 slots before
//      it uses any (8 KB in flight a block at hd = 128, 64 KB an SM). It
//      writes the f32 scores (B, KV, G, slots) and the max of each unit of
//      `munit` slots (K2: the split, K3: a table entry) to the scratch. K3
//      loads and checks the split's table entries first; one outside
//      [0, N) that the split needs is never dereferenced and sets the
//      split's bad flag.
//   2. decode_pv_kernel, the same grid: from the unit maxima each block
//      takes the reference max of its units (a warp scan for K3's running
//      max) and the row's final max m*, then loads V, v_s and the scores
//      of its slots, rounds bf16(p * v_s) exactly where the Pallas kernel
//      does, and sums acc = sum c_u bf16(p v_s) v8 and l = sum c_u p with
//      c_u = exp(m_u - m*). A warp's sums meet by shuffles, the warps' in
//      shared memory in warp order; the block writes its partial
//      (m*, l_i, acc_i[G][HD]). The last split of a (b, h) to finish,
//      known by an integer ticket that the scores pass resets, combines
//      them: m* = max m_i, w_i = exp(m_i - m*),
//      out = sum w_i acc_i / max(sum w_i l_i, 1e-30), in split order with
//      no float atomics, so two calls give equal bits; NaN for the whole
//      (b, h) if a split's bad flag is set.
// A split wholly past the last slot it reads returns at once and writes
// nothing; the later pass skips it. With n_valid > 0 the slots past it
// are never read. With n_valid = 0 every split reads every slot's V with
// score NEG_INF: every max stays NEG_INF and every weight is exp(0) = 1.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

namespace egpt_split {

constexpr int NWARPS = 4;
constexpr int THREADS = NWARPS * 32;
constexpr int GMAX = 8;                 // query heads per KV head
constexpr int MAX_SPLIT_ENTRIES = 128;  // K3 table entries per split
constexpr float NEG_INF = -FLT_MAX;     // finfo(float32).min
static_assert(MAX_SPLIT_ENTRIES <= THREADS, "a thread loads each table entry of a split");

struct Params {
  const __nv_bfloat16* q;  // (B, KV, G, HD)
  const int8_t* kq;        // K2 (L, B, S, KV, HD); K3 (L, N, bs, KV, HD)
  const float* ks;         // the same with a last axis of 1
  const int8_t* vq;
  const float* vs;
  const int* n_valid;      // (B,)
  const int* bt;           // K3 (B, nbpr); unused by K2
  void* out;               // (B, KV, G, HD), bf16 when out_bf16 else f32
  float* part;             // scratch, laid out by Scratch below
  int out_bf16, li, B, KV, G;
  int slots;     // logical slots of a row: K2 S, K3 nbpr * bs
  int split;     // slots per split (K3: a multiple of bs)
  int n_split;   // ceil(slots / split)
  int munit;     // slots per max unit: K2 split, K3 bs
  int n_units;   // ceil(slots / munit)
  int bs, nbpr, n_blocks;  // K3 only
  float scale;
};

// The scratch, in floats: for each (b, h, split) record r in (B, KV,
// n_split) order, acc[r][G][HD], ml[r][G][2] = (m, l) and flag[r]; then
// score[b][h][G][slots], umax[b][h][G][n_units] and ticket[b][h].
struct Scratch {
  float *acc, *ml, *flag, *score, *umax;
  unsigned* ticket;
  template <int HD>
  __device__ static Scratch of(const Params& p) {
    const long recs = (long)p.B * p.KV * p.n_split;
    Scratch s;
    s.acc = p.part;
    s.ml = s.acc + recs * p.G * HD;
    s.flag = s.ml + recs * 2 * p.G;
    s.score = s.flag + recs;
    s.umax = s.score + (long)p.B * p.KV * p.G * p.slots;
    s.ticket = reinterpret_cast<unsigned*>(s.umax + (long)p.B * p.KV * p.G * p.n_units);
    return s;
  }
};

// Slots [0, n_vis) of row b are visible; slots [0, n_read) take part.
struct Extent {
  int n_vis, n_read;
};
__device__ __forceinline__ Extent row_extent(const Params& p, int b) {
  const int nv = p.n_valid[b];
  const int n_vis = min(max(nv, 0), p.slots);
  return {n_vis, nv > 0 ? n_vis : p.slots};
}

__device__ __forceinline__ int4 load16(const int8_t* ptr) {
  return __ldg(reinterpret_cast<const int4*>(ptr));
}

// The 16 int8 values of a 16-byte load as exact f32s: each byte, offset
// to unsigned, goes under the exponent of 2^23 by a byte permute, and an
// add takes 2^23 + 128 away again (instead of a quarter-rate I2F each).
__device__ __forceinline__ void int8x16_to_f32(const int4& raw, float (&f)[16]) {
  const uint32_t w[4] = {(uint32_t)raw.x, (uint32_t)raw.y, (uint32_t)raw.z, (uint32_t)raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t u = w[i] ^ 0x80808080u;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      f[4 * i + j] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540 + j)) - 8388736.f;
  }
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffff, v, o));
  return v;
}

// What both split passes begin with: the split's slots [s0, s1) (s0 >= s1
// for a split past the last slot read), and for K3 its table entries in
// `ent`, loaded beside n_valid and checked. Returns true if the block is to
// go on. The caller loads its own shared data before; the barrier here
// publishes both.
template <bool PAGED>
__device__ __forceinline__ bool split_prologue(const Params& p, int b, int sp, int* ent,
                                               int& s0, int& s1, int& e0, bool& bad) {
  s0 = sp * p.split;
  e0 = PAGED ? s0 / p.bs : 0;
  const int n_e = PAGED ? min(p.split / p.bs, p.nbpr - e0) : 0;
  const int i = threadIdx.x;
  const int e = PAGED && i < n_e ? p.bt[(long)b * p.nbpr + e0 + i] : 0;
  s1 = min(s0 + p.split, row_extent(p, b).n_read);
  bad = false;
  if (s0 >= s1) return false;
  if (PAGED && i < n_e) {
    ent[i] = e;
    bad = e0 + i <= (s1 - 1) / p.bs && (e < 0 || e >= p.n_blocks);
  }
  bad = __syncthreads_or(bad);
  return !bad;
}

// The physical slot of logical slot `pos` of row b.
template <bool PAGED>
__device__ __forceinline__ long slot_of(const Params& p, int b, const int* ent, int e0,
                                        int pos) {
  if (PAGED) {
    const int e = pos / p.bs;
    return ((long)p.li * p.n_blocks + ent[e - e0]) * p.bs + (pos - e * p.bs);
  }
  return ((long)p.li * p.B + b) * p.slots + pos;
}

template <int HD, int GT, bool PAGED>
__global__ void __launch_bounds__(THREADS, GT == 1 ? 8 : 1) decode_scores_kernel(const Params p) {
  constexpr int LPK = HD / 16;        // lanes per slot, 16 bytes each
  constexpr int KPT = THREADS / LPK;  // slots per round of the block
  constexpr int UNR = 4;              // rounds whose loads fly together
  __shared__ __align__(16) float qf[GT * HD];  // q as f32 of its bf16
  __shared__ int ent[PAGED ? MAX_SPLIT_ENTRIES : 1];

  const int b = blockIdx.x, h = blockIdx.y, sp = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int part = tid % LPK, sub = tid / LPK;
  const int G = p.G;
  const Scratch sc = Scratch::of<HD>(p);
  const long rec = ((long)b * p.KV + h) * p.n_split + sp;
  if (sp == 0 && tid == 0) sc.ticket[(long)b * p.KV + h] = 0u;

  const __nv_bfloat16* qb = p.q + ((long)b * p.KV + h) * G * HD;
  for (int i = tid; i < G * HD; i += THREADS) qf[i] = __bfloat162float(qb[i]);
  int s0, s1, e0;
  bool bad;
  if (!split_prologue<PAGED>(p, b, sp, ent, s0, s1, e0, bad)) {
    if (bad && tid == 0) sc.flag[rec] = 1.f;
    return;
  }
  const int n_vis = row_extent(p, b).n_vis;
  const long pitch = (long)p.KV * HD;  // bytes between slots
  const long hoff = (long)h * HD + part * 16;
  float* srow = sc.score + ((long)b * p.KV + h) * G * p.slots;

  for (int c0 = s0; c0 < s1; c0 += KPT * UNR) {
    int4 kr[UNR];
    float ksc[UNR];
#pragma unroll
    for (int u = 0; u < UNR; ++u) {  // only visible slots' K is read
      const int pos = c0 + u * KPT + sub;
      const bool vis = pos < s1 && pos < n_vis;
      const long slot = vis ? slot_of<PAGED>(p, b, ent, e0, pos) : 0;
      kr[u] = vis ? load16(p.kq + slot * pitch + hoff) : make_int4(0, 0, 0, 0);
      ksc[u] = vis ? __ldg(p.ks + slot * p.KV + h) * p.scale : 0.f;
    }
#pragma unroll
    for (int g = 0; g < GT; ++g) {
      if (g >= G) break;
      const float4* qg = reinterpret_cast<const float4*>(qf + g * HD + part * 16);
#pragma unroll
      for (int u = 0; u < UNR; ++u) {
        const int pos = c0 + u * KPT + sub;
        float k8[16];
        int8x16_to_f32(kr[u], k8);
        float dot = 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float4 qv = qg[i];
          dot = fmaf(k8[4 * i + 0], qv.x, dot);
          dot = fmaf(k8[4 * i + 1], qv.y, dot);
          dot = fmaf(k8[4 * i + 2], qv.z, dot);
          dot = fmaf(k8[4 * i + 3], qv.w, dot);
        }
#pragma unroll
        for (int o = LPK / 2; o > 0; o >>= 1) dot += __shfl_xor_sync(0xffffffff, dot, o);
        if (part == 0 && pos < s1)
          srow[(long)g * p.slots + pos] = pos < n_vis ? dot * ksc[u] : NEG_INF;
      }
    }
  }
  __syncthreads();  // the block's scores are visible to the block

  // The max of each unit of the split, one warp per (unit, query row).
  const int u0 = s0 / p.munit;
  const int n_u = (s1 - 1) / p.munit - u0 + 1;
  for (int w = warp; w < n_u * G; w += NWARPS) {
    const int u = u0 + w / G, g = w % G;
    const int lo = max(s0, u * p.munit), hi = min(s1, (u + 1) * p.munit);
    float mx = NEG_INF;
    for (int j = lo + lane; j < hi; j += 32) mx = fmaxf(mx, srow[(long)g * p.slots + j]);
    mx = warp_max(mx);
    if (lane == 0) sc.umax[(((long)b * p.KV + h) * G + g) * p.n_units + u] = mx;
  }
  if (tid == 0) sc.flag[rec] = 0.f;
}

// The last split of (b, h) to finish combines the partials of the n_used
// splits that read a slot, in split order: one output element a thread.
template <int HD>
__device__ __forceinline__ void combine(const Params& p, const Scratch& sc, int b, int h,
                                        int n_used) {
  const int G = p.G;
  const long rec0 = ((long)b * p.KV + h) * p.n_split;
  const float* ml = sc.ml + rec0 * 2 * G;
  bool bad = false;
  for (int s = 0; s < n_used; ++s) bad |= __ldcg(sc.flag + rec0 + s) != 0.f;
  for (int i = threadIdx.x; i < G * HD; i += THREADS) {
    const int g = i / HD;
    float o = NAN;  // a table entry outside the pool: the whole (b, h) is NaN
    if (!bad) {
      float mm = NEG_INF;
      for (int s = 0; s < n_used; ++s) mm = fmaxf(mm, __ldcg(ml + s * 2 * G + 2 * g));
      float a = 0.f, ll = 0.f;
      for (int s = 0; s < n_used; ++s) {
        const float w = expf(__ldcg(ml + s * 2 * G + 2 * g) - mm);
        a += w * __ldcg(sc.acc + (rec0 + s) * G * HD + i);
        ll += w * __ldcg(ml + s * 2 * G + 2 * g + 1);
      }
      o = a / fmaxf(ll, 1e-30f);
    }
    const long oi = ((long)b * p.KV + h) * G * HD + i;
    if (p.out_bf16) {
      reinterpret_cast<__nv_bfloat16*>(p.out)[oi] = __float2bfloat16_rn(o);
    } else {
      reinterpret_cast<float*>(p.out)[oi] = o;
    }
  }
}

template <int HD, int GT, bool PAGED>
__global__ void __launch_bounds__(THREADS, GT == 1 ? 8 : 1) decode_pv_kernel(const Params p) {
  constexpr int LPK = HD / 16;
  constexpr int KPT = THREADS / LPK;
  constexpr int UNR = GT <= 2 ? 4 : 2;
  constexpr int NU = PAGED ? MAX_SPLIT_ENTRIES : 1;  // units of a split
  __shared__ __align__(16) float wacc[NWARPS][GT * HD];  // each warp's sums
  __shared__ float wl[NWARPS][GT];
  __shared__ float mref[GT][NU], cw[GT][NU];  // each unit's max and carry
  __shared__ float mfin[GT];
  __shared__ int ent[PAGED ? MAX_SPLIT_ENTRIES : 1];
  __shared__ bool last;

  const int b = blockIdx.x, h = blockIdx.y, sp = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int part = tid % LPK, sub = tid / LPK;
  const int G = p.G;
  const Scratch sc = Scratch::of<HD>(p);
  const long rec = ((long)b * p.KV + h) * p.n_split + sp;
  const Extent ext = row_extent(p, b);

  int s0, s1, e0;
  bool bad;
  const bool go = split_prologue<PAGED>(p, b, sp, ent, s0, s1, e0, bad);
  if (!go && !bad) return;  // past the last slot read: the combine skips it
  if (go) {  // a bad split (flagged by the scores pass) adds no partial
    const int u0 = s0 / p.munit;
    const int n_u = (s1 - 1) / p.munit - u0 + 1;
    const long pitch = (long)p.KV * HD;
    const long hoff = (long)h * HD + part * 16;
    const float* srow = sc.score + ((long)b * p.KV + h) * G * p.slots;
    int4 vr[UNR];
    float vsc[UNR], s[UNR][GT];
    bool pres[UNR];
    // Every load of a round before any use; the first round's before the
    // scan of the unit maxima, which its loads do not wait for.
    auto load_round = [&](int c0) {
#pragma unroll
      for (int u = 0; u < UNR; ++u) {
        const int pos = c0 + u * KPT + sub;
        pres[u] = pos < s1;
        const long slot = pres[u] ? slot_of<PAGED>(p, b, ent, e0, pos) : 0;
        vr[u] = pres[u] ? load16(p.vq + slot * pitch + hoff) : make_int4(0, 0, 0, 0);
        vsc[u] = pres[u] ? __ldg(p.vs + slot * p.KV + h) : 0.f;
#pragma unroll
        for (int g = 0; g < GT; ++g)
          s[u][g] = pres[u] && g < G ? srow[(long)g * p.slots + pos] : NEG_INF;
      }
    };
    load_round(s0);

    // Warp w scans the unit maxima of query rows w, w + NWARPS, ...: the
    // running max at each of this split's units (K3) and the row's final
    // max; K2 rounds every unit against the final max.
    const int n_used_u = (ext.n_read - 1) / p.munit + 1;
    for (int g = warp; g < G; g += NWARPS) {
      const float* um = sc.umax + (((long)b * p.KV + h) * G + g) * p.n_units;
      float carry = NEG_INF;
      for (int c = 0; c < n_used_u; c += 32) {
        float v = c + lane < n_used_u ? um[c + lane] : NEG_INF;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const float up = __shfl_up_sync(0xffffffff, v, o);
          if (lane >= o) v = fmaxf(v, up);
        }
        v = fmaxf(v, carry);
        const int u = c + lane - u0;
        if (PAGED && u >= 0 && u < n_u) mref[g][u] = v;
        carry = __shfl_sync(0xffffffff, v, 31);
      }
      if (lane == 0) mfin[g] = carry;
      __syncwarp();
      for (int u = lane; u < n_u; u += 32) {
        if (!PAGED) mref[g][u] = carry;
        cw[g][u] = expf(mref[g][u] - carry);
      }
    }
    __syncthreads();

    float l[GT], acc[GT][16];
#pragma unroll
    for (int g = 0; g < GT; ++g) {
      l[g] = 0.f;
#pragma unroll
      for (int d = 0; d < 16; ++d) acc[g][d] = 0.f;
    }
    for (int c0 = s0;;) {
#pragma unroll
      for (int u = 0; u < UNR; ++u) {
        if (!pres[u]) continue;
        const int unit = (c0 + u * KPT + sub) / p.munit - u0;
        float v8[16];
        int8x16_to_f32(vr[u], v8);
#pragma unroll
        for (int g = 0; g < GT; ++g) {
          if (g >= G) break;
          const float pr = expf(s[u][g] - mref[g][unit]);
          const float c = cw[g][unit];
          l[g] = fmaf(pr, c, l[g]);
          const float pv = __bfloat162float(__float2bfloat16_rn(pr * vsc[u])) * c;
#pragma unroll
          for (int d = 0; d < 16; ++d) acc[g][d] = fmaf(pv, v8[d], acc[g][d]);
        }
      }
      c0 += KPT * UNR;
      if (c0 >= s1) break;
      load_round(c0);
    }

    // The warp's sums of each 16-dim part meet by shuffles...
#pragma unroll
    for (int o = LPK; o < 32; o <<= 1) {
#pragma unroll
      for (int g = 0; g < GT; ++g) {
        if (g >= G) break;
        l[g] += __shfl_xor_sync(0xffffffff, l[g], o);
#pragma unroll
        for (int d = 0; d < 16; ++d) acc[g][d] += __shfl_xor_sync(0xffffffff, acc[g][d], o);
      }
    }
    // ...and the warps' in shared memory, in warp order.
    if (lane < LPK) {
#pragma unroll
      for (int g = 0; g < GT; ++g) {
        if (g >= G) break;
        float4* dst = reinterpret_cast<float4*>(&wacc[warp][g * HD + part * 16]);
#pragma unroll
        for (int i = 0; i < 4; ++i)
          dst[i] = make_float4(acc[g][4 * i], acc[g][4 * i + 1], acc[g][4 * i + 2],
                               acc[g][4 * i + 3]);
        if (lane == 0) wl[warp][g] = l[g];
      }
    }
    __syncthreads();

    float* pacc = sc.acc + rec * G * HD;
    float* pml = sc.ml + rec * 2 * G;
    for (int i = tid; i < G * HD; i += THREADS) {
      const int g = i / HD;
      float a = 0.f;
#pragma unroll
      for (int w = 0; w < NWARPS; ++w) a += wacc[w][i];
      pacc[i] = a;
      if (i % HD == 0) {
        float ll = 0.f;
#pragma unroll
        for (int w = 0; w < NWARPS; ++w) ll += wl[w][g];
        pml[2 * g] = mfin[g];
        pml[2 * g + 1] = ll;
      }
    }
  }

  // Every split that read a slot takes a ticket once its partial is out;
  // the last one combines.
  __threadfence();
  __syncthreads();
  const int n_used = (ext.n_read - 1) / p.split + 1;
  if (tid == 0) last = atomicAdd(sc.ticket + (long)b * p.KV + h, 1u) == (unsigned)n_used - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  combine<HD>(p, sc, b, h, n_used);
}

template <int HD, int GT, bool PAGED>
int launch_hd_gt(const Params& p, cudaStream_t stream) {
  const dim3 grid(p.B, p.KV, p.n_split);
  decode_scores_kernel<HD, GT, PAGED><<<grid, THREADS, 0, stream>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  decode_pv_kernel<HD, GT, PAGED><<<grid, THREADS, 0, stream>>>(p);
  return (int)cudaGetLastError();
}

template <int HD, bool PAGED>
int launch_hd(const Params& p, cudaStream_t stream) {
  if (p.G <= 1) return launch_hd_gt<HD, 1, PAGED>(p, stream);
  if (p.G <= 2) return launch_hd_gt<HD, 2, PAGED>(p, stream);
  if (p.G <= 4) return launch_hd_gt<HD, 4, PAGED>(p, stream);
  return launch_hd_gt<HD, 8, PAGED>(p, stream);
}

// Checks what both entry points share and launches the two kernels on
// `stream`; returns the first cudaError_t (0 on success). Never
// synchronizes.
template <bool PAGED>
int launch(const Params& p, int hd, void* stream) {
  if (p.B == 0 || p.KV == 0) return 0;
  if (p.G < 1 || p.G > GMAX || p.slots <= 0 || p.split <= 0 || p.munit <= 0 ||
      p.n_split != (p.slots + p.split - 1) / p.split ||
      p.n_units != (p.slots + p.munit - 1) / p.munit || p.split % p.munit != 0) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = (cudaStream_t)stream;
  switch (hd) {
    case 32: return launch_hd<32, PAGED>(p, st);
    case 64: return launch_hd<64, PAGED>(p, st);
    case 128: return launch_hd<128, PAGED>(p, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace egpt_split

extern "C" const char* egpt_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
