// Single-query GQA decode attention over the paged int8 KV arena (K3),
// written for Hopper (sm_90a) and bound to Python with ctypes.
//
// Replaces eventgpt_tpu/ops/decode_attention.py::_paged_attn_kernel (the
// Pallas TPU kernel launched by decode_attention_int8_paged), whose grid
// walks a row's block table one entry at a time with an online softmax.
// Here the table is split across blocks, a whole number of entries each,
// and the partials combined, as decode_split.cuh sets out; only the
// addressing is this file's: logical slot p of row b lives at slot p % bs
// of pool block bt[b, p / bs] in layer li of the (L, N, bs, KV, hd) arena.
// Each split loads and checks its own table entries before it uses any:
// an entry outside [0, N) that the row needs is never dereferenced, and
// its split's bad flag makes the combine write NaN for that (b, h).
//
// Bound on an H100 SXM at the 7B serving shape (B = 4, KV = 32, G = 1,
// hd = 128, 16 table entries of 64 slots, ~860 visible slots a row): the
// visible slots' int8 K and V and their f32 scales, about 29 MB -> 8.7 us
// at 3.35 TB/s. The work is ~0.03 GFLOP: bound by bytes, no tensor cores.
// There the wrapper takes 8 splits of 2 entries: 1024 blocks.

#include "decode_split.cuh"

// q: (B, KV, G, HD) bf16; kq/vq: (L, N, bs, KV, HD) int8; ks/vs:
// (L, N, bs, KV, 1) f32; bt: (B, nbpr) int32; n_valid: (B,) int32; out:
// (B, KV, G, HD) bf16 when out_bf16 else f32; part: f32 scratch of
// B * KV * (n_split * (G * HD + 2 * G + 1) + G * nbpr * bs + G * nbpr + 1);
// split: slots per split, a multiple of bs of at most 128 entries,
// n_split = ceil(nbpr * bs / split). All contiguous and 16-byte aligned;
// HD in {32, 64, 128}; 1 <= G <= 8; 0 <= li < L. Launches on `stream`
// and returns the first launch's cudaError_t (0 on success); never
// synchronizes.
extern "C" int egpt_decode_attention_int8_paged(const void* q, const void* kq, const void* ks,
                                                const void* vq, const void* vs, const void* bt,
                                                const void* n_valid, void* out, void* part,
                                                int out_bf16, int li, int B, int N, int bs,
                                                int nbpr, int KV, int G, int HD, int split,
                                                int n_split, float scale, void* stream) {
  if (N <= 0 || bs <= 0 || nbpr <= 0 || split % bs != 0 ||
      split / bs > egpt_split::MAX_SPLIT_ENTRIES) {
    return (int)cudaErrorInvalidValue;
  }
  egpt_split::Params p{};
  p.q = (const __nv_bfloat16*)q;
  p.kq = (const int8_t*)kq;
  p.ks = (const float*)ks;
  p.vq = (const int8_t*)vq;
  p.vs = (const float*)vs;
  p.n_valid = (const int*)n_valid;
  p.bt = (const int*)bt;
  p.out = out;
  p.part = (float*)part;
  p.out_bf16 = out_bf16;
  p.li = li;
  p.B = B;
  p.KV = KV;
  p.G = G;
  p.slots = nbpr * bs;
  p.split = split;
  p.n_split = n_split;
  p.munit = bs;  // a running max per table entry
  p.n_units = nbpr;
  p.bs = bs;
  p.nbpr = nbpr;
  p.n_blocks = N;
  p.scale = scale;
  return egpt_split::launch<true>(p, HD, stream);
}
