// Single-query GQA decode attention over the stacked int8 KV cache (K2),
// written for Hopper (sm_90a) and bound to Python with ctypes.
//
// Replaces eventgpt_tpu/ops/decode_attention.py::_decode_attn_kernel (the
// Pallas TPU kernel launched by decode_attention_int8), whose grid (B, KV)
// takes one row's whole sequence per cell with a one-shot softmax. Here the
// sequence is split across blocks and the partials combined, as
// decode_split.cuh sets out; only the addressing is this file's: logical
// slot j of row b in layer li is slot (li * B + b) * S + j of the full
// (L, B, S, KV, hd) buffers, so no per-layer copy is made. Shared memory
// does not grow with S, so any cache length is taken.
//
// Bound on an H100 SXM at the 7B decode shape (B = 4, S = 896, KV = 32,
// G = 1, hd = 128, ~850 visible slots a row): the int8 K and V payloads
// plus their f32 scales over the visible slots, about 28 MB -> 8.4 us at
// 3.35 TB/s. The work is ~0.03 GFLOP: bound by bytes, no tensor cores.
// There the wrapper takes 7 splits of 128 slots: 896 blocks, ~7 an SM.

#include "decode_split.cuh"

// q: (B, KV, G, HD) bf16; kq/vq: (L, B, S, KV, HD) int8; ks/vs:
// (L, B, S, KV, 1) f32; n_valid: (B,) int32; out: (B, KV, G, HD) bf16 when
// out_bf16 else f32; part: f32 scratch of B * KV * (n_split * (G * HD +
// 2 * G + 1) + G * S + G * n_split + 1); split: slots per split, n_split =
// ceil(S / split). All contiguous and 16-byte aligned; HD in {32, 64,
// 128}; 1 <= G <= 8; 0 <= li < L. Launches on `stream` and returns the
// first launch's cudaError_t (0 on success); never synchronizes.
extern "C" int egpt_decode_attention_int8(const void* q, const void* kq, const void* ks,
                                          const void* vq, const void* vs, const void* n_valid,
                                          void* out, void* part, int out_bf16, int li, int B,
                                          int S, int KV, int G, int HD, int split, int n_split,
                                          float scale, void* stream) {
  egpt_split::Params p{};
  p.q = (const __nv_bfloat16*)q;
  p.kq = (const int8_t*)kq;
  p.ks = (const float*)ks;
  p.vq = (const int8_t*)vq;
  p.vs = (const float*)vs;
  p.n_valid = (const int*)n_valid;
  p.out = out;
  p.part = (float*)part;
  p.out_bf16 = out_bf16;
  p.li = li;
  p.B = B;
  p.KV = KV;
  p.G = G;
  p.slots = S;
  p.split = split;
  p.n_split = n_split;
  p.munit = split;  // one max for the row: one unit per split is enough
  p.n_units = n_split;
  p.scale = scale;
  return egpt_split::launch<false>(p, HD, stream);
}
