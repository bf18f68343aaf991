"""EventChat: the multimodal composition (vision tower + projector + LLM).

Port of ``eventgpt_tpu/models/eventchat.py`` for one-shot generation:

  1. ``encode_events_batch`` -- CLIP -> projector -> adaptor -> pooling
                                (or the Q-Former, when the config gates it)
  2. ``llama.prefill``       -- spliced prompt embeddings, KV cache fill
  3. ``llama.decode_step``   -- the greedy or sampled decode loop, or
     the length-normalized beam search (``_beam_loop``), or
     ``llama.decode_kstep``    -- speculative decoding (``_spec_loop``):
                                  suffix-lookup or Medusa drafts verified
                                  K tokens per forward

The host splits ids at the -200 sentinel; ``splice_embeddings``
concatenates [text embeds | event tokens | text embeds]; a batch is
right-padded to a shared length. Each loop is a host loop over device
steps with one host read of its stop flag per iteration; the KV cache is
updated in place, so where the JAX package rolls ``length`` back in a new
cache, the port assigns it.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from eventgpt_tpu_torch.config import EventChatConfig
from eventgpt_tpu_torch.constants import SEQ_BUCKET, SPEC_LOOKUP_MAX
from eventgpt_tpu_torch.data.tokenizer import split_at_event
from eventgpt_tpu_torch.device import resolve_device
from eventgpt_tpu_torch.models import clip as clip_mod
from eventgpt_tpu_torch.models import llama as llama_mod
from eventgpt_tpu_torch.models import medusa as medusa_mod
from eventgpt_tpu_torch.models import projector as proj_mod
from eventgpt_tpu_torch.models import qformer as qformer_mod
from eventgpt_tpu_torch.ops.pooling import spatio_temporal_pool
from eventgpt_tpu_torch.ops.sampling import sample, top_p_filter

Params = Dict[str, Any]


def _encode_feats(params: Params, cfg: EventChatConfig, frames: torch.Tensor) -> torch.Tensor:
    """(N, C, H, W) frames -> (N, num_tokens, D_lm) projected features."""
    feats = clip_mod.clip_encode(params["clip"], cfg.vision, frames)
    feats = proj_mod.apply_projector(params["projector"], feats)
    return proj_mod.apply_adaptor(params["projector"], feats)


def _encode_tail(params: Params, cfg: EventChatConfig, feats: torch.Tensor) -> torch.Tensor:
    """Per-sample (T, num_tokens, D) projected features -> (num_event_tokens,
    D): Q-Former aggregation, raw patch concatenation, or the
    spatio-temporal pool."""
    if cfg.use_event_qformer:
        return qformer_mod.qformer_encode(params["qformer"], cfg.qformer, feats)
    if not cfg.use_spatio_temporal_pool:
        return feats.reshape(-1, feats.shape[-1])
    return spatio_temporal_pool(feats, cfg.num_temporal_tokens)


@torch.inference_mode()
def encode_events_batch(params: Params, cfg: EventChatConfig,
                        pixel_values: torch.Tensor) -> torch.Tensor:
    """(B, T, C, H, W) -> (B, num_event_tokens, D_lm). The tower runs
    batched over the flattened B*T frame axis."""
    b, t = pixel_values.shape[:2]
    flat = pixel_values.reshape((b * t,) + tuple(pixel_values.shape[2:]))
    feats = _encode_feats(params, cfg, flat)
    feats = feats.reshape((b, t) + tuple(feats.shape[1:]))
    return torch.stack([_encode_tail(params, cfg, feats[i]) for i in range(b)])


def _interleave_segments(segments: Sequence[np.ndarray]):
    """The spliced-sequence layout: yields ("text", seg) / ("event", i)
    parts in order, skipping empty text segments."""
    num_events = len(segments) - 1
    for i, seg in enumerate(segments):
        if len(seg):
            yield ("text", seg)
        if i < num_events:
            yield ("event", i)


def splice_embeddings(
    params: Params,
    cfg: EventChatConfig,
    segments: Sequence[np.ndarray],
    event_tokens: torch.Tensor,
    max_context: Optional[int] = None,
) -> torch.Tensor:
    """Interleave text-segment embeddings with event-token blocks.

    ``segments`` are the host-side id chunks around each -200 sentinel
    (``split_at_event``); ``event_tokens`` is (num_events, n_tok, D) or
    (n_tok, D). Returns (T, D), truncated to the smaller of the model
    context and ``max_context``. Text overflow truncates silently; a cut
    inside an event block raises.
    """
    if event_tokens.ndim == 2:
        event_tokens = event_tokens[None]
    num_events = len(segments) - 1
    if event_tokens.shape[0] != num_events:
        raise ValueError(
            f"{num_events} event sentinel(s) in prompt but "
            f"{event_tokens.shape[0]} event clip(s) provided"
        )
    embed = params["llama"]["embed_tokens"]
    parts: List[torch.Tensor] = []
    for kind, val in _interleave_segments(segments):
        if kind == "text":
            ids = torch.as_tensor(np.asarray(val, dtype=np.int64), device=embed.device)
            parts.append(llama_mod.embed_tokens(params["llama"], ids))
        else:
            parts.append(event_tokens[val].to(embed.dtype))
    out = torch.cat(parts, dim=0)
    limit = cfg.llama.max_seq_len if max_context is None else min(cfg.llama.max_seq_len, max_context)
    if out.shape[0] > limit:
        n_text = sum(len(s) for s in segments)
        last_event_end = out.shape[0] - len(segments[-1])
        if num_events and last_event_end > limit:
            raise ValueError(
                f"spliced sequence ({out.shape[0]} tokens: {n_text} text + "
                f"{num_events}x{event_tokens.shape[1]} event) exceeds the "
                f"context cap {limit} inside an event block; raise "
                f"max_seq_len/--context_len or enable spatio-temporal pooling"
            )
    return out[:limit]


def _spliced_text_ids(segments: Sequence[np.ndarray], n_event_tok: int,
                      limit: int) -> np.ndarray:
    """Token-id layout of the spliced sequence: text ids in place and the
    event block's positions -1 (in the embedding stream, but never matched
    or drafted by the speculative lookup)."""
    parts: List[np.ndarray] = []
    for kind, val in _interleave_segments(segments):
        if kind == "text":
            parts.append(np.asarray(val, dtype=np.int32))
        else:
            parts.append(np.full((n_event_tok,), -1, np.int32))
    out = np.concatenate(parts) if parts else np.zeros((0,), np.int32)
    return out[:limit]


def _vocab_size(params: Params) -> int:
    """The vocab of the lm_head leaf, which special tokens may have grown
    past the config's: (V, D) when dense, (K, V) when quantized."""
    head = params["llama"]["lm_head"]
    if isinstance(head, dict):
        return int(head.get("q", head.get("q4")).shape[-1])
    return int(head.shape[0])


def _pad_batch(embeds: List[torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor, np.ndarray]:
    """Right-pad per-sample (T_i, D) embeds to (B, T_max, D) + bool mask."""
    lens = np.array([int(e.shape[0]) for e in embeds])
    t_max = int(lens.max())
    padded = torch.stack([F.pad(e, (0, 0, 0, t_max - e.shape[0])) for e in embeds])
    mask = torch.as_tensor(np.arange(t_max)[None, :] < lens[:, None], device=padded.device)
    return padded, mask, lens


def prepare_prefill(params: Params, cfg: EventChatConfig,
                    input_ids_batch: Sequence[Sequence[int]],
                    pixel_values_batch, max_context: Optional[int] = None):
    """Encode the events and splice each prompt: returns the right-padded
    (B, T, D) embeddings, their (B, T) mask and the per-row lengths."""
    embed = params["llama"]["embed_tokens"]
    pixels = torch.as_tensor(np.asarray(pixel_values_batch), device=embed.device).to(embed.dtype)
    event_tokens = encode_events_batch(params, cfg, pixels)
    embeds = [
        splice_embeddings(params, cfg, split_at_event(ids), event_tokens[i], max_context)
        for i, ids in enumerate(input_ids_batch)
    ]
    return _pad_batch(embeds)


@torch.inference_mode()
def _decode_loop(params: Params, cfg: EventChatConfig, first_logits: torch.Tensor,
                 cache, generator: Optional[torch.Generator], max_new_tokens: int,
                 temperature: float, top_p: float, eos_token_id: int):
    """The autoregressive loop. Returns (tokens (B, max_new_tokens) int32
    on the host, number of steps run).

    Rows that hit EOS are frozen to EOS thereafter; the loop stops when
    every row is done or the budget is spent. Each step samples, then runs
    one decode step unconditionally, so the step after the stop condition
    is computed and discarded, as in the JAX package's while_loop.
    """
    b = first_logits.shape[0]
    device = first_logits.device
    tokens = torch.zeros((b, max(max_new_tokens, 1)), dtype=torch.int32, device=device)
    done = torch.zeros((b,), dtype=torch.bool, device=device)
    eos = torch.tensor(eos_token_id, dtype=torch.int32, device=device)
    logits = first_logits
    step = 0
    while step < max_new_tokens:
        next_tok = sample(logits, generator, temperature, top_p)
        next_tok = torch.where(done, eos, next_tok)
        tokens[:, step] = next_tok
        done = done | (next_tok == eos)
        token_embeds = llama_mod.embed_tokens(params["llama"], next_tok[:, None].long())
        logits, cache = llama_mod.decode_step(params["llama"], cfg.llama, token_embeds, cache)
        step += 1
        if bool(done.all()):
            break
    return tokens[:, :max_new_tokens].cpu().numpy(), step


def _top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k largest along the last axis, ties to the lower index, as
    ``lax.top_k`` gives them: a stable descending sort keeps equal values
    in index order (``torch.topk`` on CUDA promises no order among ties,
    and logits of bf16 weights often tie exactly)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _cache_planes(cache) -> List[torch.Tensor]:
    """The tensors of a KV cache's k and v planes: a buffer each in the
    compute dtype, or int8 ``q`` and f32 ``s`` each."""
    out = []
    for name in ("k", "v"):
        buf = cache[name]
        out.extend(buf.values() if isinstance(buf, dict) else [buf])
    return out


def _repeat_rows(cache, k: int):
    """A new dense cache with each batch row repeated ``k`` times in place
    (rows b*k .. b*k + k - 1 are row b): axis 1 of the planes, axis 0 of
    ``length``."""
    def rep(buf):
        if isinstance(buf, dict):
            return {key: t.repeat_interleave(k, dim=1) for key, t in buf.items()}
        return buf.repeat_interleave(k, dim=1)

    return {"k": rep(cache["k"]), "v": rep(cache["v"]),
            "length": cache["length"].repeat_interleave(k, dim=0)}


def _beam_regather(cache, flat_parent: torch.Tensor, gather_start: int) -> None:
    """Permute the cache rows by parent beam, in place, over slots
    [gather_start, S) only: slots below the shortest prompt are the same
    in every beam of a row. The right side's advanced index makes a copy,
    so no row is read after it was overwritten."""
    for t in _cache_planes(cache):
        t[:, :, gather_start:] = t[:, flat_parent, gather_start:]
    cache["length"].copy_(cache["length"][flat_parent])


@torch.inference_mode()
def _beam_loop(params: Params, cfg: EventChatConfig, first_logits: torch.Tensor, cache,
               num_beams: int, max_new_tokens: int, eos_token_id: int, gather_start: int = 0):
    """Deterministic length-normalized beam search (HF ``length_penalty=1``):
    the cumulative log-prob over the generated length picks the answer.
    Port of the JAX package's ``_beam_loop_jit``.

    Beams are an expanded batch of B * k rows over ``decode_step``; each
    step takes the top k of ``scores + logp`` over (k * V) candidates per
    row and regathers the cache tail [gather_start, S) by parent beam
    (``_beam_regather``). Done beams extend only with EOS at zero cost.
    Returns (tokens (B, max_new_tokens) of the best beam, its lengths (B,),
    its length-normalized score (B,), steps run), on the device.
    """
    b, v = first_logits.shape
    k = num_beams
    device = first_logits.device
    logp0 = torch.log_softmax(first_logits.float(), dim=-1)
    scores, tok0 = _top_k(logp0, k)  # (B, k)
    cache = _repeat_rows(cache, k)
    tokens = torch.zeros((b, k, max_new_tokens), dtype=torch.int32, device=device)
    tokens[:, :, 0] = tok0.to(torch.int32)
    done = tok0 == eos_token_id
    lengths = torch.ones((b, k), dtype=torch.int32, device=device)
    rows = torch.arange(b, device=device)[:, None]
    eos_only = torch.full((v,), -1e30, dtype=torch.float32, device=device)
    eos_only[eos_token_id] = 0.0

    step = 1
    while step < max_new_tokens and not bool(done.all()):
        last = tokens[:, :, step - 1].reshape(b * k)
        emb = llama_mod.embed_tokens(params["llama"], last[:, None].long())
        logits, cache = llama_mod.decode_step(params["llama"], cfg.llama, emb, cache)
        logp = torch.log_softmax(logits.float(), dim=-1).reshape(b, k, v)
        logp = torch.where(done[:, :, None], eos_only, logp)
        scores, idx = _top_k((scores[:, :, None] + logp).reshape(b, k * v), k)
        parent = idx // v
        tok = (idx % v).to(torch.int32)
        tokens = tokens[rows, parent]
        tokens[:, :, step] = tok
        par_done = done[rows, parent]
        par_len = lengths[rows, parent]
        lengths = torch.where(par_done, par_len, par_len + 1)
        done = par_done | (tok == eos_token_id)
        _beam_regather(cache, (rows * k + parent).reshape(-1), gather_start)
        step += 1
    norm = scores / lengths.clamp_min(1).float()
    best = torch.argmax(norm, dim=1)
    row = torch.arange(b, device=device)
    return tokens[row, best], lengths[row, best], norm[row, best], step


def _suffix_match_levels(tokens: torch.Tensor, suffix: torch.Tensor):
    """Per-position raw suffix-match depth. ``tokens`` (..., P) is a lookup
    buffer (-1 = filler), ``suffix`` (B, LMAX) the tail newest-first.
    Returns (levels (B, P) int32, cont (B or 1, P) continuation tokens): a
    match of depth l ends at j iff tokens[j - i] == suffix[:, i] for all
    i < l; fillers never match, and the ``idx >= i`` gate removes the
    roll's wrap."""
    lmax = suffix.shape[1]
    toks2d = tokens if tokens.ndim == 2 else tokens[None, :]
    idx = torch.arange(toks2d.shape[-1], device=tokens.device)
    run = torch.ones(toks2d.shape, dtype=torch.bool, device=tokens.device)
    levels = torch.zeros(toks2d.shape, dtype=torch.int32, device=tokens.device)
    for i in range(lmax):
        tok_i = suffix[:, i][:, None]  # (B, 1)
        eq = (torch.roll(toks2d, i, dims=-1) == tok_i) & (tok_i >= 0) & (idx >= i)[None, :]
        run = run & eq
        levels = levels + run.to(torch.int32)
    return levels, torch.roll(toks2d, -1, dims=-1)


def _advance_match_levels(tokens: torch.Tensor, levels: torch.Tensor,
                          d: torch.Tensor) -> torch.Tensor:
    """Raw match depths once the suffix gains ``d`` (B,) on its newest side:
    depth(j) = tokens[j] == d ? 1 + min(old depth(j - 1), LMAX - 1) : 0,
    what a full rescan gives, at O(P)."""
    toks2d = tokens if tokens.ndim == 2 else tokens[None, :]
    prev = torch.cat([torch.zeros_like(levels[:, :1]), levels[:, :-1]], dim=1)
    hit = (toks2d == d[:, None]) & (d[:, None] >= 0)
    return torch.where(hit, 1 + prev.clamp(max=SPEC_LOOKUP_MAX - 1), torch.zeros_like(prev))


def _suffix_vote_drafts(params: Params, ids_buf: torch.Tensor, pos: torch.Tensor, window: int,
                        history: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Draft ``window - 1`` tokens by longest-suffix majority vote, the JAX
    package's rule. Per draft position, score every committed position of
    ``ids_buf[:, :pos - 1]`` (and of the optional server-wide ``history``
    buffer) by how many trailing tokens match the current suffix (up to
    ``SPEC_LOOKUP_MAX``); among the deepest matches, the continuation with
    the most votes wins (ties to the smallest id); no match repeats the
    newest token. Each draft extends the suffix for the next one. Fillers
    (-1) never match or vote. Returns (B, window - 1) int32.
    """
    b, s_ids = ids_buf.shape
    device = ids_buf.device
    if window <= 1:
        return torch.zeros((b, 0), dtype=torch.int32, device=device)
    v = _vocab_size(params)
    bidx = torch.arange(b, device=device)
    sidx = pos[:, None] - 1 - torch.arange(SPEC_LOOKUP_MAX, device=device)[None, :]
    suffix = torch.where(sidx >= 0, ids_buf[bidx[:, None], sidx.clamp(0, s_ids - 1)],
                         torch.full_like(ids_buf[:, :1], -1))  # (B, LMAX) newest-first
    committed = torch.arange(s_ids, device=device)[None, :] <= (pos - 2)[:, None]
    raw, cont = _suffix_match_levels(ids_buf, suffix)
    gate = committed & (cont >= 0)
    if history is not None:
        h = history.shape[-1]
        hraw, hcont = _suffix_match_levels(history, suffix)
        hgate = (torch.arange(h, device=device) <= h - 2)[None, :] & (hcont >= 0)

    newest = suffix[:, 0]
    drafts = []
    for i in range(window - 1):
        if i:
            raw = _advance_match_levels(ids_buf, raw, newest)
            if history is not None:
                hraw = _advance_match_levels(history, hraw, newest)
        levels = torch.where(gate, raw, 0)
        lstar = levels.amax(dim=1)  # (B,)
        if history is not None:
            hlevels = torch.where(hgate, hraw, 0)
            lstar = torch.maximum(lstar, hlevels.amax(dim=1))
        at_max = (levels == lstar[:, None]) & (lstar[:, None] > 0)
        votes = torch.zeros((b, v), dtype=torch.int64, device=device)
        votes.scatter_add_(1, cont.clamp(0, v - 1).long(), at_max.long())
        if history is not None:
            h_at_max = (hlevels == lstar[:, None]) & (lstar[:, None] > 0)
            votes.scatter_add_(1, hcont.clamp(0, v - 1).long().expand(b, h), h_at_max.long())
        d = torch.argmax(votes, dim=1).to(torch.int32)
        d = torch.where(lstar > 0, d, newest)
        drafts.append(d)
        newest = d
    return torch.stack(drafts, dim=1)


def _spec_probs(logits: torch.Tensor, temperature: float, top_p: float) -> torch.Tensor:
    """Sampling distribution at each verify position: temperature and the
    nucleus filter, as ``ops/sampling.sample`` applies them."""
    scaled = logits.float() / temperature
    if top_p < 1.0:
        scaled = top_p_filter(scaled, top_p)
    return torch.softmax(scaled, dim=-1)


def _categorical(p: torch.Tensor, generator: Optional[torch.Generator]) -> torch.Tensor:
    """(B, V) probabilities -> (B,) int32 draws, zero mass floored at 1e-38
    as the JAX package's ``categorical(log(max(p, 1e-38)))``."""
    return torch.multinomial(p.clamp_min(1e-38), 1, generator=generator)[:, 0].to(torch.int32)


def _spec_commit_sampled(p: torch.Tensor, drafts: torch.Tensor, u: torch.Tensor,
                         generator: Optional[torch.Generator]):
    """Rejection-sampling acceptance for point-mass drafts.

    ``p`` (B, W, V): p[:, i] is the target distribution after window
    position i. ``drafts`` (B, W - 1) for positions 1 .. W - 1 (-1 is a
    filler, never accepted), ``u`` (B, W - 1) uniforms. Draft i + 1 is
    accepted with probability p_i(d); the first rejection resamples from p
    with the rejected token zeroed (full acceptance samples the bonus token
    from the last position's p), so the committed chain is distributed as
    sequential sampling. Returns (a (B,) accepted count, corrected (B,)).
    ``a`` depends on (p, drafts, u) only; the correction is drawn from
    ``generator``.
    """
    b, w, v = p.shape
    bidx = torch.arange(b, device=p.device)
    if w == 1:
        return torch.zeros((b,), dtype=torch.int64, device=p.device), _categorical(p[:, 0],
                                                                                  generator)
    d_valid = drafts >= 0
    d_safe = drafts.clamp(0, v - 1).long()
    p_draft = torch.where(d_valid, p[:, :-1].gather(2, d_safe[:, :, None])[:, :, 0],
                          torch.zeros_like(u))
    a = torch.cumprod((u < p_draft).to(torch.int32), dim=1).sum(dim=1)
    p_a = p[bidx, a]
    at = a.clamp(max=w - 2)
    rej_valid = (a < w - 1) & d_valid[bidx, at]
    onehot = F.one_hot(d_safe[bidx, at], v).to(p_a.dtype)
    p_adj = torch.where(rej_valid[:, None], p_a * (1.0 - onehot), p_a)
    return a, _categorical(p_adj, generator)


def _spec_draft_verify(params: Params, cfg: EventChatConfig, ids_buf: torch.Tensor,
                       pos: torch.Tensor, cache, generator: Optional[torch.Generator],
                       window: int, temperature: float, top_p: float, eos: int,
                       history: Optional[torch.Tensor] = None, medusa=None,
                       drafts_in: Optional[torch.Tensor] = None,
                       depth: Optional[torch.Tensor] = None):
    """The speculative draft-and-verify step, port of the JAX package's
    ``_spec_draft_verify`` with the same parameters, so that the one-shot
    loop and a speculative server share it.

    Drafts ``window - 1`` tokens by suffix lookup over ``ids_buf[:, :pos]``
    (and ``history``), or takes the Medusa drafts ``drafts_in`` carried
    from the previous window; ``depth`` (B,) masks row r's drafts from
    position depth[r] on to the filler. The window [newest committed
    token, drafts] runs through one ``decode_kstep``; greedy acceptance at
    temperature 0, rejection sampling above it. Any draft leaves the chain
    exact. ``cache["length"]`` is set back to its entry value (the caller
    advances it by what it commits).

    Returns (commit (B, W), m_count (B,), first_eos (B,), hit (B,),
    next_drafts): ``commit[:, :m_count]`` are committable, ``first_eos``
    and ``hit`` locate an EOS in that prefix; ``next_drafts`` are Medusa's
    drafts from the correction position's hidden, or ``drafts_in``.
    """
    b = ids_buf.shape[0]
    device = ids_buf.device
    bidx = torch.arange(b, device=device)
    iarr = torch.arange(window, device=device)[None, :]

    c0 = ids_buf[bidx, (pos - 1).clamp_min(0)]  # newest committed token
    if medusa is not None:
        drafts = drafts_in
    else:
        drafts = _suffix_vote_drafts(params, ids_buf, pos, window, history)
    if depth is not None and window > 1:
        drafts = torch.where(torch.arange(window - 1, device=device)[None, :] < depth[:, None],
                             drafts, torch.full_like(drafts, -1))

    wtoks = torch.cat([c0[:, None], drafts], dim=1)  # (B, W)
    prev_len = cache["length"].clone()
    embeds = llama_mod.embed_tokens(params["llama"], wtoks.long())
    if medusa is not None:
        logits, hidden, _ = llama_mod.decode_kstep(params["llama"], cfg.llama, embeds, cache,
                                                   return_hidden=True)
    else:
        logits, _ = llama_mod.decode_kstep(params["llama"], cfg.llama, embeds, cache)
    if temperature > 0.0:
        p = _spec_probs(logits, temperature, top_p)
        u = torch.rand((b, window - 1), generator=generator, device=device)
        a, corrected = _spec_commit_sampled(p, drafts, u, generator)
    else:
        g = torch.argmax(logits, dim=-1).to(torch.int32)  # (B, W)
        a = torch.cumprod((drafts == g[:, :-1]).to(torch.int32), dim=1).sum(dim=1)
        corrected = g[bidx, a]
    drafts_p = torch.cat([drafts, drafts.new_zeros((b, 1))], dim=1)
    commit = torch.where(iarr < a[:, None], drafts_p, corrected[:, None])
    m_count = a + 1
    is_eos = (commit == eos) & (iarr < m_count[:, None])
    first_eos = torch.where(is_eos, iarr, window).amin(dim=1)
    cache["length"].copy_(prev_len)
    if medusa is not None:
        # The correction came from position a's logits; the heads at that
        # position's hidden predict the tokens after it: the next drafts.
        next_drafts = medusa_mod.medusa_drafts(params["llama"], medusa, hidden[bidx, a],
                                               window - 1)
    else:
        next_drafts = drafts_in
    return commit, m_count, first_eos, first_eos < window, next_drafts


@torch.inference_mode()
def _spec_loop(params: Params, cfg: EventChatConfig, first_logits: torch.Tensor, cache,
               ids_buf: torch.Tensor, prompt_lens: torch.Tensor, max_new_tokens: int,
               window: int, eos_token_id: int, temperature: float = 0.0, top_p: float = 1.0,
               generator: Optional[torch.Generator] = None, medusa=None,
               first_drafts: Optional[torch.Tensor] = None):
    """Speculative decoding: lookup (or Medusa) drafts and one K-token
    verification forward per iteration, port of ``_spec_loop_jit``.

    At temperature 0 the committed chain is exactly the plain greedy one;
    above it, exactly distributed as sequential sampling (not the same
    stream as the plain loop). ``ids_buf`` (B, S) holds the spliced prompt
    ids (-1 over the event block) and the generated ids at
    ``prompt_lens + n``. At each iteration's head ``cache["length"] ==
    prompt_lens + n_gen - 1``: every committed token but the newest is
    cached, and the window feeds that newest token plus ``window - 1``
    drafts. A row's commit stops at EOS; the budget may be overshot (the
    caller clips). One host read of the stop flag per iteration.

    Returns (ids_buf, n_gen (B,), iterations).
    """
    b, s_ids = ids_buf.shape
    device = ids_buf.device
    bidx = torch.arange(b, device=device)
    iarr = torch.arange(window, device=device)[None, :]
    plens = prompt_lens.long()
    t0 = sample(first_logits, generator, temperature, top_p)
    ids_buf = ids_buf.clone()
    ids_buf[bidx, plens] = t0
    n_gen = torch.ones((b,), dtype=torch.int64, device=device)
    done = t0 == eos_token_id
    drafts = (first_drafts if medusa is not None
              else torch.zeros((b, max(window - 1, 0)), dtype=torch.int32, device=device))
    n_iters = 0
    while True:
        active = ~done & (n_gen < max_new_tokens)
        if not bool(active.any()):
            break
        pos = plens + n_gen  # next ids_buf write slot
        commit, m_count, first_eos, hit, drafts = _spec_draft_verify(
            params, cfg, ids_buf, pos, cache, generator, window, temperature, top_p,
            eos_token_id, medusa=medusa, drafts_in=drafts)
        m_eff = torch.where(active, torch.where(hit, first_eos + 1, m_count),
                            torch.zeros_like(m_count))
        wpos = (pos[:, None] + iarr).clamp(0, s_ids - 1)
        cur = ids_buf[bidx[:, None], wpos]
        ids_buf[bidx[:, None], wpos] = torch.where(iarr < m_eff[:, None], commit, cur)
        n_gen = n_gen + m_eff
        done = done | (active & hit)
        # KV stays for the committed tokens but the newest; the slots above
        # are masked from every read and overwritten by the next window.
        cache["length"] += m_eff.to(cache["length"].dtype)
        n_iters += 1
    return ids_buf, n_gen, n_iters


@torch.inference_mode()
def generate(
    params: Params,
    cfg: EventChatConfig,
    input_ids_batch: Sequence[Sequence[int]],
    pixel_values_batch,
    max_new_tokens: int = 512,
    temperature: float = 0.0,
    top_p: float = 1.0,
    eos_token_id: Optional[int] = 2,
    seed: int = 0,
    max_context: Optional[int] = None,
    num_beams: int = 1,
    kv_quant: bool = False,
    speculative: int = 0,
    draft_head=None,
    spec_stats: Optional[Dict[str, int]] = None,
    timings: Optional[Dict[str, float]] = None,
    device="cuda",
) -> List[List[int]]:
    """Autoregressive generation over a batch of event-QA prompts.

    Sampling is on iff temperature > 0 (nucleus ``top_p``), greedy
    otherwise; decode stops per row at EOS or after ``max_new_tokens``.
    ``num_beams > 1`` runs deterministic length-normalized beam search
    (temperature and top_p ignored). ``speculative`` K > 0 runs speculative
    decoding with a K-token verify window (``_spec_loop``): exactly the
    greedy chain at temperature 0, exactly the sampling distribution above
    it; it needs ``num_beams == 1``. ``draft_head``, a Medusa stack
    (``models/medusa.py``) on the parameters' device with at least K - 1
    heads, drafts instead of the suffix lookup. ``spec_stats``, when given,
    gets the speculative loop's ``iterations`` and committed ``tokens``.

    Runs on ``device`` (default ``cuda``, which raises when no card is
    present); ``params`` must already live there.

    ``input_ids_batch``: token ids containing -200 sentinels.
    ``pixel_values_batch``: (B, T_frames, C, H, W).
    ``kv_quant``: keep the KV cache as int8 with per-vector f32 scales.
    ``timings``: when given, filled with host-clock seconds of the encode,
    prefill and decode phases, each ending in a device synchronize, and
    ``decode_steps``, the decode loop's iterations.
    """
    if speculative and num_beams > 1:
        raise ValueError("speculative decoding composes with greedy/sampled decode, "
                         "not beam search: num_beams must be 1")
    if num_beams < 1:
        raise ValueError(f"num_beams must be >= 1, got {num_beams}")
    device = resolve_device(device)
    held = params["llama"]["embed_tokens"].device
    if held.type != device.type:
        raise ValueError(f"generate on {device}: the parameters are on {held}")
    clock = _PhaseClock(held, timings)

    padded, mask, lens = prepare_prefill(params, cfg, input_ids_batch,
                                         pixel_values_batch, max_context)
    clock.lap("encode_s")
    b, t = padded.shape[:2]

    # Bucket the cache length on 2x the training grain, as the JAX package
    # does, so a server cycles through few cache shapes. Speculative
    # windows overshoot by up to ``speculative`` committed tokens and write
    # one window past the last commit: two windows are reserved.
    bucket = 2 * SEQ_BUCKET
    max_len = t + max_new_tokens + (2 * speculative if speculative else 0)
    max_len = ((max_len + bucket - 1) // bucket) * bucket
    cache = llama_mod.init_kv_cache(cfg.llama, b, max_len, dtype=padded.dtype, device=held,
                                    quant=kv_quant)
    want_hidden = bool(speculative) and draft_head is not None
    pre = llama_mod.prefill(params["llama"], cfg.llama, padded, mask, cache, last_only=True,
                            return_hidden=want_hidden)
    last_logits, cache = pre[0], pre[-1]
    clock.lap("prefill_s")
    if max_new_tokens == 0:
        return [[] for _ in range(b)]

    generator = torch.Generator(device=held)
    generator.manual_seed(seed)
    # EOS sentinel: a real id stops rows early; None decodes the full
    # budget (an out-of-vocab sentinel no sampled token matches).
    eos = eos_token_id if eos_token_id is not None else -1
    if num_beams > 1:
        # A lower bound on the shortest prompt on the SEQ_BUCKET grain, as
        # the JAX package takes it (there a static argument).
        tokens, lengths, _, num_steps = _beam_loop(
            params, cfg, last_logits, cache, int(num_beams), max_new_tokens, int(eos),
            gather_start=(int(lens.min()) // SEQ_BUCKET) * SEQ_BUCKET)
        out_tokens, out_lengths = tokens.cpu().numpy(), lengths.cpu().numpy()
        clock.lap("decode_s")
        if timings is not None:
            timings["decode_steps"] = num_steps
        results = []
        for i in range(b):
            ids = [int(tid) for tid in out_tokens[i, :out_lengths[i]]]
            if ids and eos_token_id is not None and ids[-1] == eos_token_id:
                ids = ids[:-1]
            results.append(ids)
        return results
    if speculative:
        window = int(speculative)
        limit = (cfg.llama.max_seq_len if max_context is None
                 else min(cfg.llama.max_seq_len, max_context))
        ids_host = np.full((b, max_len), -1, np.int32)
        for i, ids in enumerate(input_ids_batch):
            row = _spliced_text_ids(split_at_event(ids), cfg.num_event_tokens, limit)
            ids_host[i, :len(row)] = row
        first_drafts = None
        if draft_head is not None:
            first_drafts = medusa_mod.medusa_drafts(params["llama"], draft_head, pre[1],
                                                    window - 1)
        out_buf, n_gen, num_steps = _spec_loop(
            params, cfg, last_logits, cache, torch.as_tensor(ids_host, device=held),
            torch.as_tensor(lens.astype(np.int32), device=held), max_new_tokens, window,
            int(eos), temperature=float(temperature), top_p=float(top_p),
            generator=generator, medusa=draft_head, first_drafts=first_drafts)
        out_np, gen_np = out_buf.cpu().numpy(), n_gen.cpu().numpy()
        clock.lap("decode_s")
        if timings is not None:
            timings["decode_steps"] = num_steps
        if spec_stats is not None:
            spec_stats["iterations"] = num_steps
            spec_stats["tokens"] = int(np.minimum(gen_np, max_new_tokens).sum())
        results = []
        for i in range(b):
            row = out_np[i, lens[i]:lens[i] + min(int(gen_np[i]), max_new_tokens)]
            results.append(_until_eos(row, eos_token_id))
        return results
    out_tokens, num_steps = _decode_loop(
        params, cfg, last_logits, cache, generator, max_new_tokens,
        float(temperature), float(top_p), int(eos))
    clock.lap("decode_s")
    if timings is not None:
        timings["decode_steps"] = num_steps
    return [_until_eos(out_tokens[i, :num_steps], eos_token_id) for i in range(b)]


def _until_eos(row, eos_token_id: Optional[int]) -> List[int]:
    """The ids of ``row`` before its first EOS."""
    ids: List[int] = []
    for tid in row:
        if eos_token_id is not None and tid == eos_token_id:
            break
        ids.append(int(tid))
    return ids


class _PhaseClock:
    """Host-clock laps that end in a device synchronize; records nothing
    when no ``timings`` dict is given."""

    def __init__(self, device: torch.device, timings: Optional[Dict[str, float]]):
        self.device = device
        self.timings = timings
        self.t0 = time.perf_counter()

    def lap(self, name: str) -> None:
        if self.timings is None:
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        now = time.perf_counter()
        self.timings[name] = now - self.t0
        self.t0 = now
