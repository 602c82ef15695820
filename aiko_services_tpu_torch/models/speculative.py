"""Speculative decoding's device-side pieces: acceptance, commit and the
proposers' helpers.

Port of ``aiko_services_tpu/models/speculative.py``.  In the servers a
proposer (a draft model, or the slot's own history through
:func:`ngram_propose`) fills each live slot's ``k``-token window, ONE
target verify pass scores it (:func:`~.llama.verify_chunk_paged` on the
paged layout, :func:`~.llama.verify_chunk_ragged` on the contiguous one),
an acceptance function picks each slot's committed prefix, and
:func:`spec_commit` applies EOS and budget caps and advances the resident
serving state, with no logits leaving the device.  The standalone batch-1
loops :func:`speculative_generate` (greedy) and
:func:`speculative_generate_sampled` run the same protocol on contiguous
caches, verifying with :func:`~.llama.prefill_chunk`.

Greedy acceptance is an exact argmax match, so greedy output is identical
to target-only greedy decode.  Sampled acceptance is modified rejection
sampling (Leviathan et al.): each committed token is distributed exactly
as target-only sampling at the row's controls.  The random bits come from
a ``torch.Generator``, so the two packages draw different tokens from the
same seed; the tests compare distributions.

Rejected proposals leave stale KV rows past the committed position.
Attention masks by ABSOLUTE position and every row is rewritten before it
first becomes attendable, so stale rows are unreachable.

Grammar-constrained rows ride the same round: :func:`merge_forced`
overlays each constrained row's forced jump-forward segment on the
proposals, and :func:`~.constrained.constrained_accept_batch` picks their
committed windows.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.paged_attention import contiguous_rows
from . import llama

__all__ = ["speculative_generate", "speculative_generate_sampled",
           "SpecStats", "mrs_accept_batch", "greedy_accept_batch",
           "spec_commit", "ngram_propose", "delta_draft_logits",
           "merge_forced"]


class SpecStats:
    """Acceptance accounting of a speculative server or generate call."""

    def __init__(self):
        self.target_passes = 0
        self.drafted = 0
        self.accepted = 0
        #: Pool blocks a paged verify wrote past the committed frontier
        #: (rejected speculation).  A logical rollback only: the worst-case
        #: reservation keeps the blocks owned, the stale rows are
        #: unattendable and rewritten before they become reachable.
        self.rollback_blocks = 0
        #: Grammar-forced tokens committed through jump-forward windows.
        self.jump_forward_tokens = 0
        #: Round-slots where the n-gram proposer found a suffix match in
        #: the slot's own history (proposal coverage, not acceptance).
        self.ngram_hits = 0

    @property
    def acceptance_rate(self) -> float:
        return self.accepted / self.drafted if self.drafted else 0.0

    @property
    def tokens_per_target_pass(self) -> float:
        return ((self.accepted + self.target_passes)
                / self.target_passes if self.target_passes else 0.0)

    def __repr__(self):
        return (f"SpecStats(passes={self.target_passes}, "
                f"accept={self.accepted}/{self.drafted} "
                f"= {self.acceptance_rate:.0%}, "
                f"tok/pass={self.tokens_per_target_pass:.2f})")


def _assemble(proposals, counts, final_token):
    """(slots, k+1) window: the accepted proposals, then the final token at
    position ``counts`` (later columns 0)."""
    slots, k = proposals.shape
    device = proposals.device
    tokens = torch.where(torch.arange(k, device=device)[None, :]
                         < counts[:, None], proposals,
                         torch.zeros_like(proposals))
    tokens = torch.cat([tokens, torch.zeros((slots, 1), dtype=tokens.dtype,
                                            device=device)], dim=1)
    window = torch.arange(k + 1, device=device)[None, :]
    return torch.where(window == counts[:, None], final_token[:, None],
                       tokens).to(torch.int32)


def _accepted_prefix(accept, caps):
    """Accepted proposals per row: the length of the all-true prefix of
    ``accept`` (slots, k), proposals past a row's cap force-rejected."""
    k = accept.shape[1]
    if caps is not None:
        accept = accept & (torch.arange(k, device=accept.device)[None, :]
                           < caps[:, None])
    prefix = torch.cumprod(accept.to(torch.int32), dim=-1)
    return prefix.sum(dim=-1, dtype=torch.int32)


def greedy_accept_batch(target_logits, proposals, caps=None):
    """Greedy acceptance on the device: the accepted prefix is the longest
    argmax match between ``proposals (slots, k)`` and the verify pass's
    ``target_logits (slots, k+1, vocab)``; the final token is the target's
    own argmax at the first divergence (or the bonus token on full
    accept).  ``caps`` (slots,) int32, optional, is the adaptive
    controller's per-slot k: proposals past a row's cap are rejected, so
    the row commits at most ``caps[i] + 1`` tokens (``caps = 0`` commits
    exactly the plain-decode next token).

    Returns ``(tokens (slots, k+1), counts (slots,))``: the first
    ``counts[i]`` entries of row i are that slot's committed tokens."""
    target_greedy = target_logits.argmax(dim=-1).to(torch.int32)
    k = proposals.shape[1]
    counts = _accepted_prefix(proposals == target_greedy[:, :k], caps)
    final_token = target_greedy.gather(1, counts[:, None].long())[:, 0]
    return _assemble(proposals, counts, final_token), counts + 1


def mrs_accept_batch(target_logits, draft_logits, proposals, temperatures,
                     top_ps, generator, caps=None):
    """Modified rejection sampling for a slot batch, on the device.

    ``target_logits (slots, k+1, vocab)`` (position j predicts window token
    j), ``draft_logits (slots, k, vocab)`` (the draft's next-token logits
    when it proposed token j), ``proposals (slots, k)``, per-slot
    ``temperatures``/``top_ps``; random numbers from ``generator``.  Rows
    with temperature 0 take exact greedy acceptance, so one call serves
    mixed batches.  ``caps`` as in :func:`greedy_accept_batch`; a row that
    accepts its whole cap draws its final token from the target's own
    distribution, so committed tokens stay target-distributed at every
    cap.

    Returns ``(tokens (slots, k+1), counts (slots,))`` as
    :func:`greedy_accept_batch`."""
    slots, k = proposals.shape
    device = proposals.device
    temps, tops = temperatures[:, None], top_ps[:, None]
    p_dist = llama.sampling_probs(
        target_logits.reshape(slots * (k + 1), -1),
        temps.repeat_interleave(k + 1, dim=0),
        tops.repeat_interleave(k + 1, dim=0)).reshape(slots, k + 1, -1)
    q_dist = llama.sampling_probs(
        draft_logits.reshape(slots * k, -1),
        temps.repeat_interleave(k, dim=0),
        tops.repeat_interleave(k, dim=0)).reshape(slots, k, -1)
    index = proposals.long()[..., None]
    p_prop = p_dist[:, :k].gather(-1, index)[..., 0]
    q_prop = q_dist.gather(-1, index)[..., 0]
    u = torch.rand((slots, k), generator=generator, device=device,
                   dtype=torch.float32)
    ratio = p_prop / q_prop.clamp_min(1e-30)
    sampled_accept = u < ratio.clamp_max(1.0)
    target_greedy = target_logits.argmax(dim=-1).to(torch.int32)
    greedy_accept = proposals == target_greedy[:, :k]
    sampled_row = temperatures > 0
    accept = torch.where(sampled_row[:, None], sampled_accept,
                         greedy_accept)
    counts = _accepted_prefix(accept, caps)
    # Final token at window position ``counts``: the MRS residual on a
    # rejection, the target's own distribution on a full accept.
    vocab = p_dist.shape[-1]
    p_sel = p_dist.gather(1, counts.long()[:, None, None]
                          .expand(slots, 1, vocab))[:, 0]
    q_index = counts.clamp_max(k - 1).long()
    q_sel = q_dist.gather(1, q_index[:, None, None]
                          .expand(slots, 1, vocab))[:, 0]
    residual = (p_sel - q_sel).clamp_min(0.0)
    residual_mass = residual.sum(dim=-1, keepdim=True)
    # p == q (an empty residual) degrades to sampling from p itself.
    rejected_dist = torch.where(residual_mass > 0,
                                residual / residual_mass.clamp_min(1e-30),
                                p_sel)
    full = counts == (k if caps is None else caps)
    final_dist = torch.where(full[:, None], p_sel, rejected_dist)
    sampled_final = llama.sample_logits(
        torch.log(final_dist.clamp_min(1e-30)), generator)
    greedy_final = target_greedy.gather(1, counts[:, None].long())[:, 0]
    final_token = torch.where(sampled_row, sampled_final, greedy_final)
    return _assemble(proposals, counts, final_token), counts + 1


def spec_commit(state, window, counts_raw, eos_id: int = -1):
    """Commit one speculative round against the resident serving ``state``
    (see ``llama.serve_chunk_ragged``): apply each slot's accepted window
    with EOS and budget caps, advance the resident token and positions,
    deactivate finished lanes.  Emission stops at the budget
    (``remaining``); an EOS inside the emitted range is itself emitted and
    retires the lane; positions advance by the FULL committed window (the
    verify pass wrote those cache rows whatever the caps).

    Returns ``(emit_tokens (slots, k+1), emit_counts, resync,
    new_state)``: ``emit_tokens[s, :emit_counts[s]]`` are the tokens to
    deliver; ``resync`` (slots, k) is the zero-padded committed window
    minus its last token, which the draft replays to re-sync its cache.
    (The JAX function also returns the round's drafted and accepted
    counts; the server derives them on the host from the full committed
    windows it reads back anyway.)"""
    k1 = window.shape[1]
    device = window.device
    active, remaining = state["active"], state["remaining"]
    zero = torch.zeros_like(remaining)
    counts_raw = torch.where(active, counts_raw.to(torch.int32), zero)
    idx = torch.arange(k1, device=device)[None, :]
    valid = idx < counts_raw[:, None]
    no_eos = torch.full_like(counts_raw, k1 + 1)
    if eos_id >= 0:
        is_eos = valid & (window == eos_id)
        eos_cap = torch.where(is_eos.any(dim=-1),
                              is_eos.to(torch.int32).argmax(dim=-1)
                              .to(torch.int32) + 1, no_eos)
    else:
        eos_cap = no_eos
    emit_counts = torch.minimum(torch.minimum(counts_raw, remaining),
                                eos_cap)
    emit_counts = torch.where(active, emit_counts, zero)
    new_remaining = remaining - emit_counts
    ended = active & ((new_remaining <= 0) | (eos_cap <= emit_counts))
    last = window.gather(1, (counts_raw - 1).clamp_min(0).long()[:, None])
    new_state = dict(
        state,
        token=torch.where(active[:, None], last, state["token"]),
        positions=torch.where(active, state["positions"] + counts_raw,
                              state["positions"]),
        active=active & ~ended,
        remaining=new_remaining)
    resync_live = (torch.arange(k1 - 1, device=device)[None, :]
                   < (counts_raw - 1)[:, None]) & active[:, None]
    resync = torch.where(resync_live, window[:, :k1 - 1],
                         torch.zeros_like(window[:, :k1 - 1]))
    emit_tokens = torch.where(valid, window, torch.zeros_like(window))
    return emit_tokens, emit_counts, resync, new_state


def ngram_propose(history, k: int, max_ngram: int = 3,
                  min_ngram: int = 1) -> Tuple[np.ndarray, bool]:
    """Model-free n-gram / prompt-lookup proposal: suffix-match the last
    ``n``-gram of ``history`` (longest ``n`` first, ``max_ngram`` down to
    ``min_ngram``) against an EARLIER occurrence in the same history and
    propose the ``k`` tokens that followed the MOST RECENT match.  Host
    numpy only; proposal quality never affects greedy exactness.

    Returns ``(proposals (k,) int32 zero-padded, hit)``; ``hit`` is False
    when no suffix recurs (the proposals are then zeros)."""
    history = np.asarray(history, np.int64).reshape(-1)
    proposals = np.zeros(k, np.int32)
    n_hist = history.shape[0]
    for n in range(min(max_ngram, n_hist - 1), min_ngram - 1, -1):
        pattern = history[n_hist - n:]
        # Candidate END positions of earlier matches (exclusive), most
        # recent last; the suffix occurrence itself is excluded.
        windows = np.lib.stride_tricks.sliding_window_view(
            history[:n_hist - 1], n)
        matches = np.nonzero((windows == pattern).all(axis=1))[0]
        if matches.size == 0:
            continue
        start = int(matches[-1]) + n          # continuation start
        continuation = history[start:start + k]
        proposals[:continuation.shape[0]] = continuation.astype(np.int32)
        return proposals, True
    return proposals, False


def merge_forced(proposals, forced, forced_mask):
    """Overlay grammar-forced windows onto a round's proposals: rows with
    ``forced_mask`` (slots,) take their ``forced`` (slots, k) tokens
    verbatim (jump-forward segments), the other rows keep the draft or
    n-gram proposals."""
    return torch.where(forced_mask[:, None], forced.to(proposals.dtype),
                       proposals)


def delta_draft_logits(proposals, vocab: int):
    """Draft logits for a DETERMINISTIC proposer (n-gram lookup): a
    near-delta distribution on each proposed token.  Modified rejection
    sampling with ``q = delta(proposal)`` stays exactly target-distributed
    (accept with probability ``min(1, p(proposal))``, else sample the
    residual ``max(0, p - delta * p)`` renormalized), so sampled slots
    compose with self-drafting through :func:`mrs_accept_batch`."""
    return F.one_hot(proposals.long(), vocab).to(torch.float32) * 1e4


# --------------------------------------------------------------------------- #
# The standalone batch-1 loops

def _setup(target_params, draft_params, prompt, num_new, target_config,
           draft_config, k, max_seq):
    """Shared entry checks and prefill of both loops, on the device the
    target's params live on: returns (prompt_len, max_seq, target logits,
    target cache, draft cache).  The caches hold ``max_seq`` rows rounded
    up by :func:`~..ops.paged_attention.contiguous_rows` (the rows past
    ``max_seq`` are never reached), so that their chunked forwards and
    decode keep to the kernels on the card."""
    if target_config.vocab_size != draft_config.vocab_size:
        raise ValueError("draft and target must share a vocabulary")
    device = target_params["final_norm"].device
    prompt = torch.as_tensor(np.asarray(prompt, np.int32),
                             device=device)[None, :]
    prompt_len = prompt.shape[1]
    max_seq = max_seq or min(target_config.max_seq_len,
                             draft_config.max_seq_len)
    if prompt_len + num_new + k + 1 > max_seq:
        raise ValueError(
            f"prompt {prompt_len} + {num_new} new + {k + 1} speculation "
            f"overrun max_seq {max_seq}")
    rows = contiguous_rows(max_seq)
    target_cache = llama.init_cache(target_config, 1, rows, device=device)
    draft_cache = llama.init_cache(draft_config, 1, rows, device=device)
    target_logits, target_cache = llama.prefill(
        target_params, prompt, target_cache, target_config)
    _, draft_cache = llama.prefill(draft_params, prompt, draft_cache,
                                   draft_config)
    return prompt_len, max_seq, target_logits, target_cache, draft_cache


def _resync_draft(draft_params, draft_cache, new_tokens, k, pos,
                  draft_config):
    """Re-sync the draft's cache with the committed tokens.  The draft
    wrote K/V for its INPUTS ``[last@pos, d_1..d_{k-1}@pos+1..]``; the next
    round feeds the new ``last`` at ``pos + len(new_tokens)``, so
    ``new_tokens[:-1]`` needs its rows at ``pos + 1`` on (idempotent
    rewrites on a partial accept; ``d_k``'s row on a full one).  A fixed
    k-wide window, zero-padded: one shape, and the pad rows land where
    later rounds rewrite them before they become attendable.  Exactness
    never depends on this, only acceptance does."""
    if len(new_tokens) <= 1:
        return draft_cache
    resync_tokens = new_tokens[:-1] + [0] * (k - (len(new_tokens) - 1))
    device = draft_cache[0]["k"].device
    resync = torch.as_tensor([resync_tokens], dtype=torch.int32,
                             device=device)
    _, draft_cache = llama.prefill_chunk(draft_params, resync, draft_cache,
                                         pos + 1, draft_config)
    return draft_cache


def speculative_generate(target_params, draft_params, prompt,
                         num_new: int, target_config, draft_config,
                         k: int = 4, max_seq: Optional[int] = None
                         ) -> Tuple[np.ndarray, SpecStats]:
    """Greedy speculative decode of one prompt: the draft proposes ``k``
    tokens (:func:`~.llama.generate_tokens`), the target scores ``[last,
    d_1..d_k]`` in ONE :func:`~.llama.prefill_chunk` pass, the longest
    prefix matching the target's argmax is kept plus the target's own next
    token.  The output is identical to target-only greedy decode.

    ``prompt`` (prompt_len,) int; both caches hold ``max_seq`` rows
    (default the smaller model's ``max_seq_len``; rounded up to a multiple
    of 128) on the target params' device.  Returns (tokens (num_new,)
    int64, stats)."""
    prompt_len, max_seq, target_logits, target_cache, draft_cache = \
        _setup(target_params, draft_params, prompt, num_new,
               target_config, draft_config, k, max_seq)
    device = target_logits.device
    stats = SpecStats()
    committed = [int(target_logits[0, -1].argmax())]
    stats.target_passes += 1          # the prefill pass produced token 1
    pos = prompt_len                  # the position of committed[-1]
    while len(committed) < num_new:
        last = torch.as_tensor([[committed[-1]]], dtype=torch.int32,
                               device=device)
        proposals, draft_cache = llama.generate_tokens(
            draft_params, last, draft_cache, pos, k, draft_config)
        proposals_host = [int(t) for t in proposals[0].tolist()]
        stats.drafted += k
        # logits[j] predicts position pos + j + 1.
        chunk = torch.as_tensor([[committed[-1]] + proposals_host],
                                dtype=torch.int32, device=device)
        logits, target_cache = llama.prefill_chunk(
            target_params, chunk, target_cache, pos, target_config)
        stats.target_passes += 1
        greedy = logits[0].argmax(dim=-1).tolist()        # (k+1,)
        accepted = 0
        while accepted < k and proposals_host[accepted] == greedy[accepted]:
            accepted += 1
        stats.accepted += accepted
        # The accepted drafts and the target's own next token (the
        # correction on a mismatch, a free bonus token on a full accept).
        new_tokens = proposals_host[:accepted] + [int(greedy[accepted])]
        committed.extend(new_tokens)
        draft_cache = _resync_draft(draft_params, draft_cache, new_tokens,
                                    k, pos, draft_config)
        pos += len(new_tokens)
    return np.asarray(committed[:num_new], np.int64), stats


def _softmax64(logits, temperature):
    z = np.asarray(logits, np.float64) / max(temperature, 1e-6)
    z -= z.max()
    e = np.exp(z)
    return e / e.sum()


def _speculative_step(p_probs, q_probs, proposal, rng):
    """One modified-rejection-sampling step (Leviathan et al.): accept the
    draft's ``proposal`` with probability ``min(1, p/q)``, else sample the
    residual ``max(0, p - q)`` renormalized.  With ``proposal ~ q_probs``
    the returned token is distributed exactly as ``p_probs``.  ``rng`` a
    numpy ``Generator``.  Returns (token, accepted)."""
    ratio = p_probs[proposal] / max(q_probs[proposal], 1e-30)
    if rng.random() < min(1.0, ratio):
        return int(proposal), True
    residual = np.maximum(p_probs - q_probs, 0.0)
    total = residual.sum()
    if total <= 0.0:                 # p == q: the residual is empty
        return int(rng.choice(len(p_probs), p=p_probs)), False
    return int(rng.choice(len(residual), p=residual / total)), False


def speculative_generate_sampled(target_params, draft_params, prompt,
                                 num_new: int, target_config,
                                 draft_config, k: int = 4,
                                 temperature: float = 1.0, seed: int = 0,
                                 max_seq: Optional[int] = None
                                 ) -> Tuple[np.ndarray, SpecStats]:
    """SAMPLED speculative decode at ``temperature``: each committed token
    is distributed as target-only sampling at that temperature (modified
    rejection sampling; a full-accept round earns a bonus token from the
    target's own distribution).  The draft samples on the device from a
    ``torch.Generator`` seeded ``seed`` (:func:`~.llama.
    sample_tokens_with_logits`); acceptance runs on the host in f64 from a
    numpy generator seeded ``seed``, so ``q`` matches the draft's f32
    sampler to f32 rounding.  ``temperature <= 0`` is the greedy
    :func:`speculative_generate`.  Batch 1.  Returns (tokens (num_new,)
    int64, stats)."""
    if temperature <= 0:
        return speculative_generate(target_params, draft_params, prompt,
                                    num_new, target_config, draft_config,
                                    k=k, max_seq=max_seq)
    rng = np.random.default_rng(seed)
    prompt_len, max_seq, target_logits, target_cache, draft_cache = \
        _setup(target_params, draft_params, prompt, num_new,
               target_config, draft_config, k, max_seq)
    device = target_logits.device
    generator = torch.Generator(device=device).manual_seed(seed)
    stats = SpecStats()
    first_probs = _softmax64(target_logits[0, -1].cpu().numpy(),
                             temperature)
    committed = [int(rng.choice(len(first_probs), p=first_probs))]
    stats.target_passes += 1
    pos = prompt_len
    while len(committed) < num_new:
        last = torch.as_tensor([[committed[-1]]], dtype=torch.int32,
                               device=device)
        proposal_arr, draft_rows, draft_cache = \
            llama.sample_tokens_with_logits(
                draft_params, last, draft_cache, pos, k, draft_config,
                temperature, generator)
        proposals = [int(t) for t in proposal_arr[0].tolist()]
        rows_host = draft_rows[0].cpu().numpy()              # (k, vocab)
        q_dists = [_softmax64(rows_host[j], temperature) for j in range(k)]
        stats.drafted += k
        chunk = torch.as_tensor([[committed[-1]] + proposals],
                                dtype=torch.int32, device=device)
        logits, target_cache = llama.prefill_chunk(
            target_params, chunk, target_cache, pos, target_config)
        stats.target_passes += 1
        target_host = logits[0].cpu().numpy()             # (k+1, vocab)
        new_tokens = []
        for j in range(k):
            p = _softmax64(target_host[j], temperature)
            tok, accepted = _speculative_step(p, q_dists[j], proposals[j],
                                              rng)
            new_tokens.append(tok)
            if not accepted:
                break                 # the residual sample corrects it
            stats.accepted += 1
        else:
            # Full accept: a bonus token from the target's own distribution.
            p = _softmax64(target_host[k], temperature)
            new_tokens.append(int(rng.choice(len(p), p=p)))
        committed.extend(new_tokens)
        draft_cache = _resync_draft(draft_params, draft_cache, new_tokens,
                                    k, pos, draft_config)
        pos += len(new_tokens)
    return np.asarray(committed[:num_new], np.int64), stats
