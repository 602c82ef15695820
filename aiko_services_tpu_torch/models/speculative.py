"""Speculative decoding's device-side pieces: acceptance, commit and the
proposers' helpers.

Port of the serving half of ``aiko_services_tpu/models/speculative.py``.
A proposer (a draft model, or the slot's own history through
:func:`ngram_propose`) fills each live slot's ``k``-token window, ONE
target verify pass scores it (:func:`~.llama.verify_chunk_paged`), an
acceptance function picks each slot's committed prefix, and
:func:`spec_commit` applies EOS and budget caps and advances the resident
serving state, with no logits leaving the device.

Greedy acceptance is an exact argmax match, so greedy output is identical
to target-only greedy decode.  Sampled acceptance is modified rejection
sampling (Leviathan et al.): each committed token is distributed exactly
as target-only sampling at the row's controls.  The random bits come from
a ``torch.Generator``, so the two packages draw different tokens from the
same seed; the tests compare distributions.

Rejected proposals leave stale KV rows past the committed position.
Attention masks by ABSOLUTE position and every row is rewritten before it
first becomes attendable, so stale rows are unreachable.

The standalone ``speculative_generate*`` loops and the grammar overlay
``merge_forced`` are not ported yet.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from . import llama

__all__ = ["SpecStats", "mrs_accept_batch", "greedy_accept_batch",
           "spec_commit", "ngram_propose", "delta_draft_logits"]


class SpecStats:
    """Acceptance accounting of a speculative server."""

    def __init__(self):
        self.target_passes = 0
        self.drafted = 0
        self.accepted = 0
        #: Pool blocks a paged verify wrote past the committed frontier
        #: (rejected speculation).  A logical rollback only: the worst-case
        #: reservation keeps the blocks owned, the stale rows are
        #: unattendable and rewritten before they become reachable.
        self.rollback_blocks = 0
        #: Grammar-forced tokens committed through jump-forward windows
        #: (grammars are not ported: stays 0).
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


def delta_draft_logits(proposals, vocab: int):
    """Draft logits for a DETERMINISTIC proposer (n-gram lookup): a
    near-delta distribution on each proposed token.  Modified rejection
    sampling with ``q = delta(proposal)`` stays exactly target-distributed
    (accept with probability ``min(1, p(proposal))``, else sample the
    residual ``max(0, p - delta * p)`` renormalized), so sampled slots
    compose with self-drafting through :func:`mrs_accept_batch`."""
    return F.one_hot(proposals.long(), vocab).to(torch.float32) * 1e4
