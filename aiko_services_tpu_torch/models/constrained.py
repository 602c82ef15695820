"""Grammar-constrained decoding: hard output guarantees.

Port of ``aiko_services_tpu/models/constrained.py``.  A finite-state token
automaton masks the logits at every step, so ONLY strings the grammar
accepts can be produced, greedy or sampled, with no post-hoc filtering.
The automaton is two dense arrays,

* ``allowed``  (n_states, vocab) bool: which tokens may follow,
* ``next_state`` (n_states, vocab) int32: where each token leads,

so a decode step's constraint is a gather of ``allowed[states]`` and a
``torch.where`` on the device, with no host round trip.  States with no
allowed token are terminal: decoding emits ``pad_token`` once there.

The serving tier stacks named automata into one :class:`AutomatonTable`
(host navigation: jump-forward segments, per-token advance, terminal
detection); its ``allowed`` mask goes to the device once, and
:func:`constrained_accept_batch` masks the constrained rows of a
speculative round.  The automata are numpy, as in the JAX package; the
decode steps are the port's (:func:`~.llama.decode_step`: on the card the
decode kernels).  Sampled rows draw from an explicit ``torch.Generator``
where the JAX package takes a key, so the two packages sample different
tokens from the same seed.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, Sequence, Tuple

import numpy as np
import torch

from . import llama

__all__ = ["TokenAutomaton", "automaton_from_rules",
           "constrained_generate", "AutomatonTable", "stack_automata",
           "constrained_accept_batch"]


@dataclasses.dataclass(frozen=True)
class TokenAutomaton:
    """Dense token-level DFA.  ``allowed[s, t]``: token ``t`` legal in
    state ``s``; ``next_state[s, t]``: the resulting state.  State 0 is
    the start; ``accepting`` marks states where the output may end."""
    allowed: np.ndarray        # (n_states, vocab) bool
    next_state: np.ndarray     # (n_states, vocab) int32
    accepting: np.ndarray      # (n_states,) bool

    @property
    def n_states(self) -> int:
        return self.allowed.shape[0]

    @property
    def vocab(self) -> int:
        return self.allowed.shape[1]

    def accepts(self, tokens: Sequence[int]) -> bool:
        """Host-side check (tests, validation)."""
        state = 0
        for token in tokens:
            if not self.allowed[state, token]:
                return False
            state = int(self.next_state[state, token])
        return bool(self.accepting[state])


def automaton_from_rules(vocab: int,
                         rules: Dict[int, Iterable[Tuple[object, int]]],
                         accepting: Iterable[int]) -> TokenAutomaton:
    """Build a dense automaton from sparse rules: ``rules[state]`` is a
    list of ``(tokens, next_state)`` where ``tokens`` is an iterable of
    token ids or the string ``"*"`` (any token not otherwise listed).
    Later entries override earlier ones; ``"*"`` applies first so specific
    tokens win."""
    n_states = max(max(rules, default=0),
                   max((dst for moves in rules.values()
                        for _, dst in moves), default=0)) + 1
    allowed = np.zeros((n_states, vocab), bool)
    next_state = np.zeros((n_states, vocab), np.int32)
    for state, moves in rules.items():
        for tokens, dst in moves:
            if tokens == "*":
                allowed[state, :] = True
                next_state[state, :] = dst
        for tokens, dst in moves:
            if tokens == "*":
                continue
            ids = np.asarray(list(tokens), np.int32)
            allowed[state, ids] = True
            next_state[state, ids] = dst
    accept = np.zeros((n_states,), bool)
    accept[np.asarray(list(accepting), np.int32)] = True
    return TokenAutomaton(allowed, next_state, accept)


def _mask_pick(logits, states, allowed, next_state, pad_token: int,
               temperature: float, generator):
    """One constrained pick for every row: the token (masked argmax, or a
    masked sample at ``temperature``) and the row's next state; a row in a
    terminal state emits ``pad_token`` and stays there."""
    mask = allowed[states]                             # (batch, vocab)
    terminal = ~mask.any(dim=-1)
    masked = torch.where(mask, logits.to(torch.float32),
                         torch.full_like(logits, -torch.inf,
                                         dtype=torch.float32))
    if temperature and temperature > 0:
        choice = llama.sample_logits(masked, generator, temperature)
    else:
        choice = masked.argmax(dim=-1).to(torch.int32)
    token = torch.where(terminal, torch.full_like(choice, pad_token), choice)
    new_states = torch.where(terminal, states,
                             next_state[states, token.to(torch.int64)])
    return token, new_states


@torch.no_grad()
def constrained_generate(params, first_logits, cache, start_index: int,
                         num_steps: int, config: llama.LlamaConfig,
                         allowed, next_state, pad_token: int = 0,
                         temperature: float = 0.0, generator=None):
    """Decode ``num_steps`` tokens with the automaton masking every step.
    ``first_logits`` (batch, vocab) are the prefill logits for the first
    constrained position; ``allowed`` / ``next_state`` the automaton's
    arrays (numpy or tensors).  Each later step is one
    :func:`~.llama.decode_step` at ``start_index + step`` (the cache is
    updated in place).  A sampled run draws from ``generator`` (seeded 0
    on the logits' device when None).

    Returns (tokens (batch, num_steps) int32, final states (batch,) int64,
    cache)."""
    device = first_logits.device
    allowed = torch.as_tensor(np.asarray(allowed, bool), device=device)
    next_state = torch.as_tensor(np.asarray(next_state, np.int64),
                                 device=device)
    if temperature and temperature > 0 and generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    states = torch.zeros((first_logits.shape[0],), dtype=torch.int64,
                         device=device)
    token, states = _mask_pick(first_logits, states, allowed, next_state,
                               pad_token, temperature, generator)
    tokens = [token]
    for step in range(num_steps - 1):
        logits, cache = llama.decode_step(params, token[:, None], cache,
                                          int(start_index) + step, config)
        token, states = _mask_pick(logits[:, -1], states, allowed,
                                   next_state, pad_token, temperature,
                                   generator)
        tokens.append(token)
    return torch.stack(tokens, dim=1), states, cache


# --------------------------------------------------------------------------- #
# Serving side: the stacked automaton registry and the jump-forward walker


class AutomatonTable:
    """Named automata STACKED into one dense table, so the serving tier
    ships a single ``(total_states, vocab)`` allowed mask to the device
    however many grammars are registered.  A slot's automaton state is one
    GLOBAL int (its grammar's start offset plus its local state).

    Host-side navigation (jump-forward segments, per-token advance,
    terminal detection) lives here; only ``allowed`` crosses to the device
    (once, at server construction) for :func:`constrained_accept_batch`."""

    def __init__(self, automata: Dict[str, TokenAutomaton]):
        if not automata:
            raise ValueError("AutomatonTable needs >= 1 automaton")
        vocabs = {a.vocab for a in automata.values()}
        if len(vocabs) != 1:
            raise ValueError(
                f"automata disagree on vocab size: {sorted(vocabs)}")
        self.vocab = vocabs.pop()
        self.names: Tuple[str, ...] = tuple(automata)
        self.offsets: Dict[str, int] = {}
        allowed_parts, next_parts, accept_parts = [], [], []
        offset = 0
        for name in self.names:
            auto = automata[name]
            self.offsets[name] = offset
            allowed_parts.append(np.asarray(auto.allowed, bool))
            # Local next-state ids become global ones; disallowed entries
            # remap too, harmlessly (advance checks ``allowed`` first).
            next_parts.append(np.asarray(auto.next_state, np.int64) + offset)
            accept_parts.append(np.asarray(auto.accepting, bool))
            offset += auto.n_states
        self.n_states = offset
        self.allowed = np.concatenate(allowed_parts, axis=0)
        self.next_state = np.concatenate(next_parts, axis=0).astype(np.int32)
        self.accepting = np.concatenate(accept_parts, axis=0)
        # Jump-forward: a state admitting EXACTLY one token is
        # deterministic; record that token (else -1).
        n_allowed = self.allowed.sum(axis=-1)
        self._forced_token = np.where(
            n_allowed == 1, self.allowed.argmax(axis=-1), -1).astype(np.int32)

    def start(self, name: str) -> int:
        """Global start state of the named grammar."""
        return self.offsets[name]

    def is_terminal(self, state: int) -> bool:
        """No legal continuation: the request must stop here."""
        return not bool(self.allowed[state].any())

    def advance(self, state: int, token: int) -> int:
        """Consume one generated token; -1 if it is illegal in ``state``
        (a masked server produces that only through a bug)."""
        if not self.allowed[state, token]:
            return -1
        return int(self.next_state[state, token])

    def deterministic_segment(self, state: int, max_len: int
                              ) -> Tuple[list, int]:
        """Walk the forced chain from ``state``: while the state admits
        exactly one token, that token is the ONLY output a masked decode
        could produce, so it needs no model pass to choose it; it becomes
        a jump-forward window the target's verify pass writes the KV of.
        Returns ``(tokens, end_state)`` with ``len(tokens) <= max_len``."""
        tokens = []
        while len(tokens) < max_len:
            forced = int(self._forced_token[state])
            if forced < 0:
                break
            tokens.append(forced)
            state = int(self.next_state[state, forced])
        return tokens, state


def stack_automata(automata: Dict[str, TokenAutomaton]) -> AutomatonTable:
    """Stack a named-automata registry into one :class:`AutomatonTable`
    (the serving tier's construction entry point)."""
    return AutomatonTable(automata)


def constrained_accept_batch(target_logits, base_window, base_counts,
                             forced, forced_counts, states, cons_mask,
                             allowed, temperatures, top_ps, generator=None):
    """Merge grammar-constrained rows into one speculative round's accepted
    window.  For a constrained row the window is the forced jump-forward
    prefix, committed UNCONDITIONALLY (each forced token is the only string
    the grammar admits: the verify pass ran only to write its KV rows),
    then ONE free token chosen from the target's logits at the first
    non-deterministic position, masked to the automaton's allowed set
    (argmax for greedy rows, the temperature/top-p sampler otherwise).  A
    row whose free-position state is TERMINAL commits the forced prefix
    only; the host retires it.

    ``target_logits`` (slots, k+1, vocab) from the verify pass;
    ``base_window`` / ``base_counts`` the unconstrained acceptance result
    (constrained rows overwrite it); ``forced`` (slots, k) zero-padded
    forced proposals with ``forced_counts`` (slots,) valid lengths;
    ``states`` (slots,) GLOBAL automaton states at the free position;
    ``cons_mask`` (slots,) bool selects the constrained rows; ``allowed``
    the stacked (total_states, vocab) bool mask.  Sampled rows
    (``temperatures > 0``) draw from ``generator``; with none, every row
    is greedy.  Returns ``(window (slots, k+1) int32, counts (slots,)
    int32)`` under :func:`~.speculative.greedy_accept_batch`'s
    committed-count contract."""
    slots, k1, vocab = target_logits.shape
    fc = forced_counts.to(torch.int64)
    free_logits = torch.gather(
        target_logits, 1, fc[:, None, None].expand(slots, 1, vocab))[:, 0]
    free_logits = free_logits.to(torch.float32)
    mask = allowed[states.to(torch.int64)]              # (slots, vocab)
    has_free = mask.any(dim=-1)
    masked = torch.where(mask, free_logits,
                         torch.full_like(free_logits, -torch.inf))
    # Terminal rows would feed all -inf rows to argmax/softmax (NaNs);
    # their choice is discarded below, so they get the raw logits.
    safe = torch.where(has_free[:, None], masked, free_logits)
    free_tok = safe.argmax(dim=-1).to(torch.int32)
    if generator is not None:
        probs = llama.sampling_probs(safe, temperatures[:, None],
                                     top_ps[:, None])
        uniform = torch.rand(probs.shape, generator=generator,
                             device=probs.device, dtype=torch.float32)
        uniform = uniform.clamp_min(torch.finfo(torch.float32).tiny)
        gumbel = -torch.log(-torch.log(uniform))
        sampled_tok = (torch.log(probs.clamp_min(1e-30)) + gumbel) \
            .argmax(dim=-1).to(torch.int32)
        free_tok = torch.where(temperatures > 0, sampled_tok, free_tok)
    pos = torch.arange(k1, device=target_logits.device)[None, :]
    forced_pad = torch.cat(
        [forced.to(torch.int32),
         torch.zeros((slots, 1), dtype=torch.int32,
                     device=forced.device)], dim=1)
    cons_window = torch.where(pos < fc[:, None], forced_pad,
                              torch.zeros_like(forced_pad))
    cons_window = torch.where((pos == fc[:, None]) & has_free[:, None],
                              free_tok[:, None], cons_window)
    cons_counts = fc.to(torch.int32) + has_free.to(torch.int32)
    window = torch.where(cons_mask[:, None], cons_window,
                         base_window.to(torch.int32))
    counts = torch.where(cons_mask, cons_counts, base_counts.to(torch.int32))
    return window, counts
