"""Pushdown-constrained decoding: structurally valid LaTeX by construction.

Port of ``handwritten_math_ocr_api_tpu/decode/constrain.py``. Each step's
logits get an additive mask (0 allowed, -1e30 not) so that every emitted
sequence passes ``eval/latex_check.check_latex``. The grammar state is a
bounded pushdown stack per row, int32 and bool tensors on the decode's
device, advanced after every step; the mask is a handful of broadcast
comparisons of that state against class tables derived from the vocab.
Neither reads a device value, so a constrained step makes no host round
trip.

Grammar tracked (``eval/latex_check.py`` rule for rule, strictly: the
stack also enforces proper nesting of braces, ``\\left`` and environments):

- ``{`` / ``}`` balance: ``}`` only when a brace group is open on top;
- ``\\left`` / ``\\right`` pairing; ``\\right`` needs a delimiter after;
- ``\\begin { name } ... \\end { name }``: the name is recorded on the
  stack and the matching ``\\end``'s name is forced (single-token names);
- argument-taking commands (``\\frac`` &c, ``latex_check._ARG_COMMANDS``):
  each owed argument is a stack obligation consumed by one plain token or
  one balanced ``{...}`` group;
- ``^`` / ``_``: banned at step 0 and right after another ``^`` / ``_``;
  their argument is an obligation as above;
- ``<eos>`` only when the stack is empty and nothing is owed; a token
  budget (steps left against the fewest tokens that close everything)
  keeps that state reachable before ``max_len``.

The decoders compute their confidences from the raw logits, so the
reference's confidence keeps its meaning under the constraint.
"""

from __future__ import annotations

from typing import Dict, NamedTuple

import numpy as np
import torch

from ..core.config import EOS_ID, PAD_ID, SOS_ID, UNK_ID
from ..eval.latex_check import _ARG_COMMANDS

# token classes (the cls table's values)
PLAIN, OPEN, CLOSE, LEFT, RIGHT, ARG1, ARG2, SUPSUB, BEGIN, END, EOSC, \
    BANNED = range(12)

# stack entry codes
_EMPTY = 0
_BRACE = 1       # plain '{' group
_BRACE_ARG = 2   # '{' group that discharged an argument obligation
_LEFT = 3        # open \left
_OWE = 4         # one argument unit owed
_ENV_BASE = 1000  # _ENV_BASE + name_token_id: open environment

STACK_DEPTH = 24

# fewest tokens still needed per pending forced step, by mode:
# 0 NORMAL; 1 '\begin' seen -> force '{'; 2 -> name; 3 -> force '}';
# 4 '\end' seen -> force '{'; 5 -> force matching name; 6 -> force '}'
_MODE_COST = np.array([0, 3, 2, 1, 3, 2, 1], np.int32)

_NEG = -1e30  # additive mask of a disallowed token


class ConstraintTables(NamedTuple):
    """The vocab's class tables, on the decode's device."""
    cls: torch.Tensor        # (V,) int32 token class
    nameable: torch.Tensor   # (V,) bool: usable as a \begin env name
    vocab_size: int
    has_env: bool            # the vocab has \begin, \end and a name
    mode_cost: torch.Tensor  # (7,) int32, _MODE_COST on the device


class ConstraintState(NamedTuple):
    """Per-row pushdown state, carried through the decode."""
    stack: torch.Tensor        # (B, STACK_DEPTH) int32
    ptr: torch.Tensor          # (B,) int32
    mode: torch.Tensor         # (B,) int32
    needs_tok: torch.Tensor    # (B,) bool: the previous token (\right)
    #                            needs a successor
    prev_supsub: torch.Tensor  # (B,) bool: the previous token was ^ or _


def build_tables(vocab: Dict[str, int], device=None) -> ConstraintTables:
    """Classify every vocab token (the tokenizer's tokens)."""
    V = max(vocab.values()) + 1
    cls = np.zeros((V,), np.int32)  # PLAIN by default
    nameable = np.zeros((V,), bool)
    for tok, idx in vocab.items():
        if idx in (PAD_ID, SOS_ID, UNK_ID):
            cls[idx] = BANNED
        elif idx == EOS_ID:
            cls[idx] = EOSC
        elif tok == "{":
            cls[idx] = OPEN
        elif tok == "}":
            cls[idx] = CLOSE
        elif tok == "\\left":
            cls[idx] = LEFT
        elif tok == "\\right":
            cls[idx] = RIGHT
        elif tok == "\\begin":
            cls[idx] = BEGIN
        elif tok == "\\end":
            cls[idx] = END
        elif tok in ("^", "_"):
            cls[idx] = SUPSUB
        elif tok in _ARG_COMMANDS:
            cls[idx] = ARG2 if _ARG_COMMANDS[tok] == 2 else ARG1
        else:
            cls[idx] = PLAIN
            if tok.isalpha():  # letter-run tokens: matrix, cases, align...
                nameable[idx] = True
    has_env = (any(t == "\\begin" for t in vocab)
               and any(t == "\\end" for t in vocab)
               and bool(nameable.any()))
    return ConstraintTables(
        cls=torch.from_numpy(cls).to(device),
        nameable=torch.from_numpy(nameable).to(device),
        vocab_size=V, has_env=has_env,
        mode_cost=torch.from_numpy(_MODE_COST).to(device))


def init_state(batch: int, device=None) -> ConstraintState:
    i32 = torch.int32
    return ConstraintState(
        stack=torch.zeros((batch, STACK_DEPTH), dtype=i32, device=device),
        ptr=torch.zeros((batch,), dtype=i32, device=device),
        mode=torch.zeros((batch,), dtype=i32, device=device),
        needs_tok=torch.zeros((batch,), dtype=torch.bool, device=device),
        prev_supsub=torch.zeros((batch,), dtype=torch.bool, device=device))


def _top(state: ConstraintState) -> torch.Tensor:
    """(B,) top-of-stack entry, _EMPTY when the stack is empty."""
    idx = (state.ptr - 1).clamp(min=0).long()
    top = state.stack.gather(1, idx[:, None])[:, 0]
    return torch.where(state.ptr > 0, top, _EMPTY)


def _close_cost(tables: ConstraintTables,
                state: ConstraintState) -> torch.Tensor:
    """(B,) fewest further tokens that reach a state where <eos> is legal
    (close every group and environment, discharge every obligation, finish
    a forced \\begin/\\end sequence, satisfy needs_tok)."""
    s = state.stack
    entry = ((s == _BRACE) | (s == _BRACE_ARG) | (s == _OWE)).to(torch.int32)
    entry = torch.where(s == _LEFT, 2, entry)        # \right + delimiter
    entry = torch.where(s >= _ENV_BASE, 4, entry)    # \end { name }
    slot = torch.arange(STACK_DEPTH, device=s.device)
    live = slot[None, :] < state.ptr[:, None]
    cost = torch.where(live, entry, 0).sum(dim=1, dtype=torch.int32)
    cost = cost + tables.mode_cost[state.mode.long()]
    return cost + state.needs_tok.to(torch.int32)


def step_mask(tables: ConstraintTables, state: ConstraintState, step,
              max_len: int) -> torch.Tensor:
    """(B, V) float32 additive logit mask (0 allowed, -1e30 not) for the
    token emitted at ``step`` (0-based: an int for the whole batch, or a
    (B, 1) tensor of per-row positions) of a ``max_len``-step decode."""
    c = tables.cls[None, :]                    # (1, V)
    top = _top(state)[:, None]                 # (B, 1)
    ptr = state.ptr[:, None]
    rem = max_len - 1 - step                   # steps left after this one
    owe = (top == _OWE).to(torch.int32)
    room = ptr < STACK_DEPTH - 2
    needs = state.needs_tok[:, None]

    # the token budget: the close cost AFTER the token must fit in the
    # steps left. Every emission clears needs_tok, so that term leaves the
    # base first. This keeps close_cost <= remaining + 1: a closing or
    # discharging token is always allowed (the mask never empties), and a
    # decode that runs to max_len still ends closed
    base = (_close_cost(tables, state)[:, None]
            - state.needs_tok.to(torch.int32)[:, None])

    allowed = (c == PLAIN) & (base - owe <= rem)
    allowed |= (c == OPEN) & room & (base + 1 <= rem)
    allowed |= ((c == CLOSE) & ((top == _BRACE) | (top == _BRACE_ARG))
                & (base - 1 <= rem))
    allowed |= (c == LEFT) & room & (base + 2 <= rem)
    allowed |= (c == RIGHT) & (top == _LEFT) & (base - 1 <= rem)
    allowed |= (c == ARG1) & room & (base - owe + 1 <= rem)
    allowed |= (c == ARG2) & room & (base - owe + 2 <= rem)
    allowed |= ((c == SUPSUB) & room & (base - owe + 1 <= rem)
                & (step > 0) & ~state.prev_supsub[:, None])
    if tables.has_env:
        allowed |= (c == BEGIN) & room & (base - owe + 7 <= rem)
        allowed |= (c == END) & (top >= _ENV_BASE) & (base - 1 <= rem)
    allowed |= (c == EOSC) & (ptr == 0) & ~needs

    # the forced modes override everything
    mode = state.mode[:, None]
    vocab_ids = torch.arange(tables.vocab_size, device=c.device)[None, :]
    allowed = (mode == 0) & allowed
    allowed |= ((mode == 1) | (mode == 4)) & (c == OPEN)
    allowed |= (mode == 2) & tables.nameable[None, :]
    allowed |= ((mode == 3) | (mode == 6)) & (c == CLOSE)
    allowed |= (mode == 5) & (vocab_ids == top - _ENV_BASE)
    return torch.where(allowed, 0.0, _NEG).to(torch.float32)


def advance(tables: ConstraintTables, state: ConstraintState,
            token) -> ConstraintState:
    """The pushdown state after emitting ``token`` ((B,) int). The mask
    never allows a token this cannot take; <eos> (also the <eos> fed to a
    finished row) leaves a row's state as it is."""
    c = tables.cls[token.long()]        # (B,)
    top = _top(state)
    ptr, stack, mode = state.ptr, state.stack, state.mode
    in_normal = mode == 0
    owe_top = in_normal & (top == _OWE)

    # NORMAL-mode pops: an obligation consumed, a group closed, \right
    pop1 = owe_top & ((c == PLAIN) | (c == ARG1) | (c == ARG2)
                      | (c == SUPSUB) | (c == BEGIN) | (c == OPEN))
    pop1 |= in_normal & (c == CLOSE) & ((top == _BRACE)
                                        | (top == _BRACE_ARG))
    pop1 |= in_normal & (c == RIGHT)
    n_pop = pop1.to(torch.int32)
    # an OPEN that consumes an OWE replaces it with _BRACE_ARG (pushed
    # below): the obligation is discharged when the group opens, and
    # _BRACE_ARG closes like a plain group

    # pushes, at the pointer after the pops
    push_entry = torch.full_like(ptr, _EMPTY)
    push_entry = torch.where(in_normal & (c == OPEN),
                             torch.where(owe_top, _BRACE_ARG, _BRACE),
                             push_entry)
    push_entry = torch.where(in_normal & (c == LEFT), _LEFT, push_entry)
    push_entry = torch.where(in_normal & ((c == ARG1) | (c == SUPSUB)),
                             _OWE, push_entry)
    push_entry = torch.where(in_normal & (c == ARG2), _OWE, push_entry)
    # mode 2: push the environment's name entry
    push_entry = torch.where(mode == 2, _ENV_BASE + token.to(torch.int32),
                             push_entry).to(torch.int32)
    n_push = (push_entry != _EMPTY).to(torch.int32)
    n_push = torch.where(in_normal & (c == ARG2), 2, n_push)
    # mode 5: pop the matched environment's entry
    n_pop = torch.where(mode == 5, 1, n_pop)

    base = ptr - n_pop
    # write up to 2 entries at [base, base + 1], the second over the first
    for k in (1, 2):
        at = (base + k - 1).clamp(0, STACK_DEPTH - 1).long()[:, None]
        stack = stack.scatter(1, at, torch.where(
            (n_push >= k)[:, None], push_entry[:, None], stack.gather(1, at)))
    new_ptr = base + n_push

    new_mode = torch.where(in_normal & (c == BEGIN), 1, 0)
    new_mode = torch.where(in_normal & (c == END), 4, new_mode)
    for before, after in ((1, 2), (2, 3), (4, 5), (5, 6)):
        new_mode = torch.where(mode == before, after, new_mode)
    # modes 3 and 6 emit '}' and return to NORMAL (new_mode is 0)

    noop = c == EOSC  # finished rows keep feeding <eos>: state frozen
    return ConstraintState(
        stack=torch.where(noop[:, None], state.stack, stack),
        ptr=torch.where(noop, state.ptr, new_ptr),
        mode=torch.where(noop, state.mode, new_mode.to(torch.int32)),
        needs_tok=torch.where(noop, state.needs_tok,
                              in_normal & (c == RIGHT)),
        prev_supsub=torch.where(noop, state.prev_supsub,
                                in_normal & (c == SUPSUB)))
