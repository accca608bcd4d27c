"""Faults planted in the timed path, to show that ``correct`` catches them.
Each takes the entry's system before its window and breaks the decode
engine's ``decode_tokens`` underneath the batcher, where the answers are
produced."""

from __future__ import annotations


def _wrap_decode(system, alter) -> None:
    inner = system.engine.decode_tokens

    def decode_tokens(images, beam_size=None):
        res = inner(images, beam_size)
        return res._replace(tokens=alter(res.tokens.clone()))

    system.engine.decode_tokens = decode_tokens


def altered_token(system) -> None:
    """Each decode's first token of its first row becomes the next
    ordinary token (ids 4 on are the vocabulary's symbols)."""
    def alter(tokens):
        t = int(tokens[0, 0])
        tokens[0, 0] = 4 + (t - 4 + 1) % 130
        return tokens

    _wrap_decode(system, alter)


def half_batch(system) -> None:
    """The second half of each decode's rows is answered with the first
    half's tokens: half of the batch left out."""
    def alter(tokens):
        half = tokens.shape[0] // 2
        if half:
            tokens[half:2 * half] = tokens[:half]
        return tokens

    _wrap_decode(system, alter)


FAULTS = {"token": altered_token, "half": half_batch}
