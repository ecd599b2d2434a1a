"""Faults planted under the timed path, to show that the check fails them:
by the CPU tests at tiny sizes, and by ``control.py --fault`` at a cell's
own size on the card. Each is a context manager that patches the program
and puts it back."""

from __future__ import annotations

from contextlib import contextmanager


@contextmanager
def one_request(prompt_len: int, after: int, vocab: int):
    """A token altered where the serving loop produces it, in part of one
    slot: every request whose prompt has ``prompt_len`` tokens (the longest
    of a mix whose blocks of requests repeat one set of lengths: one
    request a block) gets token ``t + 1`` for each served token ``t`` from
    its ``after``-th on."""
    from llm_mixed_q_torch.models.llama.serving import ContinuousBatcher

    real = ContinuousBatcher._emit

    def emit(self, slot, tok):
        served = len(self._emitted[self._req[slot]])
        # the host position of a slot runs its prompt's length ahead of what it served
        if self._pos_host[slot] - served == prompt_len and served >= after:
            tok = (tok + 1) % vocab
        return real(self, slot, tok)

    ContinuousBatcher._emit = emit
    try:
        yield
    finally:
        ContinuousBatcher._emit = real
