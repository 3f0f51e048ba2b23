"""Draft-token proposers for speculative decoding (DESIGN.md §11).

The serving backend asks a :class:`Drafter` for up to ``k`` candidate
continuation tokens per lane each verify step; the verification forward
scores all of them (plus the mandatory next token) in one device call and
keeps the longest matching prefix.  Drafters must be pure functions of
the visible token history — determinism is what lets spec-on streams stay
byte-identical to spec-off: a drafter never *chooses* tokens, it only
guesses what the target model will emit, and every emitted token is still
the target model's own sample at that position.

``NgramDrafter`` is prompt-lookup decoding (no second model): find the
longest recent n-gram suffix match in the request's prompt + generated
history and propose the tokens that followed it.  LLM output is
self-repetitious (code, structured text, our reduced models' short
cycles), so this is cheap and surprisingly accurate; a learned draft
model can slot in behind the same protocol later.
"""

from __future__ import annotations

from typing import List, Protocol, Sequence


class Drafter(Protocol):
    def propose(self, tokens: Sequence[int], k: int) -> List[int]:
        """Up to ``k`` draft continuations of ``tokens`` (may return
        fewer, including none — the verify step then degenerates toward a
        plain decode step).  Must be deterministic in ``tokens``."""
        ...


class NgramDrafter:
    """Prompt-lookup drafter: longest suffix match of length <= ``nmax``
    against the history itself, proposing the tokens that followed the
    most recent earlier occurrence.

    ``nmin`` floors the match length (default 2): a unigram match is
    mostly noise, and a rejected window is not free — the verifier spends
    a whole multi-token forward to emit one token — so precision beats
    recall here.  Set ``nmin=1`` to recover the greedy fallback."""

    def __init__(self, nmax: int = 3, nmin: int = 2):
        self.nmax = nmax
        self.nmin = max(int(nmin), 1)

    def propose(self, tokens: Sequence[int], k: int) -> List[int]:
        toks = list(tokens)
        L = len(toks)
        if k <= 0 or L < 2:
            return []
        for n in range(min(self.nmax, L - 1), self.nmin - 1, -1):
            suf = tuple(toks[-n:])
            # most recent occurrence strictly before the suffix itself
            for j in range(L - n - 1, -1, -1):
                if tuple(toks[j:j + n]) == suf:
                    return toks[j + n:j + n + k]
        return []


class NullDrafter:
    """Proposes nothing — spec steps degrade to plain decode.  Useful to
    isolate verification-path overhead in benchmarks."""

    def propose(self, tokens: Sequence[int], k: int) -> List[int]:
        return []
