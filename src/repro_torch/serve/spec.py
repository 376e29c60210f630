"""Host-side draft proposal + acceptance for speculative decoding (port of
``repro.serve.spec``, pure Python, carried over verbatim).

Speculative decoding on the paged backend needs no second model: the
drafter is **prompt lookup** (n-gram matching over the request's own
prompt + generated tokens). Each iteration it proposes up to ``k``
candidate continuations per running slot; the backend scores all
``k + 1`` positions (the last committed token plus the drafts) in one
small-q verify dispatch, and :func:`accept_tokens` commits the longest
prefix where the drafts agree with the model's own choices — plus the
"bonus" token the model produced after the last agreeing draft.

Acceptance is exact, not approximate: the chosen token at verify row
``j`` depends only on the committed prefix through position ``j`` (the
kernel masks by per-row effective length, and sampled rows key their
PRNG by absolute output index), so the committed stream is
token-identical to the non-speculative engine — for greedy *and*
per-position-keyed sampled requests alike. A draft mismatch costs
nothing but the wasted verify columns; rejected K/V is rolled back at
block granularity by the allocator.
"""

from __future__ import annotations

from typing import List, Sequence

# draft methods EngineConfig.spec_method accepts (re-exported by config)
SPEC_METHODS = ("ngram",)


def ngram_propose(tokens: Sequence[int], k: int, *, max_n: int = 3,
                  min_n: int = 1) -> List[int]:
    """Prompt-lookup drafting: propose up to ``k`` tokens continuing
    ``tokens`` by matching its trailing n-gram earlier in the sequence.

    Tries pattern sizes from ``max_n`` down to ``min_n``; within a size,
    the *most recent* earlier occurrence with a full ``k``-token
    continuation wins (recency tracks the local repetition structure that
    makes lookup drafting pay off). Matches near the tail have their
    continuation truncated by the sequence end — on periodic text (the
    very case lookup drafting exists for) the most recent match is
    *always* flush against the tail, so when no occurrence yields ``k``
    tokens the longest truncated continuation is returned instead of the
    most recent one. Returns ``[]`` when nothing matches — an
    O(len · max_n) host-side scan, no device work.
    """
    if k <= 0:
        return []
    toks = [int(t) for t in tokens]
    n = len(toks)
    for size in range(min(max_n, n - 1), max(min_n, 1) - 1, -1):
        pattern = toks[n - size:]
        best: List[int] = []
        for i in range(n - size - 1, -1, -1):
            if toks[i:i + size] == pattern:
                cont = toks[i + size:i + size + k]
                if len(cont) == k:
                    return cont
                if len(cont) > len(best):
                    best = cont
        if best:
            return best
    return []


def accept_tokens(draft: Sequence[int], chosen: Sequence[int]) -> List[int]:
    """Greedy acceptance: longest agreeing draft prefix plus the bonus.

    ``draft`` is the ``m`` proposed tokens ``d_1..d_m``; ``chosen`` is the
    ``m + 1`` model choices ``o_0..o_m`` from the verify dispatch (row
    ``j``'s pick after consuming the last committed token and drafts
    ``d_1..d_j``). ``o_0`` is always committed — it is exactly the plain
    decode step's token. Each agreeing draft ``d_{j+1} == o_j`` commits
    the next choice ``o_{j+1}``; the first disagreement stops the scan.
    Returns 1..m+1 committed tokens.
    """
    if len(chosen) != len(draft) + 1:
        raise ValueError(
            f"chosen must have len(draft) + 1 entries, got {len(chosen)} "
            f"for {len(draft)} drafts")
    committed = [int(chosen[0])]
    for j, d in enumerate(draft):
        if int(d) != int(chosen[j]):
            break
        committed.append(int(chosen[j + 1]))
    return committed
