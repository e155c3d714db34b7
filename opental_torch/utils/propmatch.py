"""Tie-robust pairing of two proposal lists that should be equal up to
float noise; the port's copy of `opental_tpu/utils/propmatch.py`.

Two compute paths of the same math (a mesh against one device, packed
against per video) give scores that differ in the last ulp. Sorting
both lists by (class, -score) and zipping pairs crosswise where two
proposals' scores tie within that noise; within such runs both sides
re-sort by segment, which is stable across paths (two different
proposals differ at stride scale).
"""

from typing import Any, Dict, Iterable, List, Tuple

Proposal = Dict[str, Any]


def pair_proposals(want: Iterable[Proposal], got: Iterable[Proposal],
                   score_tol: float = 1e-5, cls_key: str = 'cls'
                   ) -> List[Tuple[Proposal, Proposal]]:
    """Pair two equal-length proposal lists for comparison: both sorted
    by (class, -score), runs of `want` of one class whose consecutive
    score gaps are <= score_tol re-sorted by segment on both sides.
    `cls_key` names the class field ('cls' in the pipeline's proposals,
    'label' in the detection JSON). Callers hold each pair's class,
    score and segment."""
    want, got = list(want), list(got)
    if len(want) != len(got):
        raise AssertionError(f'{len(want)} proposals against {len(got)}')
    key = lambda p: (p[cls_key], -p['score'])  # noqa: E731
    segkey = lambda p: tuple(p['segment'])     # noqa: E731
    want = sorted(want, key=key)
    got = sorted(got, key=key)
    pairs: List[Tuple[Proposal, Proposal]] = []
    i, n = 0, len(want)
    while i < n:
        j = i + 1
        while (j < n and want[j][cls_key] == want[i][cls_key]
               and want[j - 1]['score'] - want[j]['score'] <= score_tol):
            j += 1
        pairs.extend(zip(sorted(want[i:j], key=segkey),
                         sorted(got[i:j], key=segkey)))
        i = j
    return pairs
