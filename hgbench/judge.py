"""The comparisons that decide ``correct``: one function an answer kind,
called by the runners on the program's answers and by the controls on the
answers of the reference with a guarantee broken, so that a control comes
out not correct through the same code a run does. Each returns
``(name, number compared, limit)`` triples; every limit is 0, since each
number counts answers that differ from the reference's."""

from __future__ import annotations

import numpy as np


def lanes(counts, edges, want_counts, want_edges) -> list:
    """Batched BFS lanes: a lane is wrong where its reach count or its edge
    total differs from the reference's."""
    wrong = ((np.asarray(counts, dtype=np.int64)
              != np.asarray(want_counts, dtype=np.int64))
             | (np.asarray(edges, dtype=np.int64)
                != np.asarray(want_edges, dtype=np.int64)))
    return [("lanes_wrong", int(wrong.sum()), 0)]


def reach_sets(words: np.ndarray, want_words: np.ndarray) -> list:
    """Whole reach sets, 64 lanes as the bits of one ``uint64`` word an
    atom: a lane is wrong where any atom's bit differs."""
    diff = np.bitwise_or.reduce(np.bitwise_xor(words, want_words))
    return [("reach_sets_wrong", int(diff).bit_count(), 0)]


def answers(got: list, want_sets: list, top_r: int) -> list:
    """Served BFS answers ``(count, truncated, matches)`` against the
    reference's sorted reach sets: the count, whether the reach passes
    ``top_r``, and the ``top_r`` smallest handles."""
    wrong = 0
    for (count, truncated, matches), want in zip(got, want_sets,
                                                 strict=True):
        want = np.asarray(want, dtype=np.int64)
        wrong += (count != len(want) or truncated != (len(want) > top_r)
                  or not np.array_equal(np.asarray(matches, np.int64),
                                        want[:top_r]))
    return [("answers_wrong", int(wrong), 0)]


def outcomes(errors: int, never_came: int) -> list:
    """Requests of a served window that failed, or never came within the
    wait past its close."""
    return [("errors", int(errors), 0), ("never_came", int(never_came), 0)]


def served_as(want_sets: list, top_r: int) -> list:
    """Reach sets as the program answers them: the reference, or the
    reference with a guarantee broken, put in the program's place."""
    return [(len(s), len(s) > top_r, np.asarray(s, np.int64)[:top_r])
            for s in want_sets]
