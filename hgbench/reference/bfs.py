"""Hypergraph BFS in numpy.

A hop goes from each frontier atom to the links that hold it as a target,
then to every target of those links. The reach set holds the seed and
every atom reached within the hops; the edge total is the sum, over the
frontier of every hop, of each atom's incidence degree: the number of
distinct links that hold it as a target.

:func:`bfs` states that for one seed, an atom set at a time. :func:`lanes`
runs up to 64 seeds a pass, one bit of a ``uint64`` word an atom for each
seed: a hop is one OR-reduction over the target lists and one over the
incidence lists, whatever the frontiers hold, so a run can check some
hundreds of lanes of a 10M-atom graph in seconds.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass

import numpy as np

#: seeds a pass: the bits of one word an atom
WORD = 64


class Graph:
    """Target lists as CSR (``tgt_offsets`` over all ``n_atoms`` ids,
    ``tgt_flat``) and the incidence lists built from them here, each atom's
    links ascending, a link held twice by one atom counted once."""

    def __init__(self, tgt_offsets: np.ndarray, tgt_flat: np.ndarray,
                 n_atoms: int):
        self.n = n = int(n_atoms)
        self.tgt_off = np.asarray(tgt_offsets, dtype=np.int64)[: n + 1]
        self.tgt = np.asarray(tgt_flat)[: self.tgt_off[-1]]
        arity = np.diff(self.tgt_off)
        owner = np.repeat(np.arange(n, dtype=np.int64), arity)
        key = self.tgt.astype(np.int64) * n + owner
        key.sort()
        keep = np.ones(len(key), dtype=bool)
        keep[1:] = key[1:] != key[:-1]
        atom, link = np.divmod(key[keep], n)
        self.inc = link
        self.inc_off = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(np.bincount(atom, minlength=n), out=self.inc_off[1:])
        self.deg = np.diff(self.inc_off)
        # the segments a hop reduces over: links with targets, atoms with
        # links (an empty segment has no place in ``reduceat``)
        self.links = np.flatnonzero(arity)
        self.atoms = np.flatnonzero(self.deg)


def _ragged(flat: np.ndarray, off: np.ndarray, rows: np.ndarray
            ) -> np.ndarray:
    starts, ends = off[rows], off[rows + 1]
    lens = ends - starts
    total = int(lens.sum())
    if total == 0:
        return flat[:0]
    idx = np.repeat(starts - np.concatenate([[0], np.cumsum(lens)[:-1]]),
                    lens) + np.arange(total)
    return flat[idx]


def bfs(g: Graph, seed: int, hops: int) -> tuple[np.ndarray, int]:
    """(sorted reach set, edge total) of one seed."""
    seen = np.zeros(g.n, dtype=bool)
    seen[seed] = True
    frontier = np.asarray([seed], dtype=np.int64)
    edges = 0
    for _ in range(hops):
        edges += int(g.deg[frontier].sum())
        on = np.zeros(g.n, dtype=bool)
        on[_ragged(g.inc, g.inc_off, frontier)] = True
        reached = np.zeros(g.n, dtype=bool)
        reached[_ragged(g.tgt, g.tgt_off, np.flatnonzero(on))] = True
        reached &= ~seen
        frontier = np.flatnonzero(reached)
        seen |= reached
    return np.flatnonzero(seen), edges


def hop(g: Graph, words: np.ndarray) -> np.ndarray:
    """Every atom one hop from the frontier ``words``, each seed's bit
    apart: a link's word is the OR of its targets', an atom's the OR of
    its links'."""
    link = np.zeros(g.n, dtype=np.uint64)
    if len(g.links):
        link[g.links] = np.bitwise_or.reduceat(words[g.tgt],
                                               g.tgt_off[g.links])
    out = np.zeros(g.n, dtype=np.uint64)
    if len(g.atoms):
        out[g.atoms] = np.bitwise_or.reduceat(link[g.inc],
                                              g.inc_off[g.atoms])
    return out


def lane_sums(words: np.ndarray, weights, m: int) -> np.ndarray:
    """For each seed bit ``j < m``: the sum of ``weights`` over the atoms
    whose word has bit ``j`` (their count where ``weights`` is None), exact
    in int64. One weighted histogram of each byte of the words, then each
    bit's byte values summed."""
    b = words.view(np.uint8).reshape(-1, 8)
    vals = np.arange(256)
    out = np.zeros(m, dtype=np.int64)
    for p in range(-(-m // 8)):
        h = np.bincount(b[:, p], weights=weights, minlength=256)
        for q in range(min(8, m - 8 * p)):
            out[8 * p + q] = int(round(float(h[(vals >> q) & 1 == 1].sum())))
    return out


@dataclass
class Lanes:
    """The answers of many seeds: reach counts and edge totals a seed, and
    a pass's reach sets as words (``seen[i // 64]`` bit ``i % 64``)."""

    counts: np.ndarray
    edges: np.ndarray
    seen: list

    def reach_set(self, i: int) -> np.ndarray:
        """The sorted reach set of seed ``i``."""
        w = self.seen[i // WORD]
        return np.flatnonzero((w >> np.uint64(i % WORD)) & np.uint64(1))


def seed_words(n: int, seeds) -> np.ndarray:
    """The words of a pass whose seed ``j`` holds bit ``j`` at its atom."""
    words = np.zeros(n, dtype=np.uint64)
    bits = np.left_shift(np.uint64(1), np.arange(len(seeds), dtype=np.uint64))
    np.bitwise_or.at(words, np.asarray(seeds, dtype=np.int64), bits)
    return words


def _pass(g: Graph, seeds, hops: int, edge_sums) -> tuple:
    m = len(seeds)
    frontier = seed_words(g.n, seeds)
    seen = frontier.copy()
    weights = g.deg.astype(np.float64)
    edges = None
    for _ in range(hops):
        e = edge_sums(frontier, weights, m)
        edges = e if edges is None else edges + e
        frontier = hop(g, frontier) & ~seen
        seen |= frontier
    edges = (np.zeros(m, dtype=np.int64) if edges is None
             else edges.astype(np.int64))
    return lane_sums(seen, None, m), edges, seen


def lanes(g: Graph, seeds, hops: int, edge_sums=lane_sums) -> Lanes:
    """The answers of every seed, 64 a pass, the passes on a thread a core
    (numpy leaves the interpreter lock in its reductions). ``edge_sums``
    sums a pass's degrees a seed, each hop's (:func:`lane_sums`: exact);
    the hops' sums are added in the type it returns."""
    seeds = np.asarray(seeds, dtype=np.int64)
    parts = [seeds[i : i + WORD] for i in range(0, len(seeds), WORD)]
    with ThreadPoolExecutor(max(1, min(8, os.cpu_count() or 1))) as ex:
        done = list(ex.map(lambda s: _pass(g, s, hops, edge_sums), parts))
    if not done:
        return Lanes(np.zeros(0, np.int64), np.zeros(0, np.int64), [])
    return Lanes(np.concatenate([d[0] for d in done]),
                 np.concatenate([d[1] for d in done]),
                 [d[2] for d in done])


def answer(tables: dict, seeds, hops: int) -> Lanes:
    """The reference's answers over drawn tables (``tgt_offsets``,
    ``tgt_flat``, ``n_atoms``)."""
    g = Graph(tables["tgt_offsets"], tables["tgt_flat"], tables["n_atoms"])
    return lanes(g, seeds, hops)
