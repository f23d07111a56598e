"""Chaitin-style balanced graph coloring — paper §4.2 phase 3.

O(n + e) simplify/select with *balanced* color choice (colors used equally
often), exactly the property the paper relies on for balanced bank
assignment.  No spill code is ever produced: when a node cannot be colored
(clique bigger than k), it receives the least-loaded color among its
neighbours' colors and the residual conflict is reported, mirroring the
paper's "minimal remaining conflicts" behaviour.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass
class Coloring:
    colors: dict[int, int]
    num_colors: int
    uncolorable: set[int]  # nodes that had to share a color with a neighbor

    def conflicts(self, adj: dict[int, set[int]]) -> int:
        bad = 0
        for u, nbrs in adj.items():
            for v in nbrs:
                if u < v and self.colors[u] == self.colors[v]:
                    bad += 1
        return bad


def chaitin_color(adj: dict[int, set[int]], k: int) -> Coloring:
    nodes = list(adj)
    degree = {n: len(adj[n]) for n in nodes}
    removed: set[int] = set()
    stack: list[int] = []

    work = sorted(nodes, key=lambda n: (degree[n], n))
    while len(stack) < len(nodes):
        pick = None
        for n in sorted(nodes, key=lambda n: (degree[n], n)):
            if n not in removed and degree[n] < k:
                pick = n
                break
        if pick is None:
            # optimistic: push the max-degree node and hope neighbours share colors
            pick = max((n for n in nodes if n not in removed),
                       key=lambda n: (degree[n], -n))
        removed.add(pick)
        stack.append(pick)
        for v in adj[pick]:
            if v not in removed:
                degree[v] -= 1

    colors: dict[int, int] = {}
    usage = [0] * max(k, 1)
    uncolorable: set[int] = set()
    while stack:
        n = stack.pop()
        taken = {colors[v] for v in adj[n] if v in colors}
        free = [c for c in range(k) if c not in taken]
        if free:
            c = min(free, key=lambda c: (usage[c], c))  # balanced choice
        else:
            c = min(range(k), key=lambda c: (usage[c], c))
            uncolorable.add(n)
        colors[n] = c
        usage[c] += 1
    return Coloring(colors=colors, num_colors=k, uncolorable=uncolorable)
