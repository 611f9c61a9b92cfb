"""Plain reference of the row-crop path enumeration (a frozen copy of the
plain version the port's native enumerator is held equal to).

From the robot's pose: runs along the current crop row in both
directions, every prefix a path, a switch to the next or previous row at
either headland column, at most `max_turns` switches, all within the
budget; paths are deduplicated by (end, length, cost), the ones using at
least `min_cost_frac` of the budget preferred, the longest first (ties by
node sequence), and each is thinned to at most `k_max` evenly spaced
sample sites (the pose itself excluded).
"""

from __future__ import annotations

import numpy as np


def _row_segments(nr, nc, cs, rs, start, budget, max_turns):
    def switch_rows(seq, cost, turns, r, c):
        for dr in (-1, 1):
            rr = r + dr
            if 0 <= rr < nr and cost + rs <= budget:
                nxt = rr * nc + c
                if nxt not in seq:
                    yield seq + [nxt], cost + rs
                    yield from extend(seq + [nxt], cost + rs, turns - 1)

    def extend(seq, cost, turns):
        r, c = divmod(seq[-1], nc)
        for direction in (-1, 1):
            run = []
            cc, acc = c, cost
            while 0 <= cc + direction < nc and acc + cs <= budget:
                cc += direction
                acc += cs
                run.append(r * nc + cc)
                yield seq + list(run), acc
                if turns > 0 and cc in (0, nc - 1):
                    yield from switch_rows(seq + list(run), acc, turns, r, cc)
        if turns > 0 and c in (0, nc - 1):
            yield from switch_rows(seq, cost, turns, r, c)

    yield from extend([start], 0.0, max_turns)


def enumerate_paths(nr, nc, cs, rs, start, budget, *, max_paths=256, max_turns=2,
                    min_cost_frac=0.5):
    """[(node_seq, cost)], free mode (no goal)."""
    found, seen = [], set()
    for seq, cost in _row_segments(nr, nc, cs, rs, int(start), float(budget), max_turns):
        key = (seq[-1], len(seq), round(cost, 6))
        if key in seen:
            continue
        seen.add(key)
        found.append((seq, cost))
        if len(found) >= max_paths * 8:
            break
    good = [p for p in found if p[1] >= min_cost_frac * budget] or found
    good.sort(key=lambda p: (-p[1], p[0]))
    return good[:max_paths]


def thin(paths, k_max):
    """(sets (P, k_max) int64 padded with 0, sizes (P,), costs (P,) f32)."""
    P = len(paths)
    sets = np.zeros((P, k_max), np.int64)
    sizes = np.zeros((P,), np.int64)
    costs = np.zeros((P,), np.float32)
    for p, (seq, cost) in enumerate(paths):
        nodes = seq[1:] if len(seq) > 1 else seq
        if len(nodes) > k_max:
            pick = np.unique(np.linspace(0, len(nodes) - 1, k_max).round().astype(int))
            nodes = [nodes[i] for i in pick]
        sets[p, :len(nodes)] = nodes
        sizes[p] = len(nodes)
        costs[p] = cost
    return sets, sizes, costs
