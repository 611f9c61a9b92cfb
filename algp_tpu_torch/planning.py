"""Informative-path planning over the row-structured field, on the host
(the counterpart of algp_tpu.planning).

Budgeted boustrophedon paths are enumerated from the robot's pose (runs
along a crop row, row switches at the two headlands), and each path is
thinned to at most `k_max` sample sites: a padded index batch
(num_paths, k_max) with sizes and costs, which the acquisition layer
scores in one batched call.  The engine is the native enumerator
(`native/pathenum.c`); `_enumerate_paths_python` is its plain version,
which the tests hold it equal to.

`build_field_graph` gives the same traversal graph as a networkx graph;
networkx is imported only inside it (nothing on the episode path uses it).
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Optional

import numpy as np

from algp_tpu_torch import native


@dataclasses.dataclass
class PathBatch:
    """Device-ready batch of candidate paths.

    node_seqs : list of full node sequences (host bookkeeping / traversal)
    sets      : (P, k_max) int32 — sample-set indices, padded with 0
    sizes     : (P,) int32 — true set sizes
    costs     : (P,) float32 — path traversal costs
    ends      : (P,) int32 — final pose (grid index) of each path
    """

    node_seqs: list
    sets: np.ndarray
    sizes: np.ndarray
    costs: np.ndarray
    ends: np.ndarray

    def __len__(self):
        return len(self.node_seqs)


def build_field_graph(env):
    """Row-crop traversal graph (a `networkx.Graph`): along-row edges
    everywhere, between-row edges only at the two headland columns
    (col 0 and col num_cols-1), weighted by the spacings."""
    try:
        import networkx as nx
    except ImportError as e:
        raise ImportError(
            "planning.build_field_graph needs networkx, which is not installed "
            "(the episode's planning does not)"
        ) from e
    g = nx.Graph()
    nr, nc = env.num_rows, env.num_cols
    cs, rs = env.cfg.col_spacing, env.cfg.row_spacing
    for r in range(nr):
        for c in range(nc):
            i = r * nc + c
            g.add_node(i)
            if c + 1 < nc:
                g.add_edge(i, i + 1, weight=cs)
    for r in range(nr - 1):
        for c in (0, nc - 1):
            g.add_edge(r * nc + c, (r + 1) * nc + c, weight=rs)
    return g


def _row_segments(env, start: int, budget: float, max_turns: int):
    """Enumerate boustrophedon-style paths: runs along the current row,
    optional headland switch, runs along the next row, … up to `max_turns`
    row changes, pruned by budget.  Yields (node_seq, cost).

    Deterministic enumeration order (row deltas ascending, direction
    left-before-right).
    """
    nc = env.num_cols
    cs, rs = env.cfg.col_spacing, env.cfg.row_spacing

    def switch_rows(seq: list, cost: float, turns: int, r: int, c: int):
        """Headland row switches from the current end of `seq`."""
        for dr in (-1, 1):
            rr = r + dr
            if 0 <= rr < env.num_rows and cost + rs <= budget:
                nxt = rr * nc + c
                if nxt not in seq:
                    yield seq + [nxt], cost + rs
                    yield from extend(seq + [nxt], cost + rs, turns - 1)

    def extend(seq: list, cost: float, turns: int) -> Iterator:
        node = seq[-1]
        r, c = divmod(node, nc)
        # runs along the row in both directions; every prefix is a path
        for direction in (-1, 1):
            run: list = []
            cc, acc = c, cost
            while 0 <= cc + direction < nc and acc + cs <= budget:
                cc += direction
                acc += cs
                run.append(r * nc + cc)
                yield seq + list(run), acc
                # reached a headland mid-path → may switch rows and go on
                if turns > 0 and cc in (0, nc - 1):
                    yield from switch_rows(seq + list(run), acc, turns, r, cc)
        # already standing at a headland → may switch immediately
        if turns > 0 and c in (0, nc - 1):
            yield from switch_rows(seq, cost, turns, r, c)

    yield from extend([start], 0.0, max_turns)


def _enumerate_paths_python(
    env, start: int, budget: float, *, goal: Optional[int] = None,
    max_paths: int = 256, max_turns: int = 2, min_cost_frac: float = 0.5,
) -> list[tuple[list[int], float]]:
    """The plain enumerator: `enumerate_paths` in Python."""
    all_paths = []
    seen = set()
    for seq, cost in _row_segments(env, start, budget, max_turns):
        if goal is not None and seq[-1] != goal:
            continue
        key = (seq[-1], len(seq), round(cost, 6))
        if goal is not None and len(seq) > 1:
            # with the end pinned to the goal, distinct routes share
            # (len, cost) on a uniform grid — two interior route nodes
            # keep them apart
            key = key + (seq[1], seq[len(seq) // 2])
        if key in seen:
            continue
        seen.add(key)
        all_paths.append((seq, cost))
        if len(all_paths) >= max_paths * 8:
            break
    if goal is None:
        good = [p for p in all_paths if p[1] >= min_cost_frac * budget]
        if not good:
            good = all_paths
    else:
        good = all_paths
    # prefer long informative paths; deterministic tie-break on node seq
    good.sort(key=lambda p: (-p[1], p[0]))
    return good[:max_paths]


def enumerate_paths(
    env, start: int, budget: float, *, goal: Optional[int] = None,
    max_paths: int = 256, max_turns: int = 2, min_cost_frac: float = 0.5,
) -> list[tuple[list[int], float]]:
    """Budgeted path enumeration from the current pose, as
    [(node_seq, cost)].

    `goal=None` (free mode) prefers paths that use at least
    `min_cost_frac` of the budget and falls back to everything enumerated
    if none qualify.  `goal=<node>` keeps only paths ending at the goal
    (min_cost_frac is ignored; empty = unreachable within the budget).
    Deterministic: stable enumeration order, longest first, ties broken
    by node sequence.  Runs the native enumerator."""
    return native.enumerate_paths_native(
        env.num_rows, env.num_cols,
        float(env.cfg.col_spacing), float(env.cfg.row_spacing),
        int(start), float(budget), max_paths, max_turns, min_cost_frac,
        goal=-1 if goal is None else int(goal),
    )


def paths_to_batch(
    env, paths: list[tuple[list[int], float]], *, k_max: int = 10,
) -> PathBatch:
    """Expand enumerated paths into the padded sample-set batch: each
    path's node sequence (without the current pose) thinned uniformly to
    at most `k_max` sites."""
    P = len(paths)
    sets = np.zeros((P, k_max), np.int32)
    sizes = np.zeros((P,), np.int32)
    costs = np.zeros((P,), np.float32)
    ends = np.zeros((P,), np.int32)
    seqs = []
    for p, (seq, cost) in enumerate(paths):
        nodes = seq[1:] if len(seq) > 1 else seq  # exclude current pose
        if len(nodes) > k_max:
            pick = np.linspace(0, len(nodes) - 1, k_max).round().astype(int)
            pick = np.unique(pick)
            nodes = [nodes[i] for i in pick]
        sets[p, : len(nodes)] = nodes
        sizes[p] = len(nodes)
        costs[p] = cost
        ends[p] = seq[-1]
        seqs.append(seq)
    return PathBatch(node_seqs=seqs, sets=sets, sizes=sizes, costs=costs, ends=ends)


def enumerate_batch(
    env, start: int, budget: float, *, goal: Optional[int] = None,
    max_paths: int = 256, k_max: int = 10, max_turns: int = 2,
    min_cost_frac: float = 0.5,
) -> PathBatch:
    """`enumerate_paths` + `paths_to_batch` in one native call — the
    episode's per-step entry.  The C code thins with the same arithmetic
    as `paths_to_batch`, so the batch is equal either way; the node
    sequences stay numpy views over the enumerator's buffer."""
    all_nodes, offs, lens, costs_d, P, sets, sizes, ends = native.enumerate_paths_raw(
        env.num_rows, env.num_cols,
        float(env.cfg.col_spacing), float(env.cfg.row_spacing),
        int(start), float(budget), max_paths, max_turns, min_cost_frac,
        k_max=k_max, goal=-1 if goal is None else int(goal),
    )
    seqs = [all_nodes[offs[p]: offs[p] + lens[p]] for p in range(P)]
    return PathBatch(node_seqs=seqs, sets=sets[:P], sizes=sizes[:P],
                     costs=costs_d[:P].astype(np.float32), ends=ends[:P])


def boustrophedon_order(env) -> np.ndarray:
    """Full-coverage serpentine sweep order (the naive baseline)."""
    order = []
    for r in range(env.num_rows):
        cols = range(env.num_cols) if r % 2 == 0 else range(env.num_cols - 1, -1, -1)
        order.extend(r * env.num_cols + c for c in cols)
    return np.asarray(order, np.int64)
