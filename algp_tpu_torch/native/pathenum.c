/* Native budgeted boustrophedon path enumeration (SURVEY.md §2 C11).
 *
 * The port's own copy of algp_tpu/native/pathenum.c, unchanged in
 * behaviour.  Exact-semantics C implementation of the Python enumerator
 * in algp_tpu_torch/planning.py (`_enumerate_paths_python`, the plain
 * version; see `enumerate_paths` for the algorithm contract):
 *   - identical enumeration order (row runs left-before-right, headland
 *     switches row-delta -1 before +1, mid-run switches after the prefix
 *     yield, standing-at-headland switches after both direction runs),
 *   - identical dedup key (end node, length, cost rounded to 1e-6 by
 *     correctly-rounded decimal printing, matching Python round()),
 *   - identical harvest cap (max_paths * 8 KEPT candidates),
 *   - identical min_cost_frac filter + (-cost, lexicographic node
 *     sequence) ordering and max_paths truncation.
 *
 * Why native: the Python generator materialises a list per yielded
 * prefix (O(run²) list churn — measured 15-23 ms per planning step at
 * the 1M-point grid, the largest HOST cost of a plain plan).  This
 * enumerator keeps one node arena + offsets and fills the caller's
 * buffers directly (<1 ms).  Equality with the Python reference is
 * pinned by tests/test_torch_planning.py over a geometry sweep.
 */

#include <math.h>
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

/* CPython round(x, 6) is CORRECTLY-rounded decimal (ties-to-even on the
 * decimal digit), which naive llrint(x * 1e6) does not reproduce when
 * the scaling multiply lands on a binary boundary.  glibc's printf is
 * also correctly rounded, so print-and-parse reproduces Python exactly
 * for the cost magnitudes here (< 1e12). */
static int64_t round6_micro(double cost) {
    char buf[64];
    snprintf(buf, sizeof buf, "%.6f", cost);
    int64_t v = 0, sign = 1;
    for (const char *p = buf; *p; p++) {
        if (*p == '-') sign = -1;
        else if (*p >= '0' && *p <= '9') v = v * 10 + (*p - '0');
    }
    return sign * v;
}

typedef struct {
    int32_t *arena;      /* concatenated node sequences */
    int64_t arena_len, arena_cap;
    int64_t *off;        /* candidate -> arena offset */
    int32_t *len;        /* candidate -> sequence length */
    double *cost;        /* candidate -> traversal cost */
    int64_t n, cap;      /* kept candidates */
} paths_t;

typedef struct {
    /* open-addressing set of (end, len, cost_micro[, route]) tuples */
    int64_t *end_len;    /* packed: end * 2^20 + len  (-1 = empty) */
    int64_t *cost_micro;
    int64_t *route;      /* goal mode only: packed interior nodes */
    int64_t cap, n;
} seen_t;

static int seen_init(seen_t *s, int64_t cap) {
    s->cap = cap; s->n = 0;
    s->end_len = malloc(sizeof(int64_t) * cap);
    s->cost_micro = malloc(sizeof(int64_t) * cap);
    s->route = malloc(sizeof(int64_t) * cap);
    if (!s->end_len || !s->cost_micro || !s->route) return -1;
    for (int64_t i = 0; i < cap; i++) s->end_len[i] = -1;
    return 0;
}

/* returns 1 if newly inserted, 0 if already present */
static int seen_add(seen_t *s, int64_t end, int64_t length, int64_t cmicro,
                    int64_t route) {
    int64_t key = end * 1048576 + length;
    uint64_t h = (uint64_t)key * 0x9E3779B97F4A7C15ull
               ^ (uint64_t)cmicro * 0xC2B2AE3D27D4EB4Full
               ^ (uint64_t)route * 0xD6E8FEB86659FD93ull;
    uint64_t i = h % (uint64_t)s->cap;
    while (s->end_len[i] != -1) {
        if (s->end_len[i] == key && s->cost_micro[i] == cmicro
            && s->route[i] == route) return 0;
        i = (i + 1) % (uint64_t)s->cap;
    }
    s->end_len[i] = key;
    s->cost_micro[i] = cmicro;
    s->route[i] = route;
    s->n++;
    return 1;
}

typedef struct {
    int nr, nc, max_turns;
    int goal;              /* required end node; -1 = unconstrained */
    double cs, rs, budget;
    int64_t harvest_cap;   /* max_paths * 8 */
    paths_t out;
    seen_t seen;
    int32_t *stack;        /* current node sequence (working path) */
    int32_t depth;
    int done, oom;
} ctx_t;

static int emit(ctx_t *g, double cost) {
    /* goal-conditioned enumeration (SURVEY C11 "between current pose
     * and goal"): only paths ENDING at the goal are candidates; the
     * recursion still explores through, exactly as the Python filter */
    int32_t end = g->stack[g->depth - 1];
    if (g->goal >= 0 && end != g->goal) return 0;
    /* dedup on (end, len, round(cost, 6)); keep a copy if fresh.
     * Goal mode extends the key with two interior route nodes
     * (seq[1], seq[len/2]): with the end pinned to the goal, distinct
     * routes routinely share (len, cost) on a uniform grid — the plain
     * key would collapse them and leave the information scorer nothing
     * to choose between.  Free mode keeps the original key bit-for-bit. */
    int64_t cmicro = round6_micro(cost);
    int64_t route = 0;
    if (g->goal >= 0 && g->depth > 1) {
        int64_t n_nodes = (int64_t)g->nr * g->nc;
        route = (int64_t)g->stack[1] * n_nodes
              + (int64_t)g->stack[g->depth / 2];
    }
    if (!seen_add(&g->seen, end, g->depth, cmicro, route)) return 0;
    paths_t *p = &g->out;
    if (p->arena_len + g->depth > p->arena_cap) {
        p->arena_cap = (p->arena_cap + g->depth) * 2;
        int32_t *na = realloc(p->arena, sizeof(int32_t) * p->arena_cap);
        if (!na) { g->oom = 1; g->done = 1; return -1; }
        p->arena = na;
    }
    memcpy(p->arena + p->arena_len, g->stack, sizeof(int32_t) * g->depth);
    p->off[p->n] = p->arena_len;
    p->len[p->n] = g->depth;
    p->cost[p->n] = cost;
    p->arena_len += g->depth;
    p->n++;
    if (p->n >= g->harvest_cap) { g->done = 1; return -1; }
    return 0;
}

static void extend(ctx_t *g, double cost, int turns);

static void switch_rows(ctx_t *g, double cost, int turns, int r, int c) {
    for (int dr = -1; dr <= 1 && !g->done; dr += 2) {
        int rr = r + dr;
        if (rr < 0 || rr >= g->nr || cost + g->rs > g->budget) continue;
        int32_t nxt = (int32_t)rr * g->nc + c;
        /* membership test against the working path (python: nxt not in seq)
         * — paths are short (≤ a few hundred); linear scan is fine */
        int present = 0;
        for (int32_t i = 0; i < g->depth; i++)
            if (g->stack[i] == nxt) { present = 1; break; }
        if (present) continue;
        g->stack[g->depth++] = nxt;
        if (emit(g, cost + g->rs) == 0)
            extend(g, cost + g->rs, turns - 1);
        g->depth--;
        if (g->done) return;
    }
}

static void extend(ctx_t *g, double cost, int turns) {
    if (g->done) return;
    int32_t node = g->stack[g->depth - 1];
    int r = node / g->nc, c = node % g->nc;
    int32_t base_depth = g->depth;
    for (int dir = -1; dir <= 1 && !g->done; dir += 2) {
        int cc = c;
        double acc = cost;
        while (cc + dir >= 0 && cc + dir < g->nc && acc + g->cs <= g->budget) {
            cc += dir;
            acc += g->cs;
            g->stack[g->depth++] = (int32_t)r * g->nc + cc;
            if (emit(g, acc) != 0) break;
            if (turns > 0 && (cc == 0 || cc == g->nc - 1)) {
                switch_rows(g, acc, turns, r, cc);
                if (g->done) break;
            }
        }
        g->depth = base_depth;   /* rewind the run */
        if (g->done) return;
    }
    if (turns > 0 && (c == 0 || c == g->nc - 1))
        switch_rows(g, cost, turns, r, c);
}

/* sort candidates by (-cost, lexicographic node sequence) */
static const paths_t *g_sort_paths;
static int cand_cmp(const void *a, const void *b) {
    int64_t ia = *(const int64_t *)a, ib = *(const int64_t *)b;
    const paths_t *p = g_sort_paths;
    if (p->cost[ia] != p->cost[ib])
        return p->cost[ia] > p->cost[ib] ? -1 : 1;
    const int32_t *sa = p->arena + p->off[ia], *sb = p->arena + p->off[ib];
    int32_t la = p->len[ia], lb = p->len[ib], lm = la < lb ? la : lb;
    for (int32_t i = 0; i < lm; i++)
        if (sa[i] != sb[i]) return sa[i] < sb[i] ? -1 : 1;
    if (la != lb) return la < lb ? -1 : 1;   /* prefix sorts first */
    return 0;
}

/* Thin a path's sample sites exactly as planning.paths_to_batch:
 * exclude the start node, then at most k_max sites at
 * unique(rint(linspace(0, L-1, k_max))).  numpy's linspace computes
 * step = (L-1)/(k-1) and y_i = i*step with the endpoint forced to L-1,
 * and np.round is rint (ties-to-even) — replicated op-for-op so the
 * resulting index sets are bit-equal to the Python batch. */
static int32_t thin_sites(const int32_t *seq, int32_t len, int k_max,
                          int32_t *out) {
    const int32_t *nodes = len > 1 ? seq + 1 : seq;
    int32_t L = len > 1 ? len - 1 : len;
    if (L <= k_max) {
        memcpy(out, nodes, sizeof(int32_t) * L);
        return L;
    }
    double step = (double)(L - 1) / (double)(k_max - 1);
    int64_t prev = -1;
    int32_t n = 0;
    for (int i = 0; i < k_max; i++) {
        int64_t idx = (i == k_max - 1) ? (int64_t)(L - 1)
                                       : llrint((double)i * step);
        if (idx != prev) {       /* np.unique on a monotone pick */
            out[n++] = nodes[idx];
            prev = idx;
        }
    }
    return n;
}

/* Enumerate and select paths.
 *
 * Outputs (caller-allocated):
 *   sel_costs[max_paths], sel_lens[max_paths],
 *   sel_nodes[node_cap] (selected sequences, concatenated),
 *   sel_offs[max_paths],
 *   and when k_max > 0 the device-ready thinned batch:
 *   sel_sets[max_paths * k_max] (zero-padded), sel_sizes[max_paths],
 *   sel_ends[max_paths]
 * Returns the number of selected paths (≥0), or:
 *   -1  allocation failure (the caller raises)
 *   -2  node_cap too small for the selected sequences
 */
int algp_enumerate_paths(
    int num_rows, int num_cols, double col_spacing, double row_spacing,
    int start, int goal, double budget, int max_paths, int max_turns,
    double min_cost_frac,
    double *sel_costs, int32_t *sel_lens, int32_t *sel_nodes,
    int64_t *sel_offs, int64_t node_cap,
    int k_max, int32_t *sel_sets, int32_t *sel_sizes, int32_t *sel_ends)
{
    ctx_t g;
    memset(&g, 0, sizeof(g));
    g.nr = num_rows; g.nc = num_cols;
    g.cs = col_spacing; g.rs = row_spacing;
    g.budget = budget; g.max_turns = max_turns;
    g.goal = goal;
    g.harvest_cap = (int64_t)max_paths * 8;

    int rc;
    int64_t cap = g.harvest_cap;
    g.out.cap = cap;
    g.out.arena_cap = cap * 64;
    g.out.arena = malloc(sizeof(int32_t) * g.out.arena_cap);
    g.out.off = malloc(sizeof(int64_t) * cap);
    g.out.len = malloc(sizeof(int32_t) * cap);
    g.out.cost = malloc(sizeof(double) * cap);
    /* Longest possible path: every pushed node costs at least
     * min(cs, rs), so depth ≤ budget / min_spacing + 1 (+ slack) —
     * NOT the node count: row runs may re-traverse visited nodes
     * (only headland switch targets are membership-checked, exactly
     * as the Python engine), so on small grids with generous budgets
     * a path can be longer than the grid (a 2×6 grid at budget 16
     * reaches depth 17; the old nr·nc+2 bound overflowed the heap).
     * Past 2^20 nodes the dedup key packing (end · 2^20 + len) would
     * alias too — both bounds fail over to the Python engine. */
    double min_sp = col_spacing < row_spacing ? col_spacing : row_spacing;
    if (min_sp <= 0) { rc = -1; goto cleanup; }
    double depth_bound = budget / min_sp + 4.0;
    if (!(depth_bound < (double)(1 << 20))) { rc = -1; goto cleanup; }
    int64_t max_len = (int64_t)depth_bound;
    g.stack = malloc(sizeof(int32_t) * max_len);
    rc = seen_init(&g.seen, cap * 4 + 7);
    if (!g.out.arena || !g.out.off || !g.out.len || !g.out.cost
        || !g.stack || rc != 0) {
        rc = -1;
        goto cleanup;
    }

    g.stack[g.depth++] = start;
    extend(&g, 0.0, max_turns);
    if (g.oom) { rc = -1; goto cleanup; }

    /* min_cost_frac filter (fall back to all if none qualify) */
    int64_t *idx = malloc(sizeof(int64_t) * (g.out.n ? g.out.n : 1));
    if (!idx) { rc = -1; goto cleanup; }
    int64_t ngood = 0;
    /* goal-conditioned: every candidate already reaches the goal, so
     * the short-stub preference is meaningless — keep them all */
    double thresh = goal >= 0 ? 0.0 : min_cost_frac * budget;
    for (int64_t i = 0; i < g.out.n; i++)
        if (g.out.cost[i] >= thresh) idx[ngood++] = i;
    if (ngood == 0)
        for (int64_t i = 0; i < g.out.n; i++) idx[ngood++] = i;

    g_sort_paths = &g.out;
    qsort(idx, ngood, sizeof(int64_t), cand_cmp);

    int64_t nsel = ngood < max_paths ? ngood : max_paths;
    int64_t pos = 0;
    for (int64_t k = 0; k < nsel; k++) {
        int64_t i = idx[k];
        if (pos + g.out.len[i] > node_cap) { free(idx); rc = -2; goto cleanup; }
        memcpy(sel_nodes + pos, g.out.arena + g.out.off[i],
               sizeof(int32_t) * g.out.len[i]);
        sel_offs[k] = pos;
        sel_lens[k] = g.out.len[i];
        sel_costs[k] = g.out.cost[i];
        if (k_max > 0) {
            memset(sel_sets + k * k_max, 0, sizeof(int32_t) * k_max);
            sel_sizes[k] = thin_sites(g.out.arena + g.out.off[i],
                                      g.out.len[i], k_max,
                                      sel_sets + k * k_max);
            sel_ends[k] = g.out.arena[g.out.off[i] + g.out.len[i] - 1];
        }
        pos += g.out.len[i];
    }
    free(idx);
    rc = (int)nsel;

cleanup:
    free(g.out.arena); free(g.out.off); free(g.out.len); free(g.out.cost);
    free(g.stack); free(g.seen.end_len); free(g.seen.cost_micro);
    free(g.seen.route);
    return rc;
}
