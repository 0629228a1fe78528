"""Symmetry detection for MIP.

Re-implements the purpose of the reference's custom graph-automorphism
search (highs/presolve/HighsSymmetry.cpp: partition refinement producing
generators, orbits used for orbital fixing) with a
individualization-refinement search over the column/row colored
bipartite graph of the LP:

- initial colors: columns by (cost, lower, upper, integrality), rows by
  (row_lower, row_upper);
- refinement: iterated Weisfeiler-Lehman hashing with coefficient-valued
  edges until the partition stabilizes;
- generator search: individualize a pair (u, v) from one cell, re-refine
  both, and greedily align the resulting partitions into a candidate
  column permutation;
- every candidate is VERIFIED to be a true automorphism of (A, c,
  bounds, integrality) — soundness never depends on the search
  heuristics.

The MIP solver uses verified generators for symmetry handling: for each
generator g with first moved index j*, the first-row lex constraint
x_{j*} >= x_{g(j*)} keeps the lex-greatest representative of every
<g>-orbit feasible, so adding it is optimum-preserving.  Orbits (via
union-find over generators) feed orbital fixing: a root-fixed variable
fixes its whole orbit.
"""
from __future__ import annotations

import time
from typing import List, Tuple

import numpy as np


class _ColorTable:
    """Shared key->int relabeling.  Sharing ONE table across both
    branches of a u/v individualization keeps color ids aligned by
    CONTENT, so cells with the same color in both partitions correspond
    (order-dependent relabeling would break the alignment)."""

    def __init__(self):
        self.table = {}

    def __call__(self, keys):
        t = self.table
        out = np.empty(len(keys), dtype=np.int64)
        for i, k in enumerate(keys):
            out[i] = t.setdefault(k, len(t))
        return out


_HASH_P = np.uint64(1099511628211)      # FNV-ish odd multiplier
_HASH_Q = np.uint64(0x9E3779B97F4A7C15)  # golden-ratio mixer


def _mix(h):
    """64-bit avalanche mix (splitmix64 finalizer), vectorized."""
    h = h.astype(np.uint64, copy=True)
    with np.errstate(over="ignore"):
        h ^= h >> np.uint64(30)
        h *= np.uint64(0xBF58476D1CE4E5B9)
        h ^= h >> np.uint64(27)
        h *= np.uint64(0x94D049BB133111EB)
        h ^= h >> np.uint64(31)
    return h


def _side_hash(indptr, indices, coef_id, other_color, own_color, nn):
    """Commutative multiset hash of each row's (other_color, coeff)
    pairs — one vectorized WL step with NO sorting: the per-entry pair
    hashes are avalanche-mixed then summed per row, so entry order
    cannot matter.  Entries are already contiguous per row/col in
    CSR/CSC order, so the per-segment sum is an `np.add.reduceat` over
    `indptr` (the former `np.add.at` scatter was ~20x slower and
    dominated detection time).  Collisions only create candidate
    permutations that the verification step rejects; soundness never
    depends on the hash."""
    if len(indices) == 0:
        return _mix(own_color.astype(np.uint64, copy=False))
    with np.errstate(over="ignore"):
        pair = _mix(other_color[indices] * _HASH_Q + coef_id)
        row_hash = np.zeros(nn, dtype=np.uint64)
        seg_len = np.diff(indptr)
        nonempty = np.flatnonzero(seg_len > 0)
        if len(nonempty):
            # consecutive nonempty starts bound exactly one segment
            # each (empty segments have start == end), so reduceat
            # over the nonempty starts yields per-segment sums
            row_hash[nonempty] = np.add.reduceat(
                pair, indptr[nonempty])
        row_hash = _mix(row_hash * _HASH_Q +
                        own_color.astype(np.uint64, copy=False))
    return row_hash


def _refine(a_csc, a_csr, col_color, row_color, table=None,
            max_rounds=30, coef_ids=None):
    """WL-style color refinement with coefficient-labeled edges.

    Colors ARE the raw 64-bit hashes (no dense relabeling): two cells
    correspond across independently refined partitions iff their hash
    values are equal, which keeps the u/v branches of an
    individualization content-aligned with zero bookkeeping.  Collisions
    only yield candidates that verification rejects."""
    m, n = a_csr.shape
    if coef_ids is None:
        coef_ids = _coef_ids(a_csc, a_csr)
    csr_coef, csc_coef, indptr_csr, indptr_csc = coef_ids
    col_color = col_color.astype(np.uint64, copy=False)
    row_color = row_color.astype(np.uint64, copy=False)
    n_col_cells = len(np.unique(col_color))
    n_row_cells = len(np.unique(row_color))
    for _ in range(max_rounds):
        new_row = _side_hash(indptr_csr, a_csr.indices, csr_coef,
                             col_color, row_color, m)
        new_col = _side_hash(indptr_csc, a_csc.indices, csc_coef,
                             new_row, col_color, n)
        nc, nr = len(np.unique(new_col)), len(np.unique(new_row))
        col_color, row_color = new_col, new_row
        if nc == n_col_cells and nr == n_row_cells:
            return col_color, row_color
        n_col_cells, n_row_cells = nc, nr
    return col_color, row_color


def _dual_ids(a_csc, a_csr, coef_ids):
    """Doubled-graph structures for refining BOTH branches of a u/v
    individualization in ONE vectorized pass: two disjoint copies of
    the bipartite graph laid out side by side (branch 0 at offsets
    [0,n)/[0,m), branch 1 at [n,2n)/[m,2m)).  The per-entry arrays are
    tiled; indptr is stitched so `_side_hash`'s reduceat segments stay
    contiguous.  Halves the Python/numpy call overhead of the dive,
    which dominates detection time on small models."""
    csr_coef, csc_coef, indptr_csr, indptr_csc = coef_ids
    nnz = len(a_csr.indices)
    m, n = a_csr.shape
    ind_csr2 = np.concatenate([a_csr.indices, a_csr.indices + n])
    ind_csc2 = np.concatenate([a_csc.indices, a_csc.indices + m])
    iptr_csr2 = np.concatenate([indptr_csr, indptr_csr[1:] + nnz])
    iptr_csc2 = np.concatenate([indptr_csc, indptr_csc[1:] + nnz])
    csr_coef2 = np.concatenate([csr_coef, csr_coef])
    csc_coef2 = np.concatenate([csc_coef, csc_coef])
    return (ind_csr2, ind_csc2, iptr_csr2, iptr_csc2,
            csr_coef2, csc_coef2, m, n)


def _refine2(dual, cu, cv, row_color, max_rounds=30):
    """Refine the u- and v-branches simultaneously on the doubled
    graph; returns the two refined column colorings."""
    (ind_csr2, ind_csc2, iptr_csr2, iptr_csc2,
     csr_coef2, csc_coef2, m, n) = dual
    col_color = np.concatenate([cu, cv]).astype(np.uint64, copy=False)
    row_color2 = np.concatenate([row_color, row_color]).astype(
        np.uint64, copy=False)
    n_col_cells = len(np.unique(col_color))
    n_row_cells = len(np.unique(row_color2))
    for _ in range(max_rounds):
        new_row = _side_hash(iptr_csr2, ind_csr2, csr_coef2,
                             col_color, row_color2, 2 * m)
        new_col = _side_hash(iptr_csc2, ind_csc2, csc_coef2,
                             new_row, col_color, 2 * n)
        nc, nr = len(np.unique(new_col)), len(np.unique(new_row))
        col_color, row_color2 = new_col, new_row
        if nc == n_col_cells and nr == n_row_cells:
            break
        n_col_cells, n_row_cells = nc, nr
    return col_color[:n], col_color[n:]


def _coef_ids(a_csc, a_csr):
    """Per-entry coefficient hash ids + per-entry row/col ids for both
    orientations (the sparsity-dependent parts of the WL step,
    precomputed once per detect_symmetry call)."""
    uniq, inv_csr = np.unique(a_csr.data, return_inverse=True)
    inv_csc = np.searchsorted(uniq, a_csc.data)
    return (_mix(inv_csr.astype(np.uint64)),
            _mix(inv_csc.astype(np.uint64)),
            a_csr.indptr.astype(np.int64),
            a_csc.indptr.astype(np.int64))


def _hash_rows(keys):
    return _ColorTable()(keys)


def _col_signature(lp):
    n = lp.num_col
    integ = (np.asarray(lp.integrality) if len(lp.integrality) == n
             else np.zeros(n, dtype=np.uint8))
    keys = [(round(float(lp.col_cost[j]), 12),
             round(float(lp.col_lower[j]), 12),
             round(float(lp.col_upper[j]), 12), int(integ[j]))
            for j in range(n)]
    return _hash_rows(keys)


def _row_signature(lp):
    keys = [(round(float(lp.row_lower[i]), 12),
             round(float(lp.row_upper[i]), 12))
            for i in range(lp.num_row)]
    return _hash_rows(keys)


def _verify_automorphism(lp, a_csr, perm) -> bool:
    """Check perm (columns) extends to a model automorphism."""
    n = lp.num_col
    if np.array_equal(perm, np.arange(n)):
        return False
    integ = (np.asarray(lp.integrality) if len(lp.integrality) == n
             else np.zeros(n, dtype=np.uint8))
    if not (np.allclose(lp.col_cost, lp.col_cost[perm]) and
            np.allclose(lp.col_lower, lp.col_lower[perm]) and
            np.allclose(lp.col_upper, lp.col_upper[perm]) and
            np.array_equal(integ, integ[perm])):
        return False
    # rows of A[:, perm] must be a permutation of rows of A with equal
    # row bounds
    inv = np.empty(n, dtype=np.int64)
    inv[perm] = np.arange(n)

    def row_key(i, use_perm):
        s, e = a_csr.indptr[i], a_csr.indptr[i + 1]
        cols = a_csr.indices[s:e]
        vals = a_csr.data[s:e]
        if use_perm:
            cols = inv[cols]
        order = np.argsort(cols)
        return (tuple(cols[order]), tuple(np.round(vals[order], 12)),
                round(float(lp.row_lower[i]), 12),
                round(float(lp.row_upper[i]), 12))

    orig = {}
    for i in range(lp.num_row):
        orig.setdefault(row_key(i, False), []).append(i)
    for i in range(lp.num_row):
        k = row_key(i, True)
        if k not in orig or not orig[k]:
            return False
        orig[k].pop()
    return True


def detect_symmetry(lp, max_generators: int = 16,
                    time_budget: float = 5.0) -> List[np.ndarray]:
    """Return a list of verified column-permutation generators."""
    t0 = time.perf_counter()
    n, m = lp.num_col, lp.num_row
    if n > 20000 or m > 20000:
        return []
    a_csc = lp.a_matrix.to_scipy().tocsc()
    a_csr = a_csc.tocsr()
    # quantize coefficients for stable hashing
    a_csc = a_csc.copy()
    a_csc.data = np.round(a_csc.data, 12)
    a_csr = a_csr.copy()
    a_csr.data = np.round(a_csr.data, 12)

    table = _ColorTable()
    col_color = table(
        [(round(float(lp.col_cost[j]), 12),
          round(float(lp.col_lower[j]), 12),
          round(float(lp.col_upper[j]), 12),
          int(lp.integrality[j]) if len(lp.integrality) == n else 0)
         for j in range(n)])
    row_color = table(
        [(round(float(lp.row_lower[i]), 12),
          round(float(lp.row_upper[i]), 12)) for i in range(lp.num_row)])
    coef_ids = _coef_ids(a_csc, a_csr)
    dual_ids = _dual_ids(a_csc, a_csr, coef_ids)
    col_color, row_color = _refine(a_csc, a_csr, col_color, row_color,
                                   table, coef_ids=coef_ids)

    generators: List[np.ndarray] = []
    cells = {}
    for j in range(n):
        cells.setdefault(int(col_color[j]), []).append(j)
    big_cells = [c for c in cells.values() if len(c) >= 2]

    def individualize(base_color, j, depth):
        # the marker depends only on `depth`, so individualizing at the
        # same depth in both branches yields the SAME color — keeping
        # the two partitions content-aligned
        c = base_color.copy()
        c[j] = _mix(np.asarray([depth + 0x51ED], np.uint64))[0]
        return c

    def candidate(u, v):
        """Parallel individualization-refinement: map u -> v, then keep
        splitting the first multi-cell in both branches in lockstep
        until discrete; returns an aligned permutation or None."""
        cu = individualize(col_color, u, 0)
        cv = individualize(col_color, v, 0)
        cu, cv = _refine2(dual_ids, cu, cv, row_color)
        for depth in range(1, n + 1):
            if time.perf_counter() - t0 > time_budget:
                return None  # budget is a hard deadline, even mid-pair
            colors_u, inv_u, cnt_u = np.unique(
                cu, return_inverse=True, return_counts=True)
            colors_v, inv_v, cnt_v = np.unique(
                cv, return_inverse=True, return_counts=True)
            if not (len(colors_u) == len(colors_v) and
                    np.array_equal(colors_u, colors_v) and
                    np.array_equal(cnt_u, cnt_v)):
                return None
            if cnt_u.max() == 1:
                # discrete and aligned: sort both by color value
                perm = np.empty(n, dtype=np.int64)
                perm[np.argsort(cu, kind="stable")] = \
                    np.argsort(cv, kind="stable")
                return perm
            c0 = int(np.argmax(cnt_u > 1))  # first multi cell by color
            ju = int(np.argmax(inv_u == c0))
            jv = int(np.argmax(inv_v == c0))
            cu = individualize(cu, ju, depth)
            cv = individualize(cv, jv, depth)
            cu, cv = _refine2(dual_ids, cu, cv, row_color)
        return None

    total_fails = 0
    # orbit pruning (reference stabilizer pruning role,
    # HighsSymmetry.cpp): a candidate pair already connected by the
    # found generators can only yield a redundant generator — skip it.
    # Candidates cost ~60ms of refinement each; on models with rich
    # symmetry this cuts the verified-generator count to a spanning
    # set with identical orbits.
    _uf = np.arange(n, dtype=np.int64)

    def _find(i):
        root = i
        while _uf[root] != root:
            root = _uf[root]
        while _uf[i] != root:
            _uf[i], i = root, _uf[i]
        return root

    for cell in big_cells:
        if len(generators) >= max_generators or \
                time.perf_counter() - t0 > time_budget:
            break
        # asymmetric-instance early-out: candidates are expensive
        # (~0.1s of refinement each) and symmetric models succeed on
        # their first pairs — a run of failures with zero successes
        # means the refinement colors over-merge on an asymmetric
        # model, and every further pair will fail the same way
        if total_fails >= 6 and not generators:
            break
        u = cell[0]
        fails = 0
        for v in cell[1:]:
            if time.perf_counter() - t0 > time_budget or \
                    len(generators) >= max_generators:
                break
            if _find(u) == _find(v):
                continue  # already in one orbit: redundant generator
            perm = candidate(u, v)
            if perm is not None and _verify_automorphism(lp, a_csr,
                                                         perm):
                generators.append(perm)
                for j in range(n):
                    pj = int(perm[j])
                    if pj != j:
                        _uf[_find(j)] = _find(pj)
                fails = 0
            else:
                total_fails += 1
                # a cell whose first pairs fail is usually asymmetric
                # throughout — stop burning budget on it (reference
                # bounds its search the same way via stabilizer
                # pruning, HighsSymmetry.cpp)
                fails += 1
                if fails >= 3:
                    break
    return generators


def orbits(generators: List[np.ndarray], n: int) -> np.ndarray:
    """Union-find orbit labels from the generator set."""
    parent = np.arange(n)

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    for g in generators:
        for j in range(n):
            a, b = find(j), find(int(g[j]))
            if a != b:
                parent[a] = b
    return np.array([find(j) for j in range(n)])


def symmetry_breaking_rows(generators: List[np.ndarray], n: int
                           ) -> List[Tuple[int, int]]:
    """One first-row lex constraint per generator:  x_j - x_{g(j)} >= 0
    at the first moved index j (optimum-preserving for each <g>)."""
    rows = []
    seen = set()
    for g in generators:
        moved = np.nonzero(g != np.arange(n))[0]
        if not len(moved):
            continue
        j = int(moved[0])
        pair = (j, int(g[j]))
        if pair not in seen and pair[0] != pair[1]:
            seen.add(pair)
            rows.append(pair)
    return rows


def detect_packing_orbitopes(lp, generators):
    """Detect packing/partitioning orbitopes from verified generators
    (reference HighsSymmetry.h:58-126 orbitope machinery).

    An orbitope here is a p x q grid of binary variables whose columns
    are linked by involution generators (disjoint 2-cycles aligning two
    equal tuples) forming a connected chain — the group restricted to
    the grid then contains the full symmetric group on columns — and
    whose every row-tuple lies in a packing row (sum of the tuple with
    coefficient 1 bounded above by 1; partitioning rows qualify too).

    Returns a list of (rows x cols) int arrays of variable indices."""
    n = lp.num_col
    integ = (np.asarray(lp.integrality) if len(lp.integrality) == n
             else np.zeros(n, dtype=np.uint8))
    binary = ((integ == 1) & (np.asarray(lp.col_lower) >= -1e-9) &
              (np.asarray(lp.col_upper) <= 1.0 + 1e-9))

    # involution generators -> column-pair links
    links = []  # (tupleA, tupleB) aligned by pairing
    for g in generators:
        g = np.asarray(g)
        moved = np.nonzero(g != np.arange(n))[0]
        if len(moved) == 0 or not np.all(g[g[moved]] == moved):
            continue
        if not np.all(binary[moved]):
            continue
        a_side = moved[moved < g[moved]]
        pairs = sorted((int(a), int(g[a])) for a in a_side)
        links.append(([p[0] for p in pairs], [p[1] for p in pairs]))

    # chain columns: map each tuple (as frozenset) to a column id
    orbitopes = []
    used = set()
    for start in range(len(links)):
        a0, b0 = links[start]
        if start in used or len(a0) < 2:
            continue
        # rows are ordered by tuple A's sorted order
        cols = [list(a0), list(b0)]
        tentative = {start}
        grown = True
        seen_cols = {frozenset(a0), frozenset(b0)}
        while grown:
            grown = False
            last = cols[-1]
            pos = {v: i for i, v in enumerate(last)}
            for li in range(len(links)):
                if li in used or li in tentative:
                    continue
                a, b = links[li]
                nxt = None
                if set(a) == set(last):
                    nxt = [None] * len(last)
                    for va, vb in zip(a, b):
                        nxt[pos[va]] = vb
                elif set(b) == set(last):
                    nxt = [None] * len(last)
                    for vb, va in zip(b, a):
                        nxt[pos[vb]] = va
                if nxt is None:
                    continue
                key = frozenset(nxt)
                if key in seen_cols:
                    # duplicate link (maps back onto an existing
                    # column): consume it without growing the chain
                    tentative.add(li)
                    continue
                seen_cols.add(key)
                cols.append(nxt)
                tentative.add(li)
                grown = True
                break
        if len(cols) < 2:
            used.add(start)
            continue
        grid = np.asarray(cols).T  # (rows p, cols q)
        if len(set(grid.ravel().tolist())) != grid.size:
            continue
        # packing-row verification per grid row
        a_csr = lp.a_matrix.to_scipy().tocsr()
        ru = np.asarray(lp.row_upper)
        ok = True
        for r in range(grid.shape[0]):
            tset = set(int(v) for v in grid[r])
            found = False
            for i in range(lp.num_row):
                s, e = a_csr.indptr[i], a_csr.indptr[i + 1]
                supp = a_csr.indices[s:e]
                if not tset.issubset(set(int(c) for c in supp)):
                    continue
                vals = a_csr.data[s:e]
                if ru[i] <= 1.0 + 1e-9 and np.all(vals >= -1e-9) and \
                        np.all(np.abs(
                            vals[np.isin(supp, list(tset))] - 1.0)
                            <= 1e-9) and np.all(binary[supp]):
                    found = True
                    break
            if not found:
                ok = False
                break
        if ok:
            orbitopes.append(grid)
            used |= tentative  # links consumed only on success
        else:
            used.add(start)  # failed chains release their other links
    return orbitopes


def orbitope_fixings(orbitopes, n):
    """Staircase fixings of the lex-max representative (Kaibel-Pfetsch
    packing/partitioning orbitope): x[r, c] = 0 for c > r.  Returns the
    variable indices to fix at zero."""
    fix = []
    for grid in orbitopes:
        p, q = grid.shape
        for r in range(min(p, q - 1)):
            for c_ in range(r + 1, q):
                fix.append(int(grid[r, c_]))
    return sorted(set(fix))
