"""Binary implication storage + implied-bound cuts.

Re-implementation of the reference's HighsImplications
(highs/mip/HighsImplications.cpp: probing support, vbound storage) and
the implied-bound separation round of HighsSeparation.cpp:43-160.
TPU-build idiom: probing is vectorized domain propagation on the host
(one propagate() per binary direction); the cuts it yields feed the
batched device LP re-solves.

For a binary x_j, probing propagates the two fixings x_j=0 / x_j=1.
Outcomes:

- one direction infeasible -> x_j is fixed the other way (probing
  fixing, same as HPresolve's probing rule but at the MIP root with
  the full row set incl. cuts);
- both feasible -> store the implied bounds; any variable i whose
  bound differs between the two directions yields a *variable bound*
  (vbound)  x_i <= u0 + (u1 - u0) x_j  /  x_i >= l0 + (l1 - l0) x_j,
  exactly the inequalities the reference separates as implied-bound
  cuts.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np

from .cuts import Cut
from .propagate import Propagator

_BIG = 1e20


class Implications:
    """Probe binaries and store per-direction implied bounds."""

    def __init__(self, prop: Propagator, feastol: float = 1e-6):
        self.prop = prop
        self.feastol = feastol
        # probed binary index -> (lo0, up0, lo1, up1) dense arrays
        self.store = {}
        self.fixed: List[Tuple[int, float]] = []  # (col, value) fixings
        self.infeasible = False

    def probe(self, candidates, lo: np.ndarray, up: np.ndarray,
              max_probes: int = 64) -> Tuple[np.ndarray, np.ndarray]:
        """Probe up to `max_probes` binaries.  Returns possibly
        tightened global (lo, up); sets self.infeasible when both
        directions of some binary die."""
        lo = lo.copy()
        up = up.copy()
        n_done = 0
        for j in candidates:
            if n_done >= max_probes or self.infeasible:
                break
            j = int(j)
            if up[j] - lo[j] < 0.5:   # already fixed
                continue
            lo0, up0 = lo.copy(), up.copy()
            up0[j] = lo[j]            # x_j = 0 side (at lower bound)
            ok0, lo0, up0 = self.prop.propagate(lo0, up0, max_rounds=3)
            lo1, up1 = lo.copy(), up.copy()
            lo1[j] = up[j]            # x_j = 1 side
            ok1, lo1, up1 = self.prop.propagate(lo1, up1, max_rounds=3)
            n_done += 1
            if not ok0 and not ok1:
                self.infeasible = True
                return lo, up
            if not ok0:
                lo[j] = up[j]
                self.fixed.append((j, float(up[j])))
                lo, up = np.maximum(lo, lo1), np.minimum(up, up1)
                continue
            if not ok1:
                up[j] = lo[j]
                self.fixed.append((j, float(lo[j])))
                lo, up = np.maximum(lo, lo0), np.minimum(up, up0)
                continue
            # both feasible: union bounds tighten globally
            # (HPresolve probing's bound strengthening)
            ulo = np.minimum(lo0, lo1)
            uup = np.maximum(up0, up1)
            lo = np.maximum(lo, ulo)
            up = np.minimum(up, uup)
            self.store[j] = (lo0, up0, lo1, up1)
        return lo, up

    def cover_edges(self, lo: np.ndarray, up: np.ndarray,
                    is_binary: np.ndarray) -> List[Tuple[int, int]]:
        """Cover pairs  y_i + y_j >= 1  discovered by probing:
        fixing y_i = 0 propagated y_j's lower bound to 1 (reference:
        these are complemented-literal cliques in HighsCliqueTable,
        the raw material of ObjectivePropagation's clique partition,
        HighsDomain.h:239)."""
        edges: List[Tuple[int, int]] = []
        for i, (lo0, _up0, _lo1, _up1) in self.store.items():
            if not is_binary[i]:
                continue
            forced = (lo0 >= 1.0 - self.feastol) & is_binary & \
                (up >= 1.0 - self.feastol) & (lo <= self.feastol)
            forced[i] = False
            for j in np.nonzero(forced)[0]:
                edges.append((int(i), int(j)))
        return edges

    def cover_clique_rows(self, lo: np.ndarray, up: np.ndarray,
                          is_binary: np.ndarray, cost: np.ndarray
                          ) -> List[Cut]:
        """Valid rows  sum_{j in C} y_j >= |C|-1  for cliques C in the
        cover graph (pairwise  y_i + y_j >= 1): at most one member of
        C can be zero.  This is the row form of the reference's
        objective clique partition (HighsObjectiveFunction
        setupCliquePartition + ObjectivePropagation): adding the rows
        lets the LP bound and domain propagation absorb the
        combinatorial objective bound  sum(c) - max(c)  per clique and
        lift the incumbent cutoff into variable fixings.

        Greedy partition biased to high-cost columns first (the bound
        contribution of a clique is its total cost minus its largest
        member)."""
        edges = self.cover_edges(lo, up, is_binary)
        if not edges:
            return []
        adj: dict = {}
        for i, j in edges:
            adj.setdefault(i, set()).add(j)
            adj.setdefault(j, set()).add(i)
        order = sorted(adj, key=lambda jj: -abs(float(cost[jj])))
        used: set = set()
        rows: List[Cut] = []
        for start in order:
            if start in used:
                continue
            clique = [start]
            cand = adj[start] - used
            while cand:
                # highest-cost candidate adjacent to ALL members
                nxt = max(cand, key=lambda jj: abs(float(cost[jj])))
                clique.append(nxt)
                cand = (cand & adj[nxt]) - {nxt}
            if len(clique) < 2:
                continue
            used.update(clique)
            cols = np.array(sorted(clique), dtype=np.int32)
            # sum y >= |C|-1   ->   -sum y <= -(|C|-1)
            rows.append(Cut(cols=cols,
                            vals=-np.ones(len(cols)),
                            rhs=-(len(cols) - 1.0),
                            efficacy=0.0))
        return rows

    def separate(self, x: np.ndarray, lo: np.ndarray, up: np.ndarray,
                 tol: float = 1e-5, max_cuts: int = 50) -> List[Cut]:
        """Implied-bound cuts violated at x.

        Upper vbound:  x_i - (u1 - u0) x_j <= u0   (u0 = bound at
        x_j=0, u1 at x_j=1; both finite, at least one strictly tighter
        than the global bound).  Lower vbound mirrored and returned in
        <=-form."""
        cuts: List[Cut] = []
        for j, (lo0, up0, lo1, up1) in self.store.items():
            xj = float(x[j])
            if xj < tol or xj > 1.0 - tol:
                continue  # cut can only be violated at fractional x_j
            # --- upper bounds -------------------------------------------
            fin = (np.abs(up0) < _BIG) & (np.abs(up1) < _BIG)
            tighter = fin & ((up0 < up - self.feastol) |
                             (up1 < up - self.feastol))
            tighter[j] = False
            for i in np.nonzero(tighter)[0]:
                u0, u1 = float(up0[i]), float(up1[i])
                # x_i <= u0 + (u1-u0) x_j
                viol = float(x[i]) - (u0 + (u1 - u0) * xj)
                nrm = float(np.hypot(1.0, u1 - u0))
                if viol > tol * nrm:
                    cuts.append(Cut(
                        cols=np.array([i, j], dtype=np.int32),
                        vals=np.array([1.0, -(u1 - u0)]),
                        rhs=u0, efficacy=viol / nrm))
            # --- lower bounds -------------------------------------------
            fin = (np.abs(lo0) < _BIG) & (np.abs(lo1) < _BIG)
            tighter = fin & ((lo0 > lo + self.feastol) |
                             (lo1 > lo + self.feastol))
            tighter[j] = False
            for i in np.nonzero(tighter)[0]:
                l0, l1 = float(lo0[i]), float(lo1[i])
                # x_i >= l0 + (l1-l0) x_j  ->  -x_i + (l1-l0) x_j <= -l0
                viol = (l0 + (l1 - l0) * xj) - float(x[i])
                nrm = float(np.hypot(1.0, l1 - l0))
                if viol > tol * nrm:
                    cuts.append(Cut(
                        cols=np.array([i, j], dtype=np.int32),
                        vals=np.array([-1.0, (l1 - l0)]),
                        rhs=-l0, efficacy=viol / nrm))
            if len(cuts) >= max_cuts:
                break
        cuts.sort(key=lambda c: -c.efficacy)
        return cuts[:max_cuts]
