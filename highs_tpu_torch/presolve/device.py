"""One copy of the constraint matrix on the solve's device, for a presolve
run's sweeps over the nonzeros.

Presolve's rule families (`rules.py` `run_presolve_rules`) decide from
masks, counts and sums over the matrix's live entries: those of an
active row and an active column with a nonzero value.  The copy holds
the host's canonical CSC as it was uploaded and its CSR order, built
there by a stable sort of the entries by row, so each row's entries come
in column order as in scipy's `tocsr`.  The masks are read beside it; no
masked matrix is built.  The host's scipy CSC stays the authority: a
family that edits entries hands the new matrix to `replace`, and the
copy is built again when it is next read.

Every result equals what the host computed from its masked scipy
matrices, bit for bit:

- counts of live entries by row or column are integers, in any order;
- the activity bounds sum in scipy's `csr_matvec` order
  (`ops/segment_sum.py` `signed_dot`: `csrc/segment_sum.cu` on a card,
  its plain version on the CPU);
- the parallel-row and parallel-column hashes are sums of 64-bit words
  modulo 2**64 (in int64, which wraps the same way), in any order; the
  members of each hash group come back in the order of the host's dict:
  groups by their first member, members by index.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import scipy.sparse as sp
import torch

from ..ops.segment_sum import signed_dot
from ..utils.timer import span

# the multiset hash's constants (the host's, as uint64 bit patterns in
# int64)
_Q = 0x9E3779B97F4A7C15 - (1 << 64)
_MIX = 0xBF58476D1CE4E5B9 - (1 << 64)
_LOW34 = (1 << 34) - 1   # `>> 30` of a uint64 is the arithmetic shift's
                         # low 34 bits


def _segment_total(values: torch.Tensor, ptr: torch.Tensor) -> torch.Tensor:
    """Each segment's int64 sum, through one running sum (modulo 2**64
    where the values wrap, as a sum of hashes does)."""
    run = torch.cumsum(values, 0, dtype=torch.int64)
    run = torch.cat([torch.zeros(1, dtype=torch.int64,
                                 device=values.device), run])
    return run[ptr[1:]] - run[ptr[:-1]]


def _groups(keys: torch.Tensor, candidates: torch.Tensor):
    """The candidates (a bool mask) grouped by equal key, groups of two or
    more only: (members, group ids) on the host, each group's members
    by index and its ids ascending."""
    idx = torch.nonzero(candidates).squeeze(1)
    sorted_keys, perm = torch.sort(keys[idx], stable=True)
    members = idx[perm]
    starts = torch.ones_like(sorted_keys, dtype=torch.bool)
    starts[1:] = sorted_keys[1:] != sorted_keys[:-1]
    gid = torch.cumsum(starts, 0) - 1
    keep = torch.bincount(gid)[gid] >= 2
    return members[keep], gid[keep]


def _split(members: np.ndarray, gid: np.ndarray) -> List[np.ndarray]:
    """The positions of each group id's run in `members`, the groups
    ordered by their first member."""
    cut = np.flatnonzero(np.diff(gid)) + 1
    groups = np.split(np.arange(len(members)), cut) if len(members) else []
    groups.sort(key=lambda g: int(members[g[0]]))
    return groups


class DeviceMatrix:
    """The host's canonical CSC `a` (`host`, the one name the rule loop
    reads the host's matrix by) and its copy on `device`.

    `timer` (a `HighsTimer` or None) takes the span `presolve.upload`
    around each build and the counters `presolve.device_builds` (copies
    built) and `presolve.device_sweeps` (sweeps read from a copy)."""

    def __init__(self, a: sp.csc_matrix, device, timer=None):
        self.device = torch.device(device)
        self.timer = timer
        self.host = a
        self._built = None      # the host matrix the copy was built from
        self._activity = None   # (host, inputs, result) of the last call
        self._csr = (None, None)  # (host, its CSR), made when first asked
        self._build()

    def replace(self, a: sp.csc_matrix) -> None:
        """A family edited entries: `a` is the host's new matrix."""
        self.host = a

    def host_csr(self) -> sp.csr_matrix:
        """The host's matrix as a CSR, made once a matrix, when a family
        first verifies row candidates."""
        if self._csr[0] is not self.host:
            self._csr = (self.host, self.host.tocsr())
        return self._csr[1]

    def _build(self) -> None:
        a = self.host
        dev = self.device
        m, n = a.shape
        with span(self.timer, "presolve.upload"):
            c_ptr = torch.from_numpy(
                np.ascontiguousarray(a.indptr, dtype=np.int64)).to(dev)
            c_row = torch.from_numpy(
                np.ascontiguousarray(a.indices, dtype=np.int32)).to(dev)
            c_val = torch.from_numpy(
                np.ascontiguousarray(a.data, dtype=np.float64)).to(dev)
            nnz = c_val.shape[0]
            c_col = torch.repeat_interleave(
                torch.arange(n, dtype=torch.int32, device=dev), c_ptr.diff(),
                output_size=nnz)
            # the CSR order: a stable sort by row keeps each row's entries
            # in column order
            order = torch.sort(c_row, stable=True)[1]
            self.r_ptr = torch.cat([
                torch.zeros(1, dtype=torch.int64, device=dev),
                torch.cumsum(torch.bincount(c_row, minlength=m), 0)])
            self.r_row = c_row[order]
            self.r_col = c_col[order]
            self.r_val = c_val[order]
            del order
            self.c_ptr, self.c_row, self.c_col, self.c_val = \
                c_ptr, c_row, c_col, c_val
            self.nnz = nnz
        self._built = a
        if self.timer is not None:
            self.timer.count("presolve.device_builds")

    def _sweep(self) -> None:
        """Before a read: build again after an edit, and count the
        sweep."""
        if self._built is not self.host:
            self._build()
        if self.timer is not None:
            self.timer.count("presolve.device_sweeps")

    def _mask(self, flags: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(flags, dtype=bool)).to(
            self.device)

    def _live(self, row_active, col_active, rows, cols, vals):
        return self._mask(row_active)[rows] & self._mask(col_active)[cols] \
            & (vals != 0)

    def stored_row_counts(self) -> np.ndarray:
        """Entries stored in each row, zeros and all."""
        self._sweep()
        return self.r_ptr.diff().cpu().numpy()

    def row_counts(self, row_active: np.ndarray, col_active: np.ndarray,
                   cols: Optional[np.ndarray] = None) -> np.ndarray:
        """Live entries in each row (those in a column of `cols` alone,
        where given)."""
        self._sweep()
        live = self._live(row_active, col_active, self.r_row, self.r_col,
                          self.r_val)
        if cols is not None:
            live &= self._mask(cols)[self.r_col]
        return _segment_total(live, self.r_ptr).cpu().numpy()

    def col_counts(self, row_active: np.ndarray, col_active: np.ndarray,
                   pos_rows: Optional[np.ndarray] = None,
                   neg_rows: Optional[np.ndarray] = None) -> np.ndarray:
        """Live entries in each column; where `pos_rows` and `neg_rows`
        are given, those with a positive value in a row of `pos_rows` and
        those with a negative value in a row of `neg_rows`."""
        self._sweep()
        live = self._live(row_active, col_active, self.c_row, self.c_col,
                          self.c_val)
        if pos_rows is not None:
            live &= ((self.c_val > 0) & self._mask(pos_rows)[self.c_row]) | \
                ((self.c_val < 0) & self._mask(neg_rows)[self.c_row])
        return _segment_total(live, self.c_ptr).cpu().numpy()

    def activity(self, lo: np.ndarray, up: np.ndarray, inf_lo: np.ndarray,
                 inf_up: np.ndarray) -> Tuple[np.ndarray, ...]:
        """Each row's least and most activity over the column bounds `lo`
        and `up` (finite; 0 where a bound is infinite or the column
        inactive) and its counts of infinite bounds that would enter
        them (`inf_lo`, `inf_up`: the columns whose lower or upper bound
        is infinite): the host's
            minact = max(A, 0) @ lo + min(A, 0) @ up,
            maxact = max(A, 0) @ up + min(A, 0) @ lo,
            n_min_inf = (A > 0) @ inf_lo + (A < 0) @ inf_up,
            n_max_inf = (A > 0) @ inf_up + (A < 0) @ inf_lo,
        over the stored entries (an entry of an inactive column adds 0),
        in float64, bit for bit.  The same bounds on the same copy are
        computed once: the families of a pass share them."""
        inputs = [np.ascontiguousarray(v, dtype=np.float64)
                  for v in (lo, up, inf_lo, inf_up)]
        last = self._activity
        if last is not None and last[0] is self.host and all(
                np.array_equal(x.view(np.int64), y.view(np.int64))
                for x, y in zip(inputs, last[1])):
            return last[2]
        self._sweep()
        dev = self.device
        lo_t, up_t = (torch.from_numpy(v).to(dev) for v in inputs[:2])
        sums = signed_dot(self.r_val, self.r_col, self.r_ptr, lo_t, up_t)
        inf_lo_t, inf_up_t = (self._mask(v != 0) for v in inputs[2:])
        pos, neg = self.r_val > 0, self.r_val < 0
        n_min = (pos & inf_lo_t[self.r_col]) | (neg & inf_up_t[self.r_col])
        n_max = (pos & inf_up_t[self.r_col]) | (neg & inf_lo_t[self.r_col])
        counts = torch.stack([_segment_total(n_min, self.r_ptr),
                              _segment_total(n_max, self.r_ptr)])
        minact = (sums[0] + sums[1]).cpu().numpy()
        maxact = (sums[2] + sums[3]).cpu().numpy()
        counts = counts.to(torch.float64).cpu().numpy()
        result = (minact, maxact, counts[0], counts[1])
        self._activity = (self.host, inputs, result)
        return result

    def _hash(self, live, lines, others, vals, ptr, nlines):
        """The multiset hash of each line's (other index, value over the
        line's first live value rounded to 10 decimals) pairs, and its
        count of live entries: the host's
            h = (other * Q) ^ bits(round(v / first, 10))
            h = (h ^ (h >> 30)) * MIX, summed a line,  * Q + count."""
        count = _segment_total(live, ptr)
        where = torch.where(live, torch.arange(
            self.nnz, device=self.device), self.nnz)
        first = torch.full((nlines,), self.nnz, dtype=torch.int64,
                           device=self.device).scatter_reduce_(
            0, lines.long(), where, "amin")
        has = count > 0
        first_val = torch.ones(nlines, dtype=vals.dtype, device=self.device)
        first_val[has] = vals[first[has]]
        ratio = torch.round(vals / first_val[lines] * 1e10) / 1e10
        h = (others.long() * _Q) ^ ratio.view(torch.int64)
        h = (h ^ ((h >> 30) & _LOW34)) * _MIX
        h = torch.where(live, h, 0)
        return _segment_total(h, ptr) * _Q + count, count, first_val

    def parallel_rows(self, row_active: np.ndarray, col_active: np.ndarray
                      ) -> List[Tuple[np.ndarray, np.ndarray]]:
        """The active rows with live entries grouped by hash (groups of
        two or more), each as (rows, each row's first live value), in the
        order the host's dict gave."""
        self._sweep()
        m = self.host.shape[0]
        live = self._live(row_active, col_active, self.r_row, self.r_col,
                          self.r_val)
        key, count, first_val = self._hash(live, self.r_row, self.r_col,
                                           self.r_val, self.r_ptr, m)
        members, gid = _groups(key, self._mask(row_active) & (count > 0))
        firsts = first_val[members].cpu().numpy()
        members = members.cpu().numpy()
        return [(members[g], firsts[g])
                for g in _split(members, gid.cpu().numpy())]

    def parallel_cols(self, row_active: np.ndarray, col_active: np.ndarray,
                      candidates: np.ndarray) -> List[np.ndarray]:
        """The `candidates` columns grouped by hash (groups of two or
        more), in the order the host's dict gave."""
        self._sweep()
        n = self.host.shape[1]
        live = self._live(row_active, col_active, self.c_row, self.c_col,
                          self.c_val)
        key, _, _ = self._hash(live, self.c_col, self.c_row, self.c_val,
                               self.c_ptr, n)
        members, gid = _groups(key, self._mask(candidates))
        members = members.cpu().numpy()
        return [members[g] for g in _split(members, gid.cpu().numpy())]

    def live_csr(self, row_active: np.ndarray, col_active: np.ndarray
                 ) -> sp.csr_matrix:
        """The live entries as a host CSR: the masked matrix."""
        self._sweep()
        m, n = self.host.shape
        live = self._live(row_active, col_active, self.r_row, self.r_col,
                          self.r_val)
        ptr = torch.cat([torch.zeros(1, dtype=torch.int64,
                                     device=self.device),
                         torch.cumsum(live, 0)])[self.r_ptr]
        return sp.csr_matrix((self.r_val[live].cpu().numpy(),
                              self.r_col[live].cpu().numpy(),
                              ptr.cpu().numpy()), shape=(m, n))
