"""Device-side constraint-matrix operators.

The PDHG hot loop needs exactly two products: `A @ x` and `A' @ y`
(the reference's only PDLP kernel too, highs/pdlp/hipdlp/pdhg.cc).  The
right representation depends on size and sparsity; every format of the
JAX package has a counterpart here, under the same name:

- `DenseMatrix` ("dense"): the matrix padded into one dense (m, n)
  array; both products are one `torch.mv` each.
- `EllMatrix` ("ell"): padded ELL with a COO spill tail, for scattered
  sparsity too large to store dense.
- `PanelEllMatrix` ("panelell"), `BucketPanelEllMatrix` ("bucketell"),
  `BucketPermEllMatrix` ("bucketperm"): panel-gather ELL, which gathers
  the whole 128-wide panel of x a nonzero's column lives in and picks
  the lane with a compare; one width, a ladder of widths by row count,
  or the ladder over a matrix pre-permuted into bucket order.
- `BcooMatrix` ("bcoo"): one `torch.sparse` CSR product each way.
- `BlockCsrMatrix` ("blockcsr", ops/block_csr.py): dense 128x128 tiles
  in a CSR-of-blocks layout, with a hand-written CUDA kernel.
- `OneHotSpmv` ("onehot", ops/onehot_spmv.py): padded 128x128 cells for
  scattered sparsity, with hand-written CUDA gather and scatter kernels.

Every `from_scipy*` function puts its operator on the device it is
given, CUDA by default (`device.resolve_device`).
"""
from __future__ import annotations

import warnings
from typing import NamedTuple, Tuple, Union

import numpy as np
import scipy.sparse as sp
import torch

from ..device import resolve_device
from .block_csr import BlockCsrMatrix, from_scipy_block_csr
from .onehot_spmv import OneHotSpmv, from_scipy_onehot

LANES = 128  # width of a panel of x


class DenseMatrix(NamedTuple):
    a: torch.Tensor  # (m, n)

    @property
    def shape(self):
        return tuple(self.a.shape)

    def mv(self, x):
        """A @ x."""
        return torch.mv(self.a, x)

    def rmv(self, y):
        """A' @ y."""
        return torch.mv(self.a.t(), y)


def _add_tail(out, x, seg, col, val):
    """out + the COO tail's products summed into their rows."""
    if seg.shape[0]:
        out = out.index_add(0, seg, val * x.index_select(0, col))
    return out


class EllMatrix(NamedTuple):
    """Padded-ELL operator with a COO spill tail.

    Each product is `sum(val * x[idx], axis=1)`, plus the entries of
    rows longer than the ELL width, summed into their rows with one
    `index_add_`."""
    idx: torch.Tensor       # (m, w)  int64 column indices, 0-padded
    val: torch.Tensor       # (m, w)  values, 0-padded
    idx_t: torch.Tensor     # (n, wt) transpose ELL
    val_t: torch.Tensor
    tail_seg: torch.Tensor    # (t,) row ids (sorted) of spilled entries
    tail_col: torch.Tensor    # (t,)
    tail_val: torch.Tensor    # (t,)
    tail_seg_t: torch.Tensor  # transpose spill
    tail_col_t: torch.Tensor
    tail_val_t: torch.Tensor

    @property
    def shape(self):
        return (self.idx.shape[0], self.idx_t.shape[0])

    @staticmethod
    def _half(x, idx, val, tail_seg, tail_col, tail_val):
        return _add_tail(torch.sum(val * x[idx], dim=1), x, tail_seg,
                         tail_col, tail_val)

    def mv(self, x):
        return self._half(x, self.idx, self.val, self.tail_seg,
                          self.tail_col, self.tail_val)

    def rmv(self, y):
        return self._half(y, self.idx_t, self.val_t, self.tail_seg_t,
                          self.tail_col_t, self.tail_val_t)


def _spill(csr: sp.csr_matrix, rows: np.ndarray, w: int):
    """(seg, col, val) of the entries past the first w of each of
    `rows`, in row order: the COO tail of an ELL layout."""
    cnt = np.diff(csr.indptr)[rows]
    spill_len = cnt - w
    seg = np.repeat(rows, spill_len)
    pos = (np.repeat(csr.indptr[rows] + w, spill_len) +
           np.arange(spill_len.sum()) -
           np.repeat(np.cumsum(spill_len) - spill_len, spill_len))
    return seg, csr.indices[pos], csr.data[pos].astype(np.float64)


def ell_layout(csr: sp.csr_matrix):
    """(idx, val, tail_seg, tail_col, tail_val) numpy arrays for one
    orientation: width min(max row, 4 * mean row + 4), longer rows
    spill to a row-sorted COO tail."""
    nr = csr.shape[0]
    cnt = np.diff(csr.indptr)
    mean_w = max(1.0, float(cnt.mean()))
    w = int(min(cnt.max() if nr else 1, np.ceil(4.0 * mean_w) + 4))
    idx = np.zeros((nr, w), np.int64)
    val = np.zeros((nr, w), np.float64)
    take = np.minimum(cnt, w)
    for k in range(w):
        sel = take > k
        pos = csr.indptr[:-1][sel] + k
        idx[sel, k] = csr.indices[pos]
        val[sel, k] = csr.data[pos]
    seg, col, tval = _spill(csr, np.nonzero(cnt > w)[0], w)
    return idx, val, seg.astype(np.int64), col.astype(np.int64), tval


def from_scipy_ell(mat: sp.spmatrix, dtype=torch.float64,
                   device=None) -> EllMatrix:
    device = resolve_device(device)

    def dev(a, dt=None):
        return torch.as_tensor(a, dtype=dt, device=device)

    halves = []
    for csr in (mat.tocsr(), mat.T.tocsr()):
        idx, val, seg, col, tval = ell_layout(csr)
        halves.append((dev(idx), dev(val, dtype), dev(seg), dev(col),
                       dev(tval, dtype)))
    (i_a, v_a, s_a, c_a, t_a), (i_t, v_t, s_t, c_t, t_t) = halves
    return EllMatrix(i_a, v_a, i_t, v_t, s_a, c_a, t_a, s_t, c_t, t_t)


# --- panel-gather ELL --------------------------------------------------

def _panel_product(x, panel, lane, val):
    """sum_k val[:, k] * x[128 panel[:, k] + lane[:, k]], as the panel
    formats compute it: one batched gather of the 128-wide panels of x
    and one compare-and-reduce over their lanes."""
    r, w = panel.shape
    rows = x.reshape(-1, LANES).index_select(0, panel.reshape(-1)).view(
        r, w, LANES)
    lanes = torch.arange(LANES, dtype=lane.dtype, device=lane.device)
    pick = torch.where(lane.unsqueeze(-1) == lanes, rows, 0).sum(-1)
    return (val * pick).sum(1)


class PanelEllMatrix(NamedTuple):
    """Panel-gather ELL operator: per row, up to w (panel, lane, value)
    slots, the width the p92 row count of the nonempty rows; longer
    rows spill to a sorted COO tail."""
    panel: torch.Tensor   # (m, w) int32 column panels (col // 128)
    lane: torch.Tensor    # (m, w) int32 lanes (col % 128)
    val: torch.Tensor     # (m, w) values, 0-padded
    panel_t: torch.Tensor  # transpose side
    lane_t: torch.Tensor
    val_t: torch.Tensor
    tail_seg: torch.Tensor  # COO spill (sorted by row), int32
    tail_col: torch.Tensor
    tail_val: torch.Tensor
    tail_seg_t: torch.Tensor
    tail_col_t: torch.Tensor
    tail_val_t: torch.Tensor

    @property
    def shape(self):
        return (self.panel.shape[0], self.panel_t.shape[0])

    def mv(self, x):
        return _add_tail(_panel_product(x, self.panel, self.lane, self.val),
                         x, self.tail_seg, self.tail_col, self.tail_val)

    def rmv(self, y):
        return _add_tail(
            _panel_product(y, self.panel_t, self.lane_t, self.val_t), y,
            self.tail_seg_t, self.tail_col_t, self.tail_val_t)


def _panel_slots(csr: sp.csr_matrix, rows: np.ndarray, w: int):
    """(panel, lane, val) of the first w entries of each of `rows`."""
    cnt = np.diff(csr.indptr)[rows]
    take = np.minimum(cnt, w)
    panel = np.zeros((rows.size, w), np.int32)
    lane = np.zeros((rows.size, w), np.int32)
    val = np.zeros((rows.size, w), np.float64)
    for k in range(w):
        sel = take > k
        pos = csr.indptr[rows[sel]] + k
        panel[sel, k] = csr.indices[pos] // LANES
        lane[sel, k] = csr.indices[pos] % LANES
        val[sel, k] = csr.data[pos]
    return panel, lane, val


def panel_ell_layout(csr: sp.csr_matrix, width_pct: float = 92.0):
    """(panel, lane, val, tail_seg, tail_col, tail_val) numpy arrays of
    one side.  Requires csr.shape[1] % 128 == 0 (the caller pads)."""
    nr = csr.shape[0]
    cnt = np.diff(csr.indptr)
    if nr == 0 or cnt.max(initial=0) == 0:
        w = 1
    else:
        # percentile over the nonempty rows only: padding rows are empty
        # and would deflate the width, spilling real nonzeros
        w = max(1, int(np.percentile(cnt[cnt > 0], width_pct)))
    panel, lane, val = _panel_slots(csr, np.arange(nr), w)
    seg, col, tval = _spill(csr, np.nonzero(cnt > w)[0], w)
    return (panel, lane, val, seg.astype(np.int32), col.astype(np.int32),
            tval)


def _aligned_csr(mat: sp.spmatrix, what: str):
    m, n = mat.shape
    if m % LANES or n % LANES:
        raise ValueError(f"{what} needs a 128-aligned shape, got {(m, n)}")
    csr = mat.tocsr(copy=True)
    csr.sum_duplicates()
    return csr


def from_scipy_panel_ell(mat: sp.spmatrix, dtype=torch.float64,
                         device=None) -> PanelEllMatrix:
    """Both dimensions must be multiples of 128 (the PDLP wrapper's
    padding guarantees it): the products view x as (n/128, 128)
    panels."""
    device = resolve_device(device)
    csr = _aligned_csr(mat, "PanelEllMatrix")
    sides = []
    for half in (csr, csr.T.tocsr()):
        p, ln, v, s, c, t = panel_ell_layout(half)
        sides.append((torch.as_tensor(p, device=device),
                      torch.as_tensor(ln, device=device),
                      torch.as_tensor(v, dtype=dtype, device=device),
                      torch.as_tensor(s, device=device),
                      torch.as_tensor(c, device=device),
                      torch.as_tensor(t, dtype=dtype, device=device)))
    (p_a, l_a, v_a, s_a, c_a, t_a), (p_t, l_t, v_t, s_t, c_t, t_t) = sides
    return PanelEllMatrix(p_a, l_a, v_a, p_t, l_t, v_t, s_a, c_a, t_a,
                          s_t, c_t, t_t)


# --- bucketed panel-gather ELL ------------------------------------------

BUCKET_WIDTHS = (2, 4, 6, 8, 12, 16, 24, 32, 48, 64)


def _bucket_rows(cnt: np.ndarray):
    """The rows of each width bucket in ladder order, then the rows
    longer than the top width, then the empty rows."""
    buckets = []
    prev = 0
    for w in BUCKET_WIDTHS:
        sel = np.nonzero((cnt > prev) & (cnt <= w))[0]
        prev = w
        if sel.size:
            buckets.append((w, sel))
    return (buckets, np.nonzero(cnt > BUCKET_WIDTHS[-1])[0],
            np.nonzero(cnt == 0)[0])


def bucket_row_perm(csr: sp.csr_matrix) -> np.ndarray:
    """The row order the bucket ladder assigns: width buckets ascending,
    then long rows, then empty rows.  A matrix permuted by this has its
    bucket outputs in natural order."""
    buckets, long_rows, empty = _bucket_rows(np.diff(csr.indptr))
    order = [sel for _, sel in buckets]
    order += [r for r in (long_rows, empty) if r.size]
    return (np.concatenate(order) if order
            else np.zeros(0, dtype=np.int64))


def bucket_panel_layout(csr: sp.csr_matrix):
    """(buckets, inv, tail_seg, tail_col, tail_val) numpy arrays of one
    side: buckets is a list of (panel, lane, val) per nonempty width
    bucket, the long rows' first 64 entries riding a last top-width
    bucket and the rest spilling to the tail; `inv` maps each row to its
    place in the concatenated bucket outputs."""
    nr = csr.shape[0]
    buckets, long_rows, _ = _bucket_rows(np.diff(csr.indptr))
    wmax = BUCKET_WIDTHS[-1]
    if long_rows.size:
        buckets.append((wmax, long_rows))
    layout = [_panel_slots(csr, rows, w) for w, rows in buckets]
    perm = bucket_row_perm(csr)
    inv = np.empty(nr, dtype=np.int32)
    inv[perm] = np.arange(nr, dtype=np.int32)
    seg, col, tval = _spill(csr, long_rows, wmax)
    return (layout, inv, seg.astype(np.int32), col.astype(np.int32), tval)


def _bucket_outputs(x, buckets, m):
    """The concatenated bucket products, zeros for the empty rows."""
    outs = [_panel_product(x, panel, lane, val)
            for panel, lane, val in buckets]
    done = sum(b[0].shape[0] for b in buckets)
    if done < m:  # empty rows come last and compute nothing
        outs.append(torch.zeros((m - done,), dtype=x.dtype, device=x.device))
    return torch.cat(outs) if len(outs) > 1 else outs[0]


class BucketPanelEllMatrix(NamedTuple):
    """Bucketed panel-gather ELL: rows grouped by nonzero count into the
    width ladder BUCKET_WIDTHS, each bucket padded to its own width; the
    bucket outputs are put back in row order with one gather (`inv`)."""
    fwd: tuple          # per-bucket (panel, lane, val), row side
    inv: torch.Tensor   # (m,) int32: concat(bucket outputs)[inv] = out
    fwd_t: tuple        # transpose side
    inv_t: torch.Tensor
    tail_seg: torch.Tensor
    tail_col: torch.Tensor
    tail_val: torch.Tensor
    tail_seg_t: torch.Tensor
    tail_col_t: torch.Tensor
    tail_val_t: torch.Tensor

    @property
    def shape(self):
        return (self.inv.shape[0], self.inv_t.shape[0])

    def mv(self, x):
        out = _bucket_outputs(x, self.fwd, self.inv.shape[0])
        return _add_tail(out.index_select(0, self.inv), x, self.tail_seg,
                         self.tail_col, self.tail_val)

    def rmv(self, y):
        out = _bucket_outputs(y, self.fwd_t, self.inv_t.shape[0])
        return _add_tail(out.index_select(0, self.inv_t), y,
                         self.tail_seg_t, self.tail_col_t, self.tail_val_t)


class BucketPermEllMatrix(NamedTuple):
    """Bucket-panel ELL over a PRE-PERMUTED matrix: the caller bakes the
    bucket row order (for `mv`) and column order (for `rmv`) into the
    problem, so the bucket outputs concatenate straight into the result
    with no un-permute gather."""
    fwd: tuple   # per-bucket (panel, lane, val)
    fwd_t: tuple
    tails: tuple  # (seg, col, val, seg_t, col_t, val_t)
    shape: Tuple[int, int]

    def mv(self, x):
        s, c, v, _, _, _ = self.tails
        return _add_tail(_bucket_outputs(x, self.fwd, self.shape[0]), x,
                         s, c, v)

    def rmv(self, y):
        _, _, _, s, c, v = self.tails
        return _add_tail(_bucket_outputs(y, self.fwd_t, self.shape[1]), y,
                         s, c, v)


def _bucket_sides(mat, dtype, device, what):
    csr = _aligned_csr(mat, what)
    sides = []
    for half in (csr, csr.T.tocsr()):
        layout, inv, seg, col, tval = bucket_panel_layout(half)
        buckets = tuple(
            (torch.as_tensor(p, device=device),
             torch.as_tensor(ln, device=device),
             torch.as_tensor(v, dtype=dtype, device=device))
            for p, ln, v in layout)
        sides.append((buckets, inv, torch.as_tensor(seg, device=device),
                      torch.as_tensor(col, device=device),
                      torch.as_tensor(tval, dtype=dtype, device=device)))
    return sides


def from_scipy_bucket_panel_ell(mat: sp.spmatrix, dtype=torch.float64,
                                device=None) -> BucketPanelEllMatrix:
    """Build a BucketPanelEllMatrix (128-aligned shape required)."""
    device = resolve_device(device)
    (b_a, i_a, s_a, c_a, t_a), (b_t, i_t, s_t, c_t, t_t) = _bucket_sides(
        mat, dtype, device, "BucketPanelEllMatrix")
    return BucketPanelEllMatrix(
        b_a, torch.as_tensor(i_a, device=device), b_t,
        torch.as_tensor(i_t, device=device), s_a, c_a, t_a, s_t, c_t, t_t)


def from_scipy_bucket_perm(mat: sp.spmatrix, dtype=torch.float64,
                           device=None) -> BucketPermEllMatrix:
    """Build the presorted-bucket operator.  `mat` must ALREADY be
    permuted by (bucket_row_perm(mat), bucket_row_perm(mat.T)): the
    check here is that the bucket order is the identity."""
    device = resolve_device(device)
    (b_a, i_a, s_a, c_a, t_a), (b_t, i_t, s_t, c_t, t_t) = _bucket_sides(
        mat, dtype, device, "BucketPermEllMatrix")
    m, n = mat.shape
    if not np.array_equal(i_a, np.arange(m)) or \
            not np.array_equal(i_t, np.arange(n)):
        raise ValueError("matrix not in bucket order: permute it with "
                         "bucket_row_perm first")
    return BucketPermEllMatrix(b_a, b_t, (s_a, c_a, t_a, s_t, c_t, t_t),
                               (m, n))


# --- sparse CSR products ------------------------------------------------

class BcooMatrix(NamedTuple):
    """A and A' as `torch.sparse` CSR tensors: one sparse product each
    way (the JAX package's BCOO operator)."""
    a: torch.Tensor
    at: torch.Tensor  # the transpose, materialized for A' y

    @property
    def shape(self):
        return tuple(self.a.shape)

    def mv(self, x):
        return torch.mv(self.a, x)

    def rmv(self, y):
        return torch.mv(self.at, y)


def _sparse_csr(csr: sp.csr_matrix, dtype, device) -> torch.Tensor:
    with warnings.catch_warnings():  # sparse CSR tensors are in beta
        warnings.simplefilter("ignore", UserWarning)
        return torch.sparse_csr_tensor(
            torch.as_tensor(csr.indptr.astype(np.int64), device=device),
            torch.as_tensor(csr.indices.astype(np.int64), device=device),
            torch.as_tensor(csr.data, dtype=dtype, device=device),
            size=csr.shape)


def dense_from_csc(start, index, value, shape, device) -> torch.Tensor:
    """A dense f64 matrix of `shape` on `device` from CSC arrays over its
    leading len(start) - 1 columns, built there: only the nonzeros cross
    to the device, and the host never holds the matrix dense.  The host
    sums duplicates first, so the scatter writes each entry once (no
    atomics: the same bits on every run and device)."""
    start = np.asarray(start, dtype=np.int64)
    out = torch.zeros(shape, dtype=torch.float64, device=device)
    nnz = int(start[-1]) if len(start) > 1 else 0
    if not nnz:
        return out
    csc = sp.csc_matrix(
        (np.asarray(value[:nnz], dtype=np.float64), np.asarray(index[:nnz]),
         start), shape=(shape[0], len(start) - 1), copy=True)
    csc.sum_duplicates()
    nnz = csc.nnz  # from the host: nothing waits on the device
    cols = torch.repeat_interleave(
        torch.arange(csc.shape[1], device=device),
        torch.as_tensor(np.diff(csc.indptr).astype(np.int64), device=device),
        output_size=nnz)
    rows = torch.as_tensor(csc.indices.astype(np.int64), device=device)
    out.index_put_((rows, cols), torch.as_tensor(csc.data, device=device))
    return out


def from_scipy_bcoo(mat: sp.spmatrix, dtype=torch.float64,
                    device=None) -> BcooMatrix:
    device = resolve_device(device)
    csr = mat.tocsr(copy=True)
    csr.sum_duplicates()
    return BcooMatrix(_sparse_csr(csr, dtype, device),
                      _sparse_csr(csr.T.tocsr(), dtype, device))


LinOp = Union[DenseMatrix, EllMatrix, PanelEllMatrix, BucketPanelEllMatrix,
              BucketPermEllMatrix, BcooMatrix, BlockCsrMatrix, OneHotSpmv]


def linop_dtype(op) -> torch.dtype:
    """The value type of an operator's entries, for every format."""
    if isinstance(op, DenseMatrix):
        return op.a.dtype
    if isinstance(op, (EllMatrix, PanelEllMatrix)):
        return op.val.dtype
    if isinstance(op, BucketPanelEllMatrix):
        return op.tail_val.dtype
    if isinstance(op, BucketPermEllMatrix):
        return op.tails[2].dtype
    if isinstance(op, BcooMatrix):
        return op.a.values().dtype
    if isinstance(op, (BlockCsrMatrix, OneHotSpmv)):
        return op.dtype
    if hasattr(op, "value_dtype"):  # the operators of parallel/shard_ops
        return op.value_dtype()
    raise TypeError(f"unknown operator type {type(op).__name__}")


def cast_linop(op, dtype):
    """Low-precision copy of an operator (float values only), for
    mixed-precision PDHG stepping: the step products run on the copy,
    residuals and metrics on the full-precision operator.  Returns None
    for the formats that have no low-precision path (as in the JAX
    package: all but dense, ELL and panel ELL)."""
    if isinstance(op, DenseMatrix):
        return DenseMatrix(op.a.to(dtype))
    if isinstance(op, (EllMatrix, PanelEllMatrix)):
        return op._replace(
            val=op.val.to(dtype), val_t=op.val_t.to(dtype),
            tail_val=op.tail_val.to(dtype),
            tail_val_t=op.tail_val_t.to(dtype))
    if hasattr(op, "astype_values"):  # the operators of parallel/shard_ops
        if all(isinstance(s, (DenseMatrix, EllMatrix, PanelEllMatrix))
               for s in op.local_operators()):
            return op.astype_values(dtype)
    return None


def choose_format(mat: sp.spmatrix, dtype: torch.dtype) -> str:
    """The `choose` rule: dense while the dense array is at most 256 MB;
    beyond that block-CSR when the 128x128 tile structure is compact
    (fill >= 0.2, tiles <= 2 GB), else ELL.  (The JAX package picks a
    panel-gather ELL on the TPU there, whose element gathers are slow;
    on CUDA this package picks ELL, see ROADMAP "Decisions".)"""
    m, n = mat.shape
    itemsize = dtype.itemsize
    if m * n * itemsize <= (256 << 20):
        return "dense"
    coo = mat.tocoo()
    n_col_tiles = (n + 127) // 128
    tiles = np.unique((coo.row.astype(np.int64) // 128) * n_col_tiles +
                      coo.col.astype(np.int64) // 128).size
    tile_bytes = max(1, tiles) * 128 * 128 * itemsize
    fill = mat.nnz * itemsize / tile_bytes
    if fill >= 0.2 and tile_bytes <= (2048 << 20):
        return "blockcsr"
    return "ell"


_FROM_SCIPY = {
    "ell": from_scipy_ell,
    "panelell": from_scipy_panel_ell,
    "bucketell": from_scipy_bucket_panel_ell,
    "bucketperm": from_scipy_bucket_perm,
    "bcoo": from_scipy_bcoo,
    "blockcsr": from_scipy_block_csr,
    "onehot": from_scipy_onehot,
}


def from_scipy(mat: sp.spmatrix, fmt: str = "choose",
               dtype=torch.float64, device=None) -> LinOp:
    """Build an operator on `device` (default CUDA) from a scipy sparse
    matrix.  fmt: "choose", "dense" or a key of _FROM_SCIPY ("bucketperm"
    takes a matrix already in bucket order, as the PDLP wrapper makes
    it)."""
    device = resolve_device(device)
    if fmt == "choose":
        fmt = choose_format(mat, dtype)
    if fmt == "dense":
        # full-precision products, as the JAX package's HIGHEST
        torch.backends.cuda.matmul.allow_tf32 = False
        return DenseMatrix(torch.as_tensor(mat.toarray(), dtype=dtype,
                                           device=device))
    if fmt not in _FROM_SCIPY:
        raise ValueError(f"unknown matrix format {fmt!r}")
    return _FROM_SCIPY[fmt](mat, dtype=dtype, device=device)
