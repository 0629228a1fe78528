"""Matrix sparsity-pattern images.

Equivalent of the reference HighsMatrixPic (highs/util/HighsMatrixPic.h,
options write_matrix_image / write_hessian_image): dump the nonzero
pattern of the constraint matrix (or Hessian) as a portable bitmap for
eyeballing structure."""
from __future__ import annotations

import numpy as np
import scipy.sparse as sp


def write_matrix_pbm(mat: sp.spmatrix, filename: str,
                     max_dim: int = 1024) -> None:
    """Write the sparsity pattern as a PBM (P1) image, downsampling
    (logical-OR pooling) to at most max_dim pixels per side."""
    m, n = mat.shape
    if m == 0 or n == 0:
        with open(filename, "w") as f:
            f.write("P1\n1 1\n0\n")
        return
    coo = mat.tocoo()
    h = min(m, max_dim)
    w = min(n, max_dim)
    img = np.zeros((h, w), dtype=np.uint8)
    rows = (coo.row * h) // m
    cols = (coo.col * w) // n
    img[rows[coo.data != 0], cols[coo.data != 0]] = 1
    with open(filename, "w") as f:
        f.write(f"P1\n{w} {h}\n")
        for r in range(h):
            f.write(" ".join(str(int(v)) for v in img[r]) + "\n")
