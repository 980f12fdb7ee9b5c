"""Radius-outlier decisions of two routes of the test, held to the
boundary pairs.  Numpy only, so that the card's tests, which import no
JAX, share it with the CPU tests."""

import numpy as np


def outlier_flips(points, valid, got, want, radius=0.02, min_neighbors=32,
                  ulps=8):
    """The count of points whose radius-outlier decisions differ, each
    asserted to hang on a pair within `ulps` f32 ulps (of |q|^2 + |k|^2)
    of the radius: the matmul form's q.k is a 3-term dot product whose
    rounding each route does in its own order (XLA's and torch's BLAS
    libraries, cuBLAS, and K9's stated order).  Such a point's neighbour count lies at the threshold within the
    boundary pairs."""
    bad = np.nonzero(got != want)[0]
    pts = points.astype(np.float64)
    sq = (pts * pts).sum(1)
    r2 = np.float64(np.float32(radius * radius))
    for i in bad:
        d = ((pts - pts[i]) ** 2).sum(1)
        tol = ulps * np.finfo(np.float32).eps * (sq[i] + sq)
        sure = ((d < r2 - tol) & valid).sum()
        maybe = ((np.abs(d - r2) <= tol) & valid).sum()
        assert valid[i] and maybe and sure < min_neighbors <= sure + maybe, (
            i, sure, maybe)
    return len(bad)
