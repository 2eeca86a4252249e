"""The GP cross-covariance K(X_n, X_m) (N sites x M anchors), entered
through como_tpu_torch.gp.kernels.cross_covariance (the hand-written
kernel on CUDA at every size).

Bytes its inputs need: the sites' coords and packed covs (5 floats each),
the anchors' (5 each), read once, and the (N, M) f32 output written once.
Operations: 36 f32 operations per output (special functions counted as
one), the count of PERF.md's kernel table."""

from __future__ import annotations

OPS_PER_OUTPUT = 36


def shape_of(x_n, e_n, x_m, e_m, scale):
    return {"N": int(x_n.shape[0]), "M": int(x_m.shape[0])}


def nbytes(N: int, M: int) -> int:
    return 4 * (5 * N + 5 * M + N * M)


def nops(N: int, M: int) -> int:
    return OPS_PER_OUTPUT * N * M


def install(patch) -> None:
    import como_tpu_torch.gp.kernels as kernels

    patch(kernels, "cross_covariance", shape_of)
