"""One greedy-sampler iteration's pass over the domain (S slots x D
sites), entered through the `downdate` argument of
como_tpu_torch.gp.sampler.greedy_entropy_loop (sampler_cuda.downdate_step:
the hand-written kernel on CUDA).

Bytes its inputs need: the rows of obs_info already filled (`rows`: the
call writes row `row`, so rows 0..row-1 enter its dot product; the others
are zero and multiplied by zero), the domain's coords and covs (5 D), var
and min_dist_sq read and written (4 D), the new row written (D), l_ni (S)
and the 8 scalars.  With every row live (rows = S) this is PERF.md's
bound: 4 (S D + 10 D + S + 8) bytes, 4.34 us at 64 x 49,152.
Operations: a cross-covariance per site (36), the row dot product (2 per
live row) and 8 more."""

from __future__ import annotations

OPS_PER_SITE = 36 + 8


def shape_of(xnT, enT, obs_info, var, min_dist_sq, sc, l_ni, row):
    return {"S": int(obs_info.shape[0]), "D": int(obs_info.shape[1]), "rows": int(row)}


def nbytes(S: int, D: int, rows: int) -> int:
    return 4 * (rows * D + 10 * D + S + 8)


def nops(S: int, D: int, rows: int) -> int:
    return D * (OPS_PER_SITE + 2 * rows)


def install(patch) -> None:
    import como_tpu_torch.gp.sampler as sampler

    patch(sampler.greedy_entropy_loop, "downdate", shape_of)
