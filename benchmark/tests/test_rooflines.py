"""The roofline bytes per shape give PERF.md's bound column."""

import pytest

from benchmark import peaks, spec

H100 = "NVIDIA H100 80GB HBM3"


def test_cross_covariance_bound_at_49152_x_64():
    mod = spec.load_module("rooflines", "cross_cov")
    t = peaks.bound_s(mod.nbytes(N=49152, M=64), mod.nops(N=49152, M=64), H100)
    assert t * 1e6 == pytest.approx(4.05, abs=0.005)


def test_downdate_bound_at_64_x_49152_with_every_row_live():
    mod = spec.load_module("rooflines", "downdate")
    t = peaks.bound_s(mod.nbytes(S=64, D=49152, rows=64), mod.nops(S=64, D=49152, rows=64),
                      H100)
    assert t * 1e6 == pytest.approx(4.34, abs=0.005)


def test_downdate_counts_only_the_rows_its_inputs_need():
    mod = spec.load_module("rooflines", "downdate")
    assert mod.nbytes(S=64, D=1000, rows=0) < mod.nbytes(S=64, D=1000, rows=63)
