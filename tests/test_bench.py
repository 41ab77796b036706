"""``bench.py``'s peak table: the H100 by its device kind; an unknown
device is an error, not a guess."""

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import bench  # noqa: E402


class _Dev:
    def __init__(self, kind):
        self.device_kind = kind


def test_peak_flops_h100():
    # FP32 outside the tensor cores: the program runs complex64 products
    # at "highest" precision
    assert bench.peak_flops(_Dev("NVIDIA H100 80GB HBM3")) == 67e12


@pytest.mark.parametrize("kind", ["cpu", "NVIDIA A100-SXM4-80GB", ""])
def test_peak_flops_unknown_device_raises(kind):
    with pytest.raises(KeyError, match="no peak"):
        bench.peak_flops(_Dev(kind))
