"""The frozen counts against sums written out by hand at small shapes."""
import pytest
from _tiny import harness  # noqa: F401  (import paths)

from bench import counts
from bench.counts import heat


def test_delta_bound():
    # 200 bytes in blocks of 64: 4 blocks; both inputs read, 4 int32 written
    assert counts.delta_bound_s(200, 64) == pytest.approx((200 + 200 + 16) / 3.35e12)


def test_heat_bytes():
    assert heat.heat_iter_bytes(8192) == 3 * 8192 * 8192 * 4 == 805306368
    assert heat.iter_bytes({"app_args": {"grid": 32768}}) == 3 * 2**32

