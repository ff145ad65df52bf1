"""The profiled slice's arithmetic on hand-made intervals (the card's
profiler output is read only on the card)."""

import pytest

from pbcore.trace import Slice


def test_busy_window_kernels_and_gaps():
    ms = 1_000_000  # ns
    dev = [("k_a", 0, 2 * ms), ("k_b", 1 * ms, 3 * ms), ("memcpy", 5 * ms, 6 * ms),
           ("k_a", 10 * ms, 11 * ms)]
    host = [("aten::outer", 0, 12 * ms), ("aten::nonzero", 6 * ms, 9 * ms),
            ("aten::mm", 3 * ms, 5 * ms)]
    s = Slice(device_ops=dev, host_ops=sorted(host, key=lambda r: r[1]), units=2)
    assert s.merged() == [[0, 3 * ms], [5 * ms, 6 * ms], [10 * ms, 11 * ms]]
    assert s.busy_s() == pytest.approx(5e-3)
    assert s.window_s() == pytest.approx(11e-3)
    assert s.kernel_s(("k_a",)) == pytest.approx(3e-3)
    assert s.top_ops(2) == [["k_a", pytest.approx(3e-3)], ["k_b", pytest.approx(2e-3)]]
    # gaps 3-5 ms (host in aten::mm at 4) and 6-10 ms (aten::outer at 8:
    # aten::nonzero ended at 9 > 8, so it is the innermost there)
    assert s.idle_gaps() == [["aten::nonzero", pytest.approx(4e-3)],
                             ["aten::mm", pytest.approx(2e-3)]]
