"""The traced run's reduction on a synthetic timeline."""

import pytest

from portbench.harness import trace


def test_portbench_busy_time_is_the_union_inside_the_window():
    host = [(0, 1000, "portbench.window"), (0, 400, "portbench.decode"), (400, 1000, "portbench.verify_call")]
    device = [(450, 500, "k1"), (480, 520, "k2"), (600, 700, "k1"), (900, 1200, "copy"), (-50, 10, "early")]
    out = trace.reduce(device, host)
    assert out["window_s"] == pytest.approx(1000e-9)
    assert out["busy_s"] == pytest.approx((10 + 70 + 100 + 100) * 1e-9)
    assert out["device_ops"][0] == ["k1", pytest.approx(150e-9)]
    gaps = dict((round(t * 1e9), n) for n, t in out["idle_gaps"])
    assert gaps[440] == "portbench.decode" and gaps[80] == "portbench.verify_call"
    assert [t for _, t in out["idle_gaps"]] == sorted((t for _, t in out["idle_gaps"]), reverse=True)


def test_portbench_no_window_no_reduction():
    with pytest.raises(RuntimeError):
        trace.reduce([(0, 1, "k")], [(0, 1, "portbench.decode")])


def test_portbench_names_are_cleaned():
    assert trace.clean("void at::native::kernel<int, 4>(float*)") == "void_at__native__kernel_int__4__float__"
