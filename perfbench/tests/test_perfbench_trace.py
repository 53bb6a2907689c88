"""The trace arithmetic on made-up events: busy and idle time, kernel time,
host waits inside the request spans, idle gaps by host op, the breakdown."""
import pytest

from perfbench import tracing

# a 100 us window: two requests, a kernel and a copy that overlap, a kernel
# that starts before the window, and a host wait inside the second request
DEVICE = [("void r2l_forward_kernel<128>(Maps, Args)", -10.0, 20.0),
          ("Memcpy DtoH (Device -> Pageable)", 15.0, 30.0),
          ("void r2l_forward_kernel<128>(Maps, Args)", 60.0, 90.0),
          ("elementwise_kernel", 95.0, 120.0)]
HOST = [(tracing.WINDOW_SPAN, 0.0, 100.0),
        (tracing.REQUEST_SPAN, 0.0, 45.0), (tracing.REQUEST_SPAN, 50.0, 100.0),
        ("aten::copy_", 12.0, 32.0), ("cudaMemcpy", 14.0, 31.0),
        ("aten::linear", 33.0, 58.0), ("aten::mm", 40.0, 41.0),
        ("cudaStreamSynchronize", 61.0, 89.0),
        ("cudaStreamSynchronize", 46.0, 49.0)]


@pytest.fixture
def trace():
    return tracing.Trace(DEVICE, HOST, (0.0, 100.0))


def test_busy_and_idle(trace):
    # busy [0, 30) + [60, 90) + [95, 100) = 65 us of 100
    assert trace.busy_s() == pytest.approx(65e-6)
    assert trace.window_s == pytest.approx(100e-6)
    assert trace.idle_share() == pytest.approx(35.0)
    assert trace.idle_gaps() == [(30.0, 60.0), (90.0, 95.0)]


def test_kernel_times(trace):
    assert trace.kernel_s(["r2l_forward_kernel"]) == pytest.approx(50e-6)
    assert trace.launches(["r2l_forward_kernel"]) == 2
    # the elementwise kernel is clipped to the window's last 5 us
    assert trace.kernel_s(["elementwise_kernel"]) == pytest.approx(5e-6)


def test_host_waits_inside_requests(trace):
    # 17 + 28 us inside the requests; the wait at 46-49 lies between them
    assert trace.host_calls_within_s(tracing.SYNC_CALLS, tracing.REQUEST_SPAN) == \
        pytest.approx(45e-6)


def test_gaps_by_host_op(trace):
    # gap [30, 60) at 45: aten::linear (aten::mm ended at 41); gap [90, 95) at
    # 92.5: only the request span
    got = trace.gaps_by_host_op()
    assert got == pytest.approx({"aten::linear": 30e-6, tracing.REQUEST_SPAN: 5e-6})


def test_breakdown(trace):
    b = trace.breakdown(n=2)
    assert [name for name, _ in b["device_ops"]] == [
        "void r2l_forward_kernel<128>(Maps, Args)", "Memcpy DtoH (Device -> Pageable)"]
    assert b["device_ops"][0][1] == pytest.approx(50e-6)
    assert b["idle_gaps"][0] == ["aten::linear", pytest.approx(30e-6)]


def test_union():
    assert tracing.union_us([(0, 10), (5, 7), (20, 30), (25, 40)]) == 30
