"""Reading a traced window back: the window's marks, the device's
operations taken in by their launches, the busy union without the
profiler's own annotations, kernel counts against the launch counters, and
idle gaps labelled by the host's events."""

import pb_tiny  # noqa: F401
import pytest

from harness import tracing


class Ev:
    def __init__(self, name, start, dur, device=False, annotation=False,
                 corr=0):
        self._n, self._s, self._d = name, start, dur
        self._dev, self._ann, self._c = device, annotation, corr

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def device_type(self):
        return "DeviceType.CUDA" if self._dev else "DeviceType.CPU"

    def is_user_annotation(self):
        return self._ann

    def correlation_id(self):
        return self._c


class Kineto:
    def __init__(self, events):
        self._e = events

    def events(self):
        return self._e


K = "void (anonymous namespace)::fused_step_cluster_kernel<bf16>(x)"


def launch(at, corr, name="cudaLaunchKernelExC"):
    return Ev(name, at, 5, corr=corr)


def trace(extra=(), drift=0):
    """A window from 1000 to 10000 ns on the host's clock; ``drift`` moves
    the device's timestamps against it."""
    return Kineto([
        Ev(tracing.OPEN_MARK, 1000, 1),
        Ev("port_bench.decode", 1000, 9000),
        Ev("aten::argmax", 3000, 1500),
        launch(1100, 1), launch(1200, 2),
        launch(4800, 3, "cudaMemcpyAsync"),
        launch(400, 4), launch(11000, 5),
        Ev(K, 1500 + drift, 1000, device=True, corr=1),
        Ev(K, 2000 + drift, 1000, device=True, corr=2),  # overlaps the first
        Ev("Memcpy DtoH", 5000 + drift, 500, device=True, corr=3),
        Ev("port_bench.decode", 1000, 9000, device=True, annotation=True),
        Ev("ProfilerStep#1", 900, 20000, device=True),
        Ev(K, 500 + drift, 100, device=True, corr=4),    # before the window
        Ev(tracing.CLOSE_MARK, 10000, 1),
        Ev(K, 12000 + drift, 100, device=True, corr=5),  # after it
        *extra])


def test_busy_is_the_union_inside_the_marks():
    t = tracing.read_trace(trace(), 9e-6, {("f", "launches"): 2})
    assert t.busy_s == pytest.approx((3000 - 1500 + 500) * 1e-9)
    assert t.kernel_n == {K: 2, "Memcpy DtoH": 1}
    assert t.port_seen == 2 and t.complete
    assert t.kernel_seconds("fused_step_cluster_kernel") == pytest.approx(
        2000e-9)
    # the one gap (3000 to 5000) ran inside aten::argmax at its middle
    assert t.idle_gaps == [["aten::argmax", pytest.approx(2000e-9)]]


@pytest.mark.parametrize("drift", [-3000, 2500])
def test_the_window_takes_in_operations_by_their_launch(drift):
    """The device's clock off the host's by up to a third of the window:
    the same operations are in it, by their launches' host times."""
    t = tracing.read_trace(trace(drift=drift), 9e-6, {("f", "launches"): 2})
    assert t.kernel_n == {K: 2, "Memcpy DtoH": 1}
    assert t.busy_s == pytest.approx((3000 - 1500 + 500) * 1e-9)
    assert t.idle_gaps == [["aten::argmax", pytest.approx(2000e-9)]]
    assert t.complete and t.unlaunched == 0


def test_an_operation_without_its_launch_takes_the_offset_before_it():
    # the launched op before them on the device is the copy at device 5000,
    # launched at 4800: offset 200; an op at device 9500 lands at host
    # 9300, inside the window, one at device 10300 at 10100, outside it
    extra = (Ev("Memset", 9500, 10, device=True, corr=77),
             Ev("Memset", 10300, 10, device=True))
    t = tracing.read_trace(trace(extra), 9e-6, {("f", "launches"): 2})
    assert t.kernel_n["Memset"] == 1 and t.unlaunched == 1


def test_a_missed_launch_makes_the_trace_incomplete():
    t = tracing.read_trace(trace(), 9e-6, {("f", "launches"): 3})
    assert not t.complete


def test_a_trace_without_marks_is_refused():
    with pytest.raises(ValueError):
        tracing.read_trace(Kineto([Ev(K, 0, 10, device=True)]), 1.0, {})


def test_a_disabled_tracer_calls_through():
    tr = tracing.Tracer(False, 1.0)
    assert tr.call(lambda a, b: a + b, 2, 3) == 5
    tr.finish()
    assert tr.result() is None
