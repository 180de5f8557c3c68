"""The trace reader: device busy as the union of kernel spans, sums by
kernel name, idle gaps by the host operator running; a trace with no
device record is taken once more and then reported missing."""
from perfbench.harness.trace import Records, traced


def records():
    kernels = [("a", 0.0, 1.0), ("b", 0.5, 1.5), ("a", 3.0, 4.0)]
    host = [("outer", -1.0, 10.0), ("aten::item", 1.6, 2.9)]
    return Records(kernels, host, window_s=5.0)


def test_busy_is_the_union():
    assert records().busy_s() == 2.5


def test_by_name_and_top():
    r = records()
    assert r.by_name(lambda n: n == "a") == (2.0, 2)
    assert r.top_kernels() == [["a", 2.0], ["b", 1.0]]


def test_idle_gap_named_by_innermost_host_operator():
    assert records().idle_gaps() == [["aten::item", 1.5]]


def test_no_device_record_is_missing_after_one_retry():
    calls = []

    def run():
        calls.append(1)
        return 1

    assert traced(run, "cpu") is None
    assert len(calls) == 2


def test_device_idle_is_over_the_untraced_time():
    """The traced window carries the profiler's own overhead: the idle
    share divides the trace's busy time by the same units' untraced time."""
    from perfbench.harness import cell

    ctx = cell.Context(records(), timed_s=4.0, units=2, work={}, cfg={},
                       mix={})
    for name in ("device_idle.train", "device_idle.replay"):
        assert cell.reader(name)(ctx) == 100.0 * (1 - 2.5 / 4.0)
