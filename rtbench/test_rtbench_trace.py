"""The metric arithmetic on synthetic device events: the union of busy
intervals, the reorder pinned by its place between K1 launches, the glue,
the idle share against the untraced window, the rate over the whole
window."""

import pytest

from rtbench.core import registry, trace as tr
from rtbench.core.record import Run

K1 = "void rtf::seg_segment_kernel<false, false>(float*, int*)"
K6 = "void rtf::block_perm_kernel(int const*, float*)"
SORT = "void at_cuda_detail::cub::DeviceRadixSortOnesweepKernel<int>"
I64 = "void at::native::vectorized_elementwise_kernel<2, at::native::CUDAFunctor_add<long>>(int)"
I32 = "void at::native::vectorized_elementwise_kernel<2, at::native::BinaryFunctor<int, int>>(int)"
GATHER = "void at::native::_scatter_gather_elementwise_kernel<128, 8>(int)"
DTOH = "Memcpy DtoH (Device -> Pageable)"


def _trace(events, window_us):
    return tr.Trace(device=sorted(events, key=lambda e: e[1]), window_us=window_us)


def _run(t, calls=1, trace_calls=1, window_s=1.0, work=None):
    return Run("c", {}, {}, [window_s / calls] * calls, window_s, work or {}, t, 1.0,
               [0.0] * trace_calls)


def test_busy_is_the_union_of_intervals():
    t = _trace([(K1, 0, 10), (I64, 5, 15), (SORT, 20, 30), (I32, 22, 25)], 50)
    assert t.busy_us() == 25
    assert tr.gaps(t.device) == [(15, 20)]


def test_idle_share_is_against_the_untraced_window():
    # 2 traced calls, 25 us busy each; the untraced window ran 4 calls in 200 us
    t = _trace([(K1, 0, 25), (K1, 100, 125)], 400)
    run = _run(t, calls=4, trace_calls=2, window_s=200e-6)
    assert registry.reader("device.idle_share.render")(run) == pytest.approx(0.5)
    assert registry.reader("device.idle_share.probe")(_run(None)) is None


@pytest.mark.parametrize("events,want", [
    # between two K1 launches of a pool: everything is the reorder
    ([(K1, 0, 10), (I32, 10, 12), (SORT, 12, 15), (GATHER, 15, 16), (DTOH, 16, 17),
      (K1, 20, 30)], {1, 2, 3, 4}),
    # the block permutation's path
    ([(K1, 0, 10), (I32, 10, 12), (SORT, 12, 15), (K6, 15, 16), (K1, 20, 30)], {1, 2, 3}),
    # between pools (no sort): glue, however the kernels are named
    ([(K1, 0, 10), (GATHER, 10, 12), (I32, 12, 15), (DTOH, 15, 16), (K1, 20, 30)], set()),
    # a presort: from the last host read before its sort on
    ([(K1, 0, 10), (I64, 10, 12), (DTOH, 12, 13), (I32, 13, 14), (DTOH, 14, 15),
      (I32, 15, 16), (SORT, 16, 17), (GATHER, 17, 18), (K1, 20, 30)], {5, 6, 7}),
    # the window's start counts as a bound
    ([(I64, 0, 2), (DTOH, 2, 3), (I32, 3, 4), (SORT, 4, 5), (K1, 6, 9)], {2, 3}),
    # after the last K1 launch: glue
    ([(K1, 0, 10), (I32, 10, 12), (SORT, 12, 15)], set()),
])
def test_the_reorder_is_pinned_by_order(events, want):
    assert tr.reorder_events(_trace(events, 100)) == want


def test_reorder_glue_and_roofline_readers():
    t = _trace([(I64, 0, 100), (K1, 100, 1100), (I32, 1100, 1150), (SORT, 1150, 1250),
                (GATHER, 1250, 1300), (K1, 1300, 2300), (GATHER, 2300, 2400)], 3000)
    work = {"samples_per_call": 1_000_000, "live_rays": 9, "trace_live_rays": 2_000_000,
            "triangles": 1000}
    run = _run(t, work=work)
    assert registry.reader("seg.reorder_ms_per_msample.render")(run) == pytest.approx(0.2)
    assert registry.reader("glue.device_ms_per_msample.render")(run) == pytest.approx(0.2)
    nbytes = 2 * 52 * 2_000_000 + 36 * 1_000_000 + 76 * 1000 * 2
    want = 100 * nbytes / 3.35e12 / 2e-3
    assert registry.reader("k1_roofline.render")(run) == pytest.approx(want)
    # no K1 and no reorder in the trace: the readers return nothing, never 0
    none = _run(_trace([(I64, 0, 10)], 100), work=work)
    assert registry.reader("k1_roofline.render")(none) is None
    assert registry.reader("seg.reorder_ms_per_msample.probe")(none) is None
    assert registry.reader("k1_roofline.render")(_run(None, work=work)) is None


def test_rate_over_the_whole_window():
    calls = [0.010] * 95 + [0.050] * 5
    run = Run("c", {}, {}, calls, 1.25, {"samples_per_call": 262144}, None, 3.0)
    assert registry.reader("render_msamples_per_s")(run) == pytest.approx(
        100 * 262144 / 1.25 / 1e6)
    assert registry.reader("probe_msamples_per_s")(run) == pytest.approx(
        100 * 262144 / 1.25 / 1e6)
    assert registry.reader("setup_s")(run) == 3.0


def test_top_lists():
    t = _trace([(K1, 0, 10), (I64, 20, 25), (K1, 40, 60)], 100)
    ops = tr.top_device_ops(t)
    assert ops[0][0].startswith("void rtf::seg_segment_kernel") and ops[0][1] == 30e-6
    gaps = dict(tr.top_idle_gaps(t))
    assert gaps["before " + K1[:100]] == pytest.approx(15e-6)
    assert gaps["before " + I64[:100]] == pytest.approx(10e-6)
