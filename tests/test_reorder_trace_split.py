"""The benchmark's order-based split (``rtbench/core/trace.py::
reorder_events``) on the segmented engine's reorder as the port now
launches it on the card: the key kernel, the library's radix sort, the
gather kernel, then the host's read of the live count. The whole stretch
between two K1 launches must count as reorder and none of it as glue, and
a presort's stretch must still start after the host's read of the valid
count. Synthetic device events, as the profiler names them."""

from __future__ import annotations

import pytest

from raytracerfacility_tpu_torch import kernels
from rtbench.core import trace as tr

K1 = "void rtf::seg_segment_kernel<false, false>(float*, int*, float*, float*)"
KEY = "rtf::reorder_key_kernel(float const*, float const*, float const*, int*, int*, int, int)"
GATHER = ("rtf::reorder_gather_kernel(float const*, float*, int const*, int*, long long const*, "
          "long long*, long long const*, int const*, float*, int, int, int, int, int)")
MEMSET = "Memset (Device)"
IOTA = "void at::native::vectorized_elementwise_kernel<4, at::native::FillFunctor<long>>(int)"
SORT = ("void at_cuda_detail::cub::DeviceRadixSortHistogramKernel<int>",
        "void at_cuda_detail::cub::DeviceRadixSortExclusiveSumKernel<int>",
        "void at_cuda_detail::cub::DeviceRadixSortOnesweepKernel<int>",
        "void at_cuda_detail::cub::DeviceRadixSortOnesweepKernel<int>")
DTOH = "Memcpy DtoH (Device -> Pageable)"
INIT = "void at::native::vectorized_elementwise_kernel<4, at::native::BinaryFunctor<float>>(int)"


def _events(names, start=0):
    """Back-to-back events of 2 us each, a 1 us gap before each."""
    return [(name, start + 3 * i + 1, start + 3 * i + 3) for i, name in enumerate(names)]


def _reorder():
    return [MEMSET, KEY, IOTA, *SORT, GATHER, DTOH]


def test_new_kernel_names_do_not_read_as_sorts():
    names = [k for k in kernels.LAUNCHES if k.startswith("reorder_")]
    assert names == ["reorder_key_kernel", "reorder_gather_kernel"]
    assert all(name in full for name, full in zip(names, (KEY, GATHER)))
    assert not any(tr._is_sort(full) for full in (KEY, GATHER))
    assert all(tr._is_sort(name) for name in SORT)


@pytest.mark.parametrize("segments", [1, 3])
def test_the_whole_reorder_between_k1_launches_counts(segments):
    names = [K1]
    for _ in range(segments):
        names += _reorder() + [K1]
    t = tr.Trace(device=_events(names), window_us=10_000)
    want = {i for i, name in enumerate(names) if name != K1}
    assert tr.reorder_events(t) == want
    assert tr.reorder_us(t) == pytest.approx(2 * len(want))
    assert tr.glue_us(t) == 0


def test_a_presort_starts_after_the_valid_count_read():
    # seg.init: the planes, the valid count read by the host, then the
    # presort's reorder and segment 0
    names = [INIT, INIT, DTOH] + _reorder() + [K1] + _reorder() + [K1]
    t = tr.Trace(device=_events(names), window_us=10_000)
    first = names.index(DTOH) + 1
    want = set(range(first, names.index(K1)))
    want |= set(range(names.index(K1) + 1, len(names) - 1))
    assert tr.reorder_events(t) == want
    assert tr.glue_us(t) == pytest.approx(2 * first)


PROBE = ("rtf::probe_ray_kernel(float const*, float const*, float const*, float const*, "
         "float const*, float const*, float*, float*, float*, long long*, int, int, "
         "unsigned int, unsigned int, float)")
TEA = "rtf::tea_init_kernel(long long const*, long long const*, long long*, int, int)"
HTOD = "Memcpy HtoD (Pageable -> Device)"
I64 = "void at::native::vectorized_elementwise_kernel<4, at::native::CUDAFunctor_add<long>>(int)"


@pytest.mark.parametrize("prep", [
    [PROBE],  # the probe-ray kernel, its seed passed by value
    [IOTA, I64, HTOD, TEA, I64, INIT, INIT],  # torch ops around the TEA, the seed copied
])
def test_the_estimators_prep_counts_as_glue(prep):
    """An estimate: the prep's events, then ``seg.init`` (the planes, the
    host's read of the valid count), the presort and segment 0. The prep
    lies before the valid-count read that bounds the presort's stretch, so
    it counts as glue and none of it as reorder, whatever its launches."""
    assert not any(tr._named(name) or tr._is_sort(name) for name in prep)
    names = prep + [INIT, DTOH] + _reorder() + [K1]
    t = tr.Trace(device=_events(names), window_us=10_000)
    first = len(prep) + 2
    assert tr.reorder_events(t) == set(range(first, names.index(K1)))
    assert tr.glue_us(t) == pytest.approx(2 * first)
    assert tr.reorder_us(t) == pytest.approx(2 * len(_reorder()))
