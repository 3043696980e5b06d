"""The readers' arithmetic against hand counts."""
import pytest

import _paths  # noqa: F401
from harness.stats import gaps, percentile, union_length


@pytest.mark.parametrize("values,q,want", [
    ([5.0], 95, 5.0),
    ([1.0, 2.0, 3.0, 4.0], 50, 2.5),
    ([1.0, 2.0, 3.0, 4.0, 5.0], 95, 4.8),
    ([10.0, 0.0, 20.0], 0, 0.0),
    ([10.0, 0.0, 20.0], 100, 20.0),
])
def test_percentile_interpolates_between_ranks(values, q, want):
    assert percentile(values, q) == pytest.approx(want)


def test_percentile_of_nothing_is_none():
    assert percentile([], 50) is None


@pytest.mark.parametrize("intervals,want", [
    ([], 0.0),
    ([(0, 1), (2, 3)], 2.0),
    ([(0, 2), (1, 3)], 3.0),
    ([(1, 3), (0, 10), (4, 5)], 10.0),
    ([(0, 1), (1, 2)], 2.0),
])
def test_union_length_counts_overlaps_once(intervals, want):
    assert union_length(intervals) == want


def test_gaps_are_the_uncovered_stretches():
    assert gaps([(1, 2), (4, 5)], 0, 6) == [(0, 1), (2, 4), (5, 6)]
    assert gaps([(0, 6)], 0, 6) == []
    assert gaps([(0, 3), (2, 4)], 0, 4) == []
