"""The window's rate arithmetic: rows finished by the deadline, the row in
flight at it counted by its share, and a stall anywhere in the window moves
``clip_s``."""

import types

import pytest

from perfbench.cell import work_done
from perfbench.metrics import clip_s


class Ev:
    def __init__(self, t):
        self.t = t

    def elapsed_time(self, end):
        return (end.t - self.t) * 1e3


def rows(times):
    return Ev(0.0), [Ev(t) for t in times]


def clip_seconds(times, seconds=10.0, per_clip=59):
    start, ends = rows(times)
    work, _ = work_done(start, ends, seconds)
    return clip_s.read(types.SimpleNamespace(seconds=seconds, rows_per_clip=per_clip,
                                             work_rows=work))


def test_interpolates_the_row_in_flight():
    start, ends = rows([2.0, 4.0, 6.0, 8.0, 11.0])
    work, times = work_done(start, ends, 10.0)
    assert times == pytest.approx([2, 4, 6, 8, 11])
    assert work == pytest.approx(4 + 2 / 3)


def test_steady_rows():
    assert clip_seconds([0.5 * (i + 1) for i in range(21)]) == pytest.approx(10 * 59 / 20)


@pytest.mark.parametrize("where", [0, 7, 19])
def test_a_stall_anywhere_moves_clip_s(where):
    steady = [0.5 * (i + 1) for i in range(21)]
    stalled = [t + (1.5 if i >= where else 0.0) for i, t in enumerate(steady)]
    assert clip_seconds(stalled) > clip_seconds(steady) * 1.01


def test_a_stall_after_the_last_row_moves_clip_s():
    steady = [0.5 * (i + 1) - 0.25 for i in range(20)] + [10.25]
    late = [0.5 * (i + 1) - 0.25 for i in range(20)] + [12.0]
    assert clip_seconds(late) > clip_seconds(steady)
