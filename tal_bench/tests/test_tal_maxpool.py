"""`maxpool_ms_per_window` on a tiny synthetic reduced trace: the
library's and the port's max-pool kernels both count, kernels outside
the traced window and other kernels do not, and a training run, or one
that completed no window, reads None."""

from types import SimpleNamespace

import pytest

from tal_bench import run, spec

LIBRARY = ('void at::native::(anonymous namespace)::'
           'max_pool3d_with_indices_single_out_frame<c10::BFloat16>(...)')
B6 = ('void (anonymous namespace)::max_pool3d_same_kernel<__nv_bfloat16, '
      '3, 3, 3, 1, 1, 1>(...)')
OTHER = 'void at::native::vectorized_elementwise_kernel<4, ...>(...)'
MS = 1_000_000


def reader(cell='thumos14.infer.long'):
    return spec.Cell(spec.benchmark(run.ROOT), cell).reader(
        'maxpool_ms_per_window')


def traced(kind, windows, events):
    return SimpleNamespace(kind=kind, counters={'windows': windows},
                           trace=SimpleNamespace(window_ns=(10 * MS,
                                                            110 * MS),
                                                 all_device=events))


def test_both_kernels_count_inside_the_window():
    events = [(LIBRARY, 10 * MS, 3 * MS), (B6, 50 * MS, 2 * MS),
              (OTHER, 60 * MS, 7 * MS),
              (LIBRARY, 5 * MS, 4 * MS),         # before the window
              (B6, 110 * MS, 5 * MS)]            # after it
    assert reader().read(traced('infer', 4, events)) == pytest.approx(1.25)


@pytest.mark.parametrize('kind,windows', [('train', 4), ('infer', 0)])
def test_training_and_empty_runs_read_none(kind, windows):
    assert reader().read(traced(kind, windows, [(B6, 20 * MS, MS)])) is None
