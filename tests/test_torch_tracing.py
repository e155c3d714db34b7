"""The program's spans and counters (`opental_torch.utils.profiling`) on
the CPU: nothing is recorded, and nothing allocated, while recording is
off; recording follows `recording()`, `torch.profiler.profile` and the
low-level profiler sequence the benchmark's traced window uses, also in
a prefetch thread started before the profiler; parents, threads and the
clock are right; a tiny packed `run_videos` and a tiny `train_step` fed
by `prefetch` record their layers' spans and counters; and the
benchmark's readers of them read what the spans say (`trace`'s Chrome
file: `tests/test_torch_profiling.py`)."""

import contextlib
import itertools
import os
import sys
import threading
import time
import tracemalloc
import types

import numpy as np
import pytest
import torch

from torch_suite import suite_policy  # noqa: F401 (autouse)

from opental_torch import factory
from opental_torch.config import load_config
from opental_torch.data.prefetch import prefetch, prefetch_items
from opental_torch.infer.pipeline import InferencePipeline, window_offsets
from opental_torch.losses.edl import EDLState
from opental_torch.models.bdnet import BDNet
from opental_torch.ops import nms
from opental_torch.train.loop import build_dataset
from opental_torch.train.step import TrainState, make_optimizer, train_step
from opental_torch.utils import profiling
from opental_torch.utils.synthetic import make_synthetic_dataset

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device('cpu')
CLIP, CROP, STRIDE = 128, 32, 64
POST_CHILDREN = ('post.preselect', 'post.soft_nms', 'post.fetch',
                 'post.format')
STEP_CHILDREN = ('step.ingest', 'step.forward', 'step.loss',
                 'step.backward', 'step.optimizer')


def bench_module(path):
    """A module of the benchmark, loaded by path (as it loads readers)."""
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    from tal_bench import spec
    return spec.load_module(os.path.join(ROOT, 'tal_bench', path),
                            'test_' + path.replace('/', '_')
                            .replace('.', '_'))


@contextlib.contextmanager
def low_level_profiler(activities):
    """The profiler as `tal_bench/trace.Profiler` drives it; yields a
    dict that gets the events."""
    from torch._C._profiler import _ExperimentalConfig
    from torch.autograd import (ProfilerConfig, ProfilerState,
                                _disable_profiler, _enable_profiler,
                                _prepare_profiler)
    cfg = ProfilerConfig(ProfilerState.KINETO, False, False, False, False,
                         False, _ExperimentalConfig())
    _prepare_profiler(cfg, activities)
    _enable_profiler(cfg, activities)
    got = {}
    try:
        yield got
    finally:
        got['events'] = _disable_profiler().events()


def names(rec):
    return [s.name for s in rec.spans]


# ------------------------------------------------------------ the recorder


def test_off_records_and_allocates_nothing():
    profiling.refresh()
    assert not profiling._ON
    before = profiling.recorded()
    for _ in range(100):          # warm the call paths
        with profiling.span('x', 1):
            profiling.count('y')
    tracemalloc.start()
    try:
        base = tracemalloc.get_traced_memory()[0]
        for _ in itertools.repeat(None, 10000):
            with profiling.span('x'):
                profiling.count('y', 2)
        now, peak = tracemalloc.get_traced_memory()
    finally:
        tracemalloc.stop()
    assert now - base <= 0 and peak - base < 1024, (now - base, peak - base)
    assert profiling.recorded() == before


def test_recording_block_records_spans_and_counts():
    with profiling.recording():
        with profiling.span('outer', 'vid', videos=2):
            profiling.count('n', 3)
            with profiling.span('inner'):
                profiling.count('n')
    rec = profiling.recorded()
    assert names(rec) == ['outer', 'inner']
    outer, inner = rec.spans
    assert (outer.rid, outer.attrs, outer.parent) == ('vid', {'videos': 2},
                                                      -1)
    assert inner.parent == 0 and inner.rid is None
    assert outer.start_ns <= inner.start_ns <= inner.end_ns <= outer.end_ns
    assert [(c.name, c.n) for c in rec.counts] == [('n', 3), ('n', 1)]
    with profiling.span('after'):
        profiling.count('n')
    assert profiling.recorded() == rec


def test_a_count_of_a_function_is_read_with_the_recording():
    """A count made with a function (a value still on the card) calls it
    once, when the recording is read, and never while recording is
    off."""
    calls = []

    def later():
        calls.append(1)
        return 7

    profiling.count('n', later)
    with profiling.recording():
        profiling.count('n', 2)
        profiling.count('n', later)
        assert not calls
    rec = profiling.recorded()
    assert [(c.name, c.n) for c in rec.counts] == [('n', 2), ('n', 7)]
    assert profiling.recorded() == rec and calls == [1]


def test_a_new_recording_starts_empty():
    with profiling.recording():
        with profiling.span('first'):
            pass
    with profiling.recording():
        with profiling.recording():       # nested: one recording
            with profiling.span('second'):
                pass
        with profiling.span('third'):
            pass
    assert names(profiling.recorded()) == ['second', 'third']


def test_on_under_torch_profiler():
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with profiling.span('profiled'):
            torch.ones(4).sum()
    assert names(profiling.recorded()) == ['profiled']
    # the span is the program's, not an event of the profiler's
    assert all(e.name != 'profiled' for e in prof.events())
    with profiling.span('later'):
        pass
    assert names(profiling.recorded()) == ['profiled']


def test_on_under_the_benchmarks_low_level_profiler():
    from torch.autograd import ProfilerActivity
    with low_level_profiler({ProfilerActivity.CUDA}) as got:
        with profiling.span('windowed', 5):
            profiling.count('c')
    rec = profiling.recorded()
    assert names(rec) == ['windowed'] and rec.spans[0].rid == 5
    assert [c.name for c in rec.counts] == ['c']
    assert all(e.name() != 'windowed' for e in got['events'])


def test_on_in_a_prefetch_thread_started_before_the_profiler():
    from torch.autograd import ProfilerActivity
    profiling.refresh()
    assert not profiling._ON

    def work(i):
        with profiling.span('work', i):
            return i

    items = prefetch_items(range(8), work, depth=1, wait='test.wait')
    time.sleep(0.2)                 # the thread computes ahead, unrecorded
    with contextlib.closing(items):
        with low_level_profiler({ProfilerActivity.CPU}):
            got = list(items)
    assert got == list(range(8))
    rec = profiling.recorded()
    main = threading.main_thread().ident
    done = [s for s in rec.spans if s.name == 'work']
    assert done and all(s.thread != main for s in done)
    assert [s.rid for s in done] == list(range(8 - len(done), 8))
    waits = [s for s in rec.spans if s.name == 'test.wait']
    assert waits and all(s.thread == main for s in waits)


def test_parents_and_threads():
    seen = {}

    def worker():
        with profiling.span('t.outer'):
            with profiling.span('t.inner'):
                seen['ident'] = threading.get_ident()

    with profiling.recording():
        with profiling.span('a'):
            th = threading.Thread(target=worker)
            with profiling.span('b'):
                th.start()
                th.join(timeout=10)
                with profiling.span('c'):
                    pass
    assert not th.is_alive()
    rec = profiling.recorded()
    by = {s.name: (i, s) for i, s in enumerate(rec.spans)}
    main = threading.main_thread().ident
    assert by['a'][1].parent == -1
    assert by['b'][1].parent == by['a'][0]
    assert by['c'][1].parent == by['b'][0]
    assert by['t.outer'][1].parent == -1
    assert by['t.inner'][1].parent == by['t.outer'][0]
    assert {by[n][1].thread for n in 'abc'} == {main}
    assert by['t.inner'][1].thread == seen['ident'] != main


PER_THREAD = 500


def test_counts_from_many_threads_are_not_lost():
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with profiling.recording():
            threads = [threading.Thread(target=lambda: [
                profiling.count('stress') for _ in range(PER_THREAD)])
                for _ in range((os.cpu_count() or 1) + 2)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
    finally:
        sys.setswitchinterval(switch)
    assert not any(t.is_alive() for t in threads)
    counts = [c for c in profiling.recorded().counts if c.name == 'stress']
    assert len(counts) == sum(c.n for c in counts) \
        == PER_THREAD * len(threads)


def test_the_profiler_and_the_spans_share_a_clock():
    from torch.autograd import ProfilerActivity
    x = torch.randn(256, 256)
    with low_level_profiler({ProfilerActivity.CPU}) as got:
        with profiling.span('matmul'):
            x @ x
    sp = profiling.recorded().spans[0]
    mm = [e for e in got['events'] if e.name() == 'aten::mm']
    assert mm and all(sp.start_ns <= e.start_ns() <= sp.end_ns for e in mm)


# ------------------------------------------------------ the program's paths


class CountingTorch(types.ModuleType):
    """`torch` for `ops/nms.py`: counts `torch.exp`, which the pick loop
    calls once an iteration."""

    def __init__(self):
        super().__init__('torch')
        self.exps = 0

    def __getattr__(self, name):
        return getattr(torch, name)

    def exp(self, *a, **k):
        self.exps += 1
        return torch.exp(*a, **k)


def test_run_videos_records_each_layer(monkeypatch):
    model = factory.init_weights(BDNet(num_classes=5, os_head=True,
                                       use_edl=True, frame_num=CLIP,
                                       crop_size=CROP), seed=0)
    pipe = InferencePipeline(model, clip_length=CLIP, stride=STRIDE,
                             crop_size=CROP, conf_thresh=0.01, top_k=50,
                             use_edl=True, os_head=True, device='cpu')
    rng = np.random.RandomState(3)
    videos = [(f'v{i}', rng.randint(0, 256, (t, 40, 40, 3), np.uint8), t,
               10.0) for i, t in enumerate((150, 260, 200))]
    rows = []
    model.register_forward_pre_hook(
        lambda m, args: rows.append(args[0].shape[0]))
    counting = CountingTorch()
    monkeypatch.setattr(nms, 'torch', counting)
    with profiling.recording():
        out = pipe.run_videos(iter(videos), max_batch=4,
                              frames_capacity=512)
    rec = profiling.recorded()
    main = threading.main_thread().ident
    posts = [(i, s) for i, s in enumerate(rec.spans)
             if s.name == 'post.video']
    assert sorted(s.rid for _, s in posts) == sorted(out) == \
        ['v0', 'v1', 'v2']
    for i, s in posts:
        kids = [c.name for c in rec.spans if c.parent == i]
        assert kids == list(POST_CHILDREN), kids
        assert s.thread == main
    total = {}
    for c in rec.counts:
        total[c.name] = total.get(c.name, 0) + c.n
    assert total['nms.steps'] == counting.exps > 0
    assert total['infer.rows'] == sum(rows)
    assert total['infer.windows'] == sum(
        len(window_offsets(t, CLIP, STRIDE)) for _, _, t, _ in videos)
    flushes = [s for s in rec.spans if s.name == 'ingest.plan']
    assert [s.rid for s in flushes] == list(range(len(flushes)))
    assert sum(s.attrs['videos'] for s in flushes) == len(videos)
    assert sum(s.attrs['frames'] for s in flushes) == sum(
        t for _, _, t, _ in videos)
    assert sorted({s.rid for s in rec.spans if s.name == 'infer.forward'}
                  ) == list(range(len(flushes)))
    for name, main_thread in (('ingest.plan', False),
                              ('ingest.stage', False),
                              ('ingest.wait', True),
                              ('infer.forward', True), ('decode', True),
                              ('model.pyramid', True),
                              ('model.backbone.Mixed_5c', True)):
        found = [s for s in rec.spans if s.name == name]
        assert found, name
        assert all((s.thread == main) == main_thread for s in found), name


def test_train_step_through_prefetch_records_each_phase(tmp_path):
    cfg = load_config(make_synthetic_dataset(str(tmp_path), clip_length=CLIP,
                                             crop_size=CROP, spatial=40))
    model = factory.init_train_weights(
        factory.build_model(cfg, frame_num=CLIP, crop_size=CROP), seed=0)
    loss_cfg = factory.build_loss_config(cfg)
    state = TrainState(model=model,
                       optimizer=make_optimizer(model, 1e-5, 1e-4),
                       edl_state=EDLState.create(loss_cfg.edl, CPU))
    dataset = build_dataset(cfg, 'thumos', CLIP, CROP, seed=0)
    steps = 2
    with profiling.recording():
        with contextlib.closing(prefetch(dataset.batches(1), CPU)) as feed:
            for _ in range(steps):
                train_step(state, loss_cfg, factory.build_loss_weights(cfg),
                           next(feed), epoch=11)
        rec = profiling.recorded()
    main = threading.main_thread().ident
    tops = [(i, s) for i, s in enumerate(rec.spans) if s.name == 'step']
    assert [s.rid for _, s in tops] == list(range(steps))
    for i, s in tops:
        assert [c.name for c in rec.spans if c.parent == i] == \
            list(STEP_CHILDREN)
    waits = [s for s in rec.spans if s.name == 'loader.wait']
    assert [s.rid for s in waits] == list(range(steps))
    assert all(s.thread == main for s in waits)
    samples = [s for s in rec.spans if s.name == 'loader.sample']
    assert len(samples) >= steps
    assert all(s.thread != main for s in samples)
    assert all(len(dataset) > s.rid >= 0 for s in samples)
    for name in ('loader.collate', 'loader.place'):
        found = [s for s in rec.spans if s.name == name]
        assert len(found) >= steps and all(s.thread != main for s in found)


# ------------------------------------------------------ the readers


def fake_run(spans, counts, gaps, window=(1000, 2000), kind='infer',
             counters=None):
    """A traced run as the readers see it, and the recording they read."""
    trace = types.SimpleNamespace(window_ns=window, gaps=gaps,
                                  window_s=(window[1] - window[0]) / 1e9)
    run = types.SimpleNamespace(kind=kind, trace=trace,
                                counters=counters or {})
    main = threading.main_thread().ident
    rec = profiling.Recorded(
        [profiling.Span(n, s, e, main if m else main + 1, -1, None, None)
         for n, s, e, m in spans],
        [profiling.Count(t, n, v, main) for t, n, v in counts])
    return run, rec


READER_CASES = [
    # idle share: gaps (1100-1300), (1500-1600), (1900-2000); the main
    # thread's post spans 1000-1200 and, nested, 1150-1250; 1550-1700;
    # another thread's 1900-2000 counts for nothing
    ('idle_in_post_pct.py', 'infer',
     [('post.video', 1000, 1200, True), ('post.soft_nms', 1150, 1250, True),
      ('post.video', 1550, 1700, True), ('post.video', 1900, 2000, False),
      ('ingest.wait', 1250, 1300, True)], [], 100.0 * (150 + 50) / 1000),
    ('idle_in_ingest_pct.py', 'infer',
     [('ingest.wait', 1250, 1300, True), ('ingest.plan', 1500, 1600, False),
      ('ingest.wait', 900, 1120, True)], [], 100.0 * (50 + 20) / 1000),
    ('idle_in_loader_pct.train.py', 'train',
     [('loader.wait', 1950, 2500, True), ('loader.sample', 1100, 1300,
                                          False)], [], 5.0),
    ('idle_in_loss_pct.train.py', 'train',
     [('step.loss', 1000, 2000, True), ('step.backward', 1000, 2000,
                                          True)], [], 40.0),
    # counts inside the window only, over the run's windows
    ('nms_steps_per_window.py', 'infer', [],
     [(999, 'nms.steps', 50), (1000, 'nms.steps', 30),
      (1999, 'nms.steps', 10), (2000, 'nms.steps', 7),
      (1500, 'infer.rows', 1)], 40 / 4),
]


@pytest.mark.parametrize('reader,kind,spans,counts,want', READER_CASES)
def test_reader(monkeypatch, reader, kind, spans, counts, want):
    gaps = [(1100, 1300), (1500, 1600), (1900, 2000)]
    run, rec = fake_run(spans, counts, gaps, kind=kind,
                        counters={'windows': 4, 'steps': 2})
    monkeypatch.setattr(profiling, 'recorded', lambda: rec)
    mod = bench_module('metrics/' + reader)
    assert mod.read(run) == pytest.approx(want)
    other = types.SimpleNamespace(**dict(vars(run), kind={
        'infer': 'train', 'train': 'infer'}[kind]))
    assert mod.read(other) is None
    # a program without the recorder: nothing to read
    monkeypatch.delattr(profiling, 'recorded')
    assert mod.read(run) is None


def test_layer_shares_of_disjoint_spans_add_up_to_at_most_the_idle():
    gaps = [(1000 + 37 * i, 1000 + 37 * i + 20) for i in range(27)]
    spans = [('post.video', 1000 + 100 * i, 1040 + 100 * i, True)
             for i in range(10)]
    spans += [('ingest.wait', 1050 + 100 * i, 1090 + 100 * i, True)
              for i in range(10)]
    run, rec = fake_run(spans, [], gaps)
    prog = bench_module('metrics/_program.py')
    prog.recorded = lambda: rec
    idle = 100.0 * sum(min(b, 2000) - a for a, b in gaps) / 1000
    parts = [prog.idle_in_pct(run, (p,)) for p in ('post.', 'ingest.')]
    assert all(0 < p for p in parts) and sum(parts) <= idle
    assert prog.idle_in_pct(run, ('',)) == pytest.approx(sum(parts))
