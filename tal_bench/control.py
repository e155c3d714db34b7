"""Readings that set the limits of `correct`, at a cell's own size, on
the card (the benchmark's own runs never run this):

    python -m tal_bench.control --workload <name> --seeds 1,2,3
        --seconds <s> [--out readings.jsonl]

For each seed, one process runs the cell's set-up, a short window at
the cell's own load and its check, and prints the program's numbers
(the lower readings); then the control: the plain reference put in the
program's place in the precision below the configuration's (inference:
float8 e4m3 for the bfloat16 model; training: bfloat16 for the float32
step), compared with the float32 reference by the same numbers (the
upper readings). Training cells read both stages of their check (the
start and the timed steps), the reference with TF32 on beside them, the
timed steps' state left unchanged (the window's training state as it
started), and, at batch 2 or more, the fault of half the batch left out
(the loss's mean over the rest).
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time

import torch

from tal_bench import run as bench_run
from tal_bench import spec
from tal_bench.compare import rel_gap


def infer_control(runner) -> dict:
    """The model in float8 against it in float32 (`model_rel`), and the
    post-processing in bfloat16 against it in float32 on the program's
    outputs (`post_gap`)."""
    from tal_bench.reference import post
    from tal_bench.reference.layers import FP8
    sample = runner.sample()
    outs = runner.video_outputs(sample)
    model_rel, post_gap = 0.0, 0.0
    for v in sample:
        ref = runner.reference_outputs(v)
        low = runner.reference_outputs(v, dtype=FP8)
        model_rel = max(model_rel, rel_gap(low, ref))
        post_gap = max(post_gap, post.gap(
            runner.reference_post(v, outs[v], low=True),
            runner.reference_post(v, outs[v])))
    return {'model_rel': model_rel, 'post_gap': post_gap}


def program_numbers(runner) -> dict:
    """Every number the runner can compare for the program, limited or
    not."""
    if runner.kind == 'infer':
        return {c['name']: c['value'] for c in runner.check()}
    return runner.program_numbers()


def half_batches(batches):
    """Each batch with its second half of rows left out."""
    out = []
    for b in batches:
        n = next(iter(b.values())).shape[0]
        out.append({k: v[:max(1, n // 2)] for k, v in b.items()})
    return out


def unchanged_side(runner):
    """The timed steps' program side had they left the training state as
    the window found it."""
    at = runner.at_window
    names = list(at['exp_avg'])
    side = list(runner.program_side('timed'))
    side[1] = {k: at['exp_avg'][k] for k in names}      # m1 = m0
    side[4] = {k: at['sd'][k] for k in names}
    side[5] = type(runner.timed_edl)(*at['edl'])
    return tuple(side)


def train_control(runner) -> dict:
    out = {'control': {}, 'tf32_reference': {}, 'half_batch': {},
           'unchanged': {}}
    for stage in ('start', 'timed'):
        ref = runner.reference_steps(stage)
        low = runner.reference_steps(stage, dtype=torch.bfloat16)
        out['control'].update(runner.numbers(ref, prog=low, stage=stage))
        out['tf32_reference'].update(runner.numbers(
            ref, prog=runner.reference_steps(stage, tf32=True),
            stage=stage))
        if stage == 'timed':
            out['unchanged'].update(runner.numbers(
                ref, prog=unchanged_side(runner), stage=stage))
        if runner.batch >= 2:
            full = runner.batches if stage == 'start' \
                else runner.timed_batches
            half = runner.reference_steps(stage,
                                          batches=half_batches(full))
            out['half_batch'].update(runner.numbers(ref, prog=half,
                                                    stage=stage))
    if not out['half_batch']:
        del out['half_batch']
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    p.add_argument('--workload', required=True)
    p.add_argument('--seeds', required=True)
    p.add_argument('--seconds', type=float, required=True)
    p.add_argument('--out', default='')
    args = p.parse_args(argv)
    bench_run.set_cache_dirs()
    cell = spec.Cell(spec.benchmark(bench_run.ROOT), args.workload)
    device = bench_run.require_cards(cell.chips)
    module = cell.runner_module()
    sink = open(args.out, 'a') if args.out else None
    try:
        for seed in (int(s) for s in args.seeds.split(',')):
            t0 = time.perf_counter()
            runner = module.Runner(cell, seed, device)
            runner.setup()
            runner.window(args.seconds)
            runner.release()
            rec = {'workload': args.workload, 'seed': seed,
                   'program': program_numbers(runner)}
            if runner.kind == 'infer':
                rec['control'] = infer_control(runner)
            else:
                rec.update(train_control(runner))
            rec['seconds'] = time.perf_counter() - t0
            line = json.dumps(rec)
            print(line, flush=True)
            if sink is not None:
                sink.write(line + '\n')
                sink.flush()
            del runner
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        if sink is not None:
            sink.close()
    return 0


if __name__ == '__main__':
    sys.exit(main())
