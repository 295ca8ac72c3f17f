"""Run one cell of the benchmark once and print its result line.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The cell is an entry of ``workloads`` in ``BENCHMARK.json``; its
configuration is ``benchmark/configs/<config>.json``, its traffic
``benchmark/traffic/<traffic>.json`` (whose ``kind`` names the module in
``benchmark/kinds/``), its limits ``benchmark/limits/<cell>.json`` and each
per-layer metric's reader ``benchmark/metrics/<metric>.py``.

A run: set-up (the weights of the seed, the program built and loaded, the
cell's shapes warmed up: ``setup_s``), then a closed loop of units of work
for ``--seconds``; with ``--trace 1`` then a stretch of units under spans
and a short one under ``torch.profiler``. Then the program is freed and
the reference checks what the window produced. The last line of stdout is
one JSON object; the numbers compared, each beside its limit, are the last
lines of stderr and the last key of that object. Without a CUDA card, with
fewer cards than the cell asks for, or with JAX or the JAX package loaded,
it prints no result and exits with a code other than 0.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

from benchmark import harness  # noqa: E402


def log(*args):
    print(*args, file=sys.stderr, flush=True)


def reported(bench, cell, section):
    """The metrics of ``section`` that ``cell`` reports."""
    e2e = {m['name'] for m in bench['end_to_end']
           if cell['name'] in m.get('workloads', [cell['name']])}
    if section == 'end_to_end':
        return [m for m in bench['end_to_end'] if m['name'] in e2e]
    return [m for m in bench['per_layer']
            if (cell['name'] in m['workloads'] if 'workloads' in m
                else m['moves'] in e2e)]


def instrumented(ctx, work, rec, first):
    """The traced run's stretches after the window: units under spans,
    then units under the profiler."""
    import torch
    mix = ctx.mix
    spans = harness.Spans(ctx.cuda)
    remove = harness.install_spans(work.model, ctx.cfg.get('spans', {}),
                                   spans)
    profile_unit = getattr(work, 'profile_unit',
                           lambda i: work.unit(i, keep=False))
    work.spans = spans
    try:
        n = mix.get('span_units', 2)
        for k in range(n):
            work.unit(first + k, keep=False)
        ctx.sync()
        rec.span_ms, rec.span_units = spans.ms(), n
        spans.done.clear()
        n_prof = mix.get('profile_units', 1)
        acts = [torch.profiler.ProfilerActivity.CPU]
        if ctx.cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        with torch.profiler.profile(activities=acts) as prof:
            t0 = harness.now()
            for k in range(n_prof):
                profile_unit(first + n + k)
            ctx.sync()
            rec.window_s = harness.now() - t0
        rec.prof_units = n_prof
    finally:
        remove()
        work.spans = None
    rec.device_ops, rec.host = harness.read_trace(prof)


def run_cell(ctx, bench, cell, t_start=None):
    """Run ``ctx``'s cell once; returns (result dict, comparisons,
    set-up seconds, the cell's work, released)."""
    import torch
    t_start = T_START if t_start is None else t_start
    kind = harness.kind_module(ctx.mix['kind'])
    harness.set_precision(ctx.cfg)
    work = kind.Work(ctx)
    if ctx.cuda:
        torch.cuda.reset_peak_memory_stats(ctx.device)
    work.warm_up()
    ctx.sync()
    setup_s = harness.now() - t_start

    latencies, units = [], 0
    t0 = harness.now()
    while True:
        ts = harness.now()
        work.unit(units)
        te = harness.now()
        latencies.append(te - ts)
        units += 1
        if te - t0 >= ctx.seconds:
            break
    window_s = te - t0
    peak = torch.cuda.max_memory_allocated(ctx.device) if ctx.cuda else 0
    e2e = work.e2e(units, window_s, latencies)
    e2e['peak_mem_gib'] = peak / 2 ** 30
    e2e['setup_s'] = setup_s

    rec = None
    if ctx.trace:
        rec = harness.Record()
        rec.rate = units / window_s
        rec.batch = work.batch
        rec.shapes = work.shapes()
        instrumented(ctx, work, rec, units)
    work.release()
    checks = kind.check(ctx, work, rec)

    device = dict(platform='gpu' if ctx.cuda else 'cpu',
                  kind=torch.cuda.get_device_name(ctx.device) if ctx.cuda
                  else 'cpu', count=cell.get('chips', 1),
                  memory_peak_bytes=peak)
    out = {}
    breakdown = None
    if ctx.trace:
        for m in reported(bench, cell, 'per_layer'):
            value = harness.reader(m['name']).read(rec)
            if value is not None:
                out[m['name']] = {'value': value, 'unit': m['unit']}
        device.update(busy_s=rec.busy_s(), window_s=rec.window_s)
        host = rec.host
        starts = [s for _, _, s, _ in host] + [s for _, s, _ in
                                                rec.device_ops]
        ends = [e for _, _, _, e in host] + [e for _, _, e in rec.device_ops]
        breakdown = dict(
            device_ops=harness.top_ops(rec.device_ops),
            idle_gaps=harness.gaps(rec.device_ops, host, min(starts),
                                   max(ends)) if starts else [])
    else:
        for m in reported(bench, cell, 'end_to_end'):
            out[m['name']] = {'value': e2e[m['name']], 'unit': m['unit']}
    correct = all(limit is not None and value <= limit
                  for _, value, limit in checks)
    result = dict(correct=correct, attempted=units * work.batch, failed=0,
                  metrics=out, device=device)
    if breakdown is not None:
        result['breakdown'] = breakdown
    result['checks'] = {name: {'value': value, 'limit': limit}
                        for name, value, limit in checks}
    return result, checks, setup_s, work


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seed', type=int, required=True)
    ap.add_argument('--seconds', type=float, required=True)
    ap.add_argument('--trace', type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    harness.set_caches()
    bench = harness.spec()
    cell, _ = harness.workload(args.workload, bench)
    import torch
    if not torch.cuda.is_available():
        log('benchmark: torch finds no CUDA card; no result')
        return 2
    if torch.cuda.device_count() < cell.get('chips', 1):
        log(f'benchmark: {cell["name"]} needs {cell.get("chips", 1)} cards, '
            f'torch finds {torch.cuda.device_count()}; no result')
        return 2
    ctx = harness.Ctx(cell, harness.config(cell['config']),
                      harness.traffic(cell['traffic']), args.seed, 'cuda:0',
                      seconds=args.seconds, trace=bool(args.trace),
                      lim=harness.limits(cell['name']))
    result, checks, setup_s, _ = run_cell(ctx, bench, cell)
    banned = harness.banned_modules()
    if banned:
        log(f'benchmark: modules of JAX or the JAX package are loaded: '
            f'{banned}; no result')
        return 3
    log(f'card: {harness.card_line()}')
    log(f'setup_s {setup_s!r}')
    log(f'correct: {result["correct"]}')
    for name, value, limit in checks:
        log(f'{name} {value!r} limit {limit!r}')
    print(json.dumps(result), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
