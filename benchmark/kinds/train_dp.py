"""Data-parallel training on one node: a unit is one global step of
``train --gpus <ranks> --batch <batch>``, each rank a process with its own
card, each training on its rows of the global batch, the phases'
gradients, stats and ``w_mean`` all-reduced to their mean.

The harness's process is rank 0 on ``cuda:0``; it starts ranks 1 ..
ranks - 1 on ``cuda:1`` .. (gloo ranks on the CPU where the cell runs on
the CPU) and joins them through the port's ``parallel/dist.py init``. Every
rank draws the global unit from the seed (``Traffic``, the batch of the
whole step) and takes its rows with ``dist.shard_batch``, as the train
command does; the loss's draws are seeded by rank. Rank 0 drives the
others: before each unit of work it sends each of them, through a pipe,
what comes next (a step and its cadence, the compared steps, the
program's release, the reference's replay, the end), so that every rank
runs the same steps and the window ends on every rank when it ends on
rank 0. A rank that fails ends its process at once, and rank 0 then ends
too; where rank 0 fails, it ends the others. ``train_img_per_s`` counts
the global batch.

The check compares rank 0's seven numbers (``kinds/train.py COMPARED``,
each net apart, from the same three compared steps of set-up) with the
data-parallel reference: the frozen reference's networks and loss with
``reference/train/data_parallel.py``'s step, replayed on the same ranks
with the same rows and draws. The operations a unit
(``Record.flops_per_unit``) are rank 0's counted on that replay times the
ranks.
"""

from __future__ import annotations

import contextlib
import os
import sys
import tempfile
import threading
import time
import traceback

import torch
from next3d_tpu_torch.parallel import dist as pdist

from .. import harness, models
from ..traffic import Traffic, generator
from .common import free
from .train import COMPARED, Trainer, _PhaseFlops, cadence, readings

E2E = 'train_img_per_s'
REFERENCE_STEP = 'benchmark.reference.train.data_parallel:TrainStep'
# what rank 0 sends the other ranks before each unit of work: (op, unit,
# greg, dreg)
STOP, WARM, UNIT, RELEASE, REPLAY, REPLAY_TF32 = range(6)


class _Rows:
    """A traffic whose units are one rank's rows of the global unit."""

    def __init__(self, traffic, take):
        self.traffic = traffic
        self.take = take

    def unit(self, i):
        return {k: self.take(v) for k, v in self.traffic.unit(i).items()}


class RankTrainer(Trainer):
    """``kinds/train.py``'s trainer on one rank: its rows of each unit,
    its own draws, and the step of ``step_cls`` where given."""

    def __init__(self, ctx, train_pkg, G, D, rank, take, step_cls=None):
        super().__init__(ctx, train_pkg, G, D)
        if step_cls is not None:
            self.step = step_cls(self.loss, self.step.opt_G,
                                 self.step.opt_D)
        self.draws = generator(ctx.seed, 'draws', rank, device=ctx.device)
        self.take = take

    def run(self, traffic, i, greg, dreg, timer=None):
        return super().run(_Rows(traffic, self.take), i, greg, dreg, timer)


def _rank_ctx(ctx, rank):
    device = f'cuda:{rank}' if ctx.cuda else 'cpu'
    return harness.Ctx(ctx.cell, ctx.cfg, ctx.mix, ctx.seed, device,
                       seconds=ctx.seconds, trace=ctx.trace, lim=ctx.limits)


def _ranks(mix):
    return int(mix['ranks'])


def program(ctx, rank):
    """The program's trainer on ``rank``: G and D with the seed's weights,
    rank 0's state broadcast to every rank, as the train command starts."""
    traffic = Traffic(ctx.mix, ctx.seed, ctx.device)
    G = models.pair_weights(ctx.cfg, 'G_kwargs', ctx.seed, ctx.device, 'G',
                            traffic.mesh)
    D = models.pair_weights(ctx.cfg, 'D_kwargs', ctx.seed, ctx.device, 'D')
    trainer = RankTrainer(ctx, ctx.cfg['program_train'], G, D, rank,
                          pdist.shard_batch)
    pdist.broadcast_module(trainer.G, trainer.D, trainer.G_ema,
                           trainer.step.opt_G, trainer.step.opt_D)
    return trainer, traffic


def replay(ctx, rank, counter=None, low=False):
    """The data-parallel reference's three compared steps on ``rank`` from
    the seed's weights (in TF32 with ``low``): (what ``checked_steps``
    gives, the initial parameters on the host)."""
    world = torch.distributed.get_world_size()
    traffic = Traffic(ctx.mix, ctx.seed, ctx.device)
    rows = ctx.mix['batch'] // world
    G = models.reference(ctx.cfg, 'G_kwargs', ctx.seed, ctx.device, 'G',
                         traffic.mesh)
    D = models.reference(ctx.cfg, 'D_kwargs', ctx.seed, ctx.device, 'D')
    p0 = {f'{net}.{n}': p.detach().cpu().clone()
          for net, m in (('G', G), ('D', D)) for n, p in m.named_parameters()}
    p0.update({f'G_ema.{n[2:]}': p for n, p in list(p0.items())
               if n.startswith('G.')})
    ref = RankTrainer(ctx, ctx.cfg['reference_train'], G, D, rank,
                      lambda v: v[rank * rows:(rank + 1) * rows],
                      harness.load_attr(REFERENCE_STEP))
    with harness.tf32(low):
        out = ref.checked_steps(
            traffic,
            (lambda k: counter if k == 1 else None) if counter else None)
    del ref, G, D
    free(ctx.device)
    return out, p0


# ------------------------------------------------------------------ ranks
def _rank_main(rank, world, init_file, ctx_args, parent, threads, conn):
    """Rank ``rank`` (1 ..): join the group, build the program, then run
    rank 0's commands, read from ``conn``, until STOP; then leave the group.
    Any failure ends the process at once with an error, which rank 0's
    watch sees (an exception left to the interpreter could wait in the
    group's teardown, which under NCCL waits for every rank)."""
    try:
        ctx = harness.Ctx(*ctx_args)
        _watch_parent(parent)
        torch.set_num_threads(threads)
        if ctx.cuda:
            torch.cuda.set_device(ctx.device)
        pdist.init(rank, world, 'nccl' if ctx.cuda else 'gloo', init_file)
        harness.set_precision(ctx.cfg)
        held = dict(zip(('trainer', 'traffic'), program(ctx, rank)))
        while True:
            op, i, greg, dreg = conn.recv()
            if op == STOP:
                break
            if op == WARM:
                held['trainer'].checked_steps(held['traffic'])
            elif op == UNIT:
                held['trainer'].run(held['traffic'], i, greg, dreg)
            elif op == RELEASE:
                held.clear()
                free(ctx.device)
            elif op in (REPLAY, REPLAY_TF32):
                replay(ctx, rank, low=op == REPLAY_TF32)
        held.clear()
        pdist.teardown()
    except Exception:
        traceback.print_exc()
        sys.stderr.flush()
        os._exit(1)


def _watch_parent(parent):
    """End this rank if rank 0's process is gone."""
    def watch():
        while os.getppid() == parent:
            time.sleep(2)
        os._exit(5)
    threading.Thread(target=watch, daemon=True).start()


class _Watch:
    """End rank 0 if another rank's process failed, so that no rank waits
    on a collective that will not come."""

    def __init__(self, procs):
        self.procs = procs
        self.done = False
        threading.Thread(target=self.watch, daemon=True).start()

    def watch(self):
        while not self.done:
            for p in self.procs:
                if p.exitcode not in (None, 0):
                    print(f'train_dp: rank process {p.name} exited with '
                          f'{p.exitcode}', file=sys.stderr, flush=True)
                    os._exit(4)
            time.sleep(1)


def start_ranks(ctx):
    """Ranks 1 .. ranks - 1 as processes, then rank 0 (this process) into
    the group; returns the processes and the pipes that command them. On
    the card each rank takes an equal share of this process's torch
    threads; on the CPU as many as this process."""
    import multiprocessing as mp
    world = _ranks(ctx.mix)
    if ctx.mix['batch'] % world:
        raise ValueError(f'a batch of {ctx.mix["batch"]} does not split '
                         f'over {world} ranks')
    threads = torch.get_num_threads()
    if ctx.cuda:
        from next3d_tpu_torch.ops import cuda_build
        # built once here, not by every rank at once
        cuda_build.build_all(sorted(p.stem for p in
                                    cuda_build.CSRC.glob('*.cu')))
        threads = max(1, threads // world)
    init_file = os.path.join(tempfile.mkdtemp(prefix='train_dp_'), 'group')
    spawn = mp.get_context('spawn')
    procs, conns = [], []
    for rank in range(1, world):
        r = _rank_ctx(ctx, rank)
        ours, theirs = spawn.Pipe()
        p = spawn.Process(
            target=_rank_main, name=f'rank{rank}', daemon=True,
            args=(rank, world, init_file,
                  (r.cell, r.cfg, r.mix, r.seed, str(r.device), r.seconds,
                   r.trace, r.limits), os.getpid(), threads, theirs))
        p.start()
        procs.append(p)
        conns.append(ours)
    if ctx.cuda:
        torch.cuda.set_device(ctx.device)
    pdist.init(0, world, 'nccl' if ctx.cuda else 'gloo', init_file)
    return procs, conns


class Work:
    def __init__(self, ctx):
        self.ctx = ctx
        self.mix = ctx.mix
        self.batch = self.mix['batch']
        self.ranks = _ranks(self.mix)
        self.procs, self.conns = start_ranks(ctx)
        self.watch = _Watch(self.procs)
        with self.guard():
            self.trainer, self.traffic = program(ctx, 0)
        self.model = self.trainer.G
        self.spans = None
        self.checked = None
        self.keep_ranks = False

    def send(self, op, i=0, greg=False, dreg=False):
        for conn in self.conns:
            conn.send((op, i, greg, dreg))

    @contextlib.contextmanager
    def guard(self):
        """Rank 0's part of a unit of work: where it fails, the other ranks
        are ended before the error goes on, so that none is left waiting
        in a collective."""
        try:
            yield
        except BaseException:
            self.watch.done = True
            for p in self.procs:
                p.kill()
                p.join(timeout=30)
            raise

    def warm_up(self):
        with self.guard():
            self.send(WARM)
            self.checked = self.trainer.checked_steps(self.traffic)

    def unit(self, i, keep=True):
        greg, dreg = cadence(self.mix, i)
        with self.guard():
            self.send(UNIT, i, greg, dreg)
            self.trainer.run(self.traffic, i, greg, dreg, timer=self.spans)

    def profile_unit(self, i):
        with self.guard():
            self.send(UNIT, i)
            self.trainer.run(self.traffic, i, False, False,
                             timer=self.spans)

    def e2e(self, units, window_s, latencies):
        return {E2E: units * self.batch / window_s}

    def shapes(self):
        return {}

    def release(self):
        self.send(RELEASE)
        del self.trainer, self.model
        free(self.ctx.device)

    def stop(self):
        """Tell the other ranks to leave the group and leave it at the same
        time (NCCL's teardown waits for every rank), then wait for them."""
        from next3d_tpu_torch.parallel import dist as pdist
        self.send(STOP)
        pdist.teardown()
        for p in self.procs:
            p.join(timeout=120)
        self.watch.done = True


def check(ctx, work, record=None):
    counter = _PhaseFlops() if record is not None else None
    with work.guard():
        work.send(REPLAY)
        want, p0 = replay(ctx, 0, counter)
    if counter is not None:
        f = counter.by_phase
        opt = ctx.mix['optimizer']
        record.flops_per_unit = work.ranks * (
            f['Gmain'] + f['Dmain'] + f['G_ema']
            + f.get('Greg', 0) / opt['g_reg_interval']
            + f.get('Dreg', 0) / opt['d_reg_interval'])
    work.readings = readings(work.checked, want, p0)
    if not work.keep_ranks:
        work.stop()
    else:
        work.want = (want, p0)
    return [(n, work.readings[n], ctx.limits.get(n)) for n in COMPARED]


def control(ctx, work):
    """The data-parallel reference in TF32 in the program's place, against
    the reference in float32 (the replay that ``check`` kept)."""
    want, p0 = work.want
    work.send(REPLAY_TF32)
    got, _ = replay(ctx, 0, low=True)
    return [(n, v, None) for n, v in readings(got, want, p0).items()]


def witness(ctx, work):
    """The data-parallel reference run twice against itself."""
    want, p0 = work.want
    work.send(REPLAY)
    again, _ = replay(ctx, 0)
    return [(n, v, None) for n, v in readings(again, want, p0).items()]

