"""Rank processes for the tests that spawn gloo ranks on the CPU
(tests/test_torch_parallel.py, tests/test_torch_train_dist.py).

``start(fn, world, *args)`` spawns ``world`` processes, each running
``fn(rank, world, init_file, *args)`` with a ``file://`` rendezvous in a
temporary directory, on one torch thread; ``finish`` waits for them and
returns each rank's return value, saved by the rank with ``torch.save``.
Starting without waiting lets a test compute its JAX reference meanwhile.
This module imports no JAX: the ranks import it."""

import copy
import dataclasses
import hashlib
import os
import shutil
import tempfile
import time

import torch
import torch.multiprocessing as mp

from next3d_tpu_torch.parallel import dist
from next3d_tpu_torch.parallel.stats import StatsCollector


def start(fn, world, *args):
    tmp = tempfile.mkdtemp(prefix='torch_dist_')
    context = mp.spawn(_run, args=(fn, world, tmp, args), nprocs=world,
                       join=False)
    return context, tmp, world


def finish(handle, timeout=300):
    """Each rank's result, in rank order; a rank that raised raises here,
    and ranks still running after ``timeout`` seconds are killed."""
    context, tmp, world = handle
    deadline = time.time() + timeout
    try:
        while not context.join(timeout=max(1.0, deadline - time.time())):
            if time.time() > deadline:
                for p in context.processes:
                    p.kill()
                raise TimeoutError(f'ranks still running after {timeout} s')
        return [torch.load(os.path.join(tmp, f'rank{r}.pt'),
                           weights_only=False) for r in range(world)]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def run(fn, world, *args, timeout=300):
    return finish(start(fn, world, *args), timeout)


def _run(rank, fn, world, tmp, args):
    torch.set_num_threads(1)
    result = fn(rank, world, os.path.join(tmp, 'rendezvous'), *args)
    torch.save(result, os.path.join(tmp, f'rank{rank}.pt'))


def digest(*modules):
    """A hash of the modules' state_dict bytes, in order."""
    h = hashlib.sha256()
    for m in modules:
        for k, v in m.state_dict().items():
            h.update(k.encode())
            h.update(v.detach().contiguous().numpy().tobytes())
    return h.hexdigest()


# --------------------------------------------------------------- functions
def functions(rank, world, init_file):
    """parallel/dist.py's functions and the stats of parallel/stats.py on
    this rank; returns what each gave."""
    out = {}
    dist.init(rank, world, 'gloo', init_file)
    try:
        full = torch.arange(8 * 3, dtype=torch.float32).reshape(8, 3)
        out['shard'] = dist.shard_batch(full)
        out['shard_numpy'] = dist.shard_batch(full.numpy() * 2)
        out['local'] = dist.local_batch(full.numpy()[rank::world])
        out['split_rows'] = dist.split_rows(5)
        try:
            dist.shard_batch(torch.zeros(3))
        except ValueError as e:
            out['shard_odd'] = str(e)

        # mixed shapes: rank r holds r + 1 + k in every element of tensor k
        mixed = [torch.full(s, rank + 1.0 + k) for k, s in
                 enumerate([(3,), (2, 2), (), (1, 5)])]
        out['mean_bytes'] = dist.all_reduce_mean(mixed)
        out['mean'] = mixed
        try:
            dist.all_reduce_mean([torch.zeros(2),
                                  torch.zeros(2, dtype=torch.int64)])
        except ValueError as e:
            out['mean_dtypes'] = str(e)

        counts = [3, 2]
        rows = torch.arange(counts[rank] * 4, dtype=torch.float64).reshape(
            -1, 4) + 100 * rank
        out['gathered'] = dist.gather_rows(rows, counts)
        state = torch.Generator().manual_seed(rank).get_state()
        out['gathered_states'] = dist.gather_rows(state[None])

        # rank r's module and Adam state start as the rank's own; after the
        # broadcast, rank 0's everywhere
        torch.manual_seed(rank)
        net = torch.nn.Sequential(torch.nn.Linear(3, 4),
                                  torch.nn.BatchNorm1d(4))
        opt = torch.optim.Adam(net.parameters())
        net(torch.randn(5, 3)).square().sum().backward()
        opt.step()
        dist.broadcast_module(net, opt)
        out['net'] = {k: v.clone() for k, v in net.state_dict().items()}
        out['adam'] = [{k: v.clone() for k, v in s.items()}
                       for s in opt.state.values()]
        dist.check_replica_consistency({'net': net}, {'adam': opt})
        out['consistent'] = True
        if rank == 1:
            with torch.no_grad():
                net[0].bias[2] += 1
        try:
            dist.check_replica_consistency({'net': net}, {'adam': opt})
        except RuntimeError as e:
            out['planted'] = str(e)

        # stats as the phases report them: each step's values averaged over
        # the ranks in one bucket, then collected on each rank
        collector = StatsCollector()
        raw = []
        for s in range(5):
            values = {'Loss/a': torch.tensor(rank * 2.0 + s * 0.25),
                      'Loss/b': torch.tensor(float((s + 1) * (rank + 1)))}
            raw.append({k: float(v) for k, v in values.items()})
            dist.all_reduce_mean(values.values())
            collector.report_dict(values)
        out['stats_raw'] = raw
        out['stats'] = collector.as_dict()
    finally:
        dist.teardown()
    return out


# ------------------------------------------------------------------ parity
def parity(rank, world, init_file, spec_path):
    """The four phases of the parity configuration on this rank's half of
    the batch of ``spec_path`` (tests/test_torch_parallel.py writes it), the
    learning rates 0 so that each phase sees the same weights: each phase's
    gradient as Adam receives it (all-reduced, scrubbed) and its stats;
    then ``run_phases`` with the real learning rates and random Greg
    points, and a hash of G, D and G_ema after it."""
    from next3d_tpu_torch.models.triplane_next3d import TriPlaneGenerator
    from next3d_tpu_torch.nn.discriminator import DualDiscriminator
    from next3d_tpu_torch.train.loss import LossConfig, StyleGAN2Loss
    from next3d_tpu_torch.train.train_step import (TrainStep,
                                                   make_optimizer,
                                                   trainable_parameters)
    from next3d_tpu_torch.train.training_loop import rank_seed

    spec = torch.load(spec_path, weights_only=False)
    G = TriPlaneGenerator(**spec['G_kwargs'])
    G.load_state_dict(spec['G'])
    D = DualDiscriminator(**spec['D_kwargs'])
    D.load_state_dict(spec['D'])
    G_ema = copy.deepcopy(G).eval()
    loss = StyleGAN2Loss(G, D, LossConfig(**spec['loss_cfg']),
                         deterministic=True)
    step = TrainStep(
        loss,
        make_optimizer(trainable_parameters(G), 0.0, 0.0, 0.99, 1e-8,
                       reg_interval=4),
        make_optimizer(trainable_parameters(D, D.frozen_paths()), 0.0, 0.0,
                       0.99, 1e-8, reg_interval=16))
    grads = []
    for opt, net in ((step.opt_G, G), (step.opt_D, D)):
        names = {p: k for k, p in net.named_parameters()}
        adam_step = opt.step

        def capture(*a, _opt=opt, _names=names, _step=adam_step, **k):
            grads.append({_names[p]: p.grad.clone() for g in
                          _opt.param_groups for p in g['params']})
            return _step(*a, **k)
        opt.step = capture

    dist.init(rank, world, 'gloo', init_file)
    try:
        batch = {k: dist.shard_batch(torch.from_numpy(spec['batch'][k]))
                 for k in ('gen_z', 'gen_c', 'gen_v', 'real_c')}
        real = dist.shard_batch(torch.from_numpy(spec['real']))
        draws = [tuple(dist.shard_batch(torch.from_numpy(x))
                       for x in spec['greg_draws'])]
        generator = torch.Generator().manual_seed(rank_seed(0, rank))
        sched, nrr = loss.schedules(0)
        stats = {}
        stats.update(step.gmain(batch, generator, sched, nrr))
        stats.update(step.greg(batch, generator, spec['g_gain'], sched,
                               draws=draws))
        stats.update(step.dmain(batch, real, generator, sched, nrr))
        stats.update(step.dreg(batch, real, spec['d_gain'], generator,
                               sched, nrr))
        for opt, lr in ((step.opt_G, spec['glr']), (step.opt_D,
                                                   spec['dlr'])):
            for group in opt.param_groups:
                group['lr'] = lr
        step.run_phases(G_ema, batch, real, generator, sched, nrr,
                        do_greg=True, do_dreg=True, ema_beta=0.5)
        after = digest(G, D, G_ema)
    finally:
        dist.teardown()
    return dict(grads=grads if rank == 0 else None,
                stats={k: float(v) for k, v in stats.items()}, after=after)


# ---------------------------------------------------------------- training
def stub_detector(images):
    """A stub feature detector: each image's mean and spread of each
    channel, from uint8 (N, 3, H, W)."""
    x = images.double()
    return torch.cat([x.mean((2, 3)), x.std((2, 3))], 1).float()


def stub_feats(opts):
    """A metric that keeps its generator features: 2 images at batch 2,
    every feature captured; rank 0 of a training run saves them to
    stub-feats.pkl in the run directory."""
    from next3d_tpu_torch.metrics.metric_utils import \
        compute_feature_stats_for_generator
    stats = compute_feature_stats_for_generator(
        dataclasses.replace(opts, detector=stub_detector, batch_size=2),
        max_items=2, capture_all=True)
    if opts.cache_dir:
        stats.save(os.path.join(opts.cache_dir, 'stub-feats.pkl'))
    return {'stub_feats': float(stats.get_all().mean())}


def train(rank, world, init_file, opts):
    """One rank of the train command's run of ``opts`` on the CPU, with
    the metric ``stub_feats`` registered; its result without the
    networks."""
    from next3d_tpu_torch.cli.train import run_rank
    from next3d_tpu_torch.metrics import metric_main
    metric_main.register_metric(stub_feats)
    result = run_rank(rank, world, 'gloo', init_file, opts, 'cpu')
    return {k: v for k, v in result.items() if k not in ('G', 'D', 'G_ema')}
