"""The training loop on one device.

Counterpart of next3d_tpu/train/training_loop.py (reference:
training_avatar_texture/training_loop.py:99-534): the phases with lazy
regularization intervals (a phase runs where ``batch_idx % interval ==
0``), G_ema with the EMA ramp-up, ticks of ``kimg_per_tick`` with a stats
line and a ``stats.jsonl`` record, image grids of G_ema's fakes and full
snapshots.

Randomness: one ``torch.Generator`` on the device, seeded by ``seed``,
draws gen_z and every draw of the phases; the generator conditioning is
drawn from the whole dataset by a host ``RandomState``; the data sampler is
the dataset's ``InfiniteSampler``. A snapshot keeps all three positions
(the generator's state as ``rng_key``, the RandomState, the batch index and
the tick under ``extra``) with the networks and both Adam states, so a run
resumed from it gives, on the CPU, the parameters of an uninterrupted run
bit for bit.

The ADA controller (JAX :61-64, :210-217): the augment pipe's probability
``p`` starts at ``augment_p``, rides each batch's schedule as
``sched['aug_p']``, and with an ``ada_target`` moves every
``ada_interval`` batches by the mean of ``Loss/signs/real`` since the last
move (``train/augment.py ada_update_p``); ``Progress/augment`` reports it.
A snapshot keeps ``ada_p`` under ``extra`` as JAX's does, and the signs
gathered since the last move, so a resume continues the controller too.

Per-phase timing (``Timing/<phase>``, seconds, a synchronized wall time)
is sampled every ``timing_sample_every`` batches, as in the JAX package.
Each tick's numeric fields also go to TensorBoard scalars in the run
directory (``utils/tensorboard.py``, JAX :128-132, :240-245) at the global
step ``cur_nimg // 1000``. A resume also takes the JAX loop's snapshots and
the reference's network pickles (``load_resume``). After each snapshot,
the ``metrics`` (names of ``metrics/metric_main.py``) run on G_ema and the
training dataset (JAX :275-278, :318-338); a metric that fails is printed
and training goes on. The abort and progress callbacks are not ported.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
import traceback
from collections import defaultdict

import numpy as np
import torch

from ..data.dataset import make_data_iterator
from .augment import ada_update_p
from ..utils.checkpoint import (is_snapshot, load_optimizer_state,
                                load_snapshot, optimizer_state, save_snapshot)
from ..utils.pkl_import import network_data
from ..utils.tensorboard import SummaryWriter
from ..utils.weights import load_jax_params, state_dict_to_params


class PhaseTimer:
    """Synchronized wall time of each phase; ``report()`` gives the means
    as Timing/<phase> (the JAX package's utils/profiling.py PhaseTimer)."""

    def __init__(self, device):
        self.device = torch.device(device)
        self._totals = defaultdict(float)
        self._counts = defaultdict(int)

    def _sync(self):
        if self.device.type == 'cuda':
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def phase(self, name):
        self._sync()
        start = time.perf_counter()
        try:
            yield
        finally:
            self._sync()
            self._totals[name] += time.perf_counter() - start
            self._counts[name] += 1

    def report(self, prefix='Timing/'):
        return {f'{prefix}{k}': self._totals[k] / max(self._counts[k], 1)
                for k in self._totals}

    def reset(self):
        self._totals.clear()
        self._counts.clear()


class StatsCollector:
    """Means of the reported scalars since the last reset."""

    def __init__(self):
        self._sums = defaultdict(float)
        self._counts = defaultdict(int)

    def report_dict(self, stats):
        for k, v in stats.items():
            self._sums[k] += float(v)
            self._counts[k] += 1

    def names(self):
        return sorted(self._sums)

    def mean(self, name):
        return self._sums[name] / self._counts[name]

    def reset(self):
        self._sums.clear()
        self._counts.clear()


def training_loop(G, D, G_ema, loss_obj, step, dataset, run_dir, device,
                  total_kimg=25000, batch_size=32, ema_kimg=10.0,
                  ema_rampup=0.05, g_reg_interval=4, d_reg_interval=16,
                  kimg_per_tick=4, snapshot_ticks=50, image_snapshot_ticks=50,
                  resume_path=None, seed=0, config=None,
                  snapshot_vis_batch=None, workers=3,
                  timing_sample_every=16, ada_target=None, augment_p=0.0,
                  ada_interval=4, ada_kimg=500, metrics=()):
    """Train ``G`` and ``D`` (the loss's, on ``device``) with ``step``'s
    optimizers on batches of ``dataset`` until ``total_kimg`` thousand
    images. Returns {'cur_nimg', 'ticks': the stats.jsonl records}."""
    os.makedirs(run_dir, exist_ok=True)
    device = torch.device(device)
    generator = torch.Generator(device=device).manual_seed(seed)
    cond_rnd = np.random.RandomState(seed * 7919 + 1)
    named_G = dict(G.named_parameters())
    named_D = dict(D.named_parameters())
    cur_nimg = batch_idx = tick = 0
    ada_p = float(augment_p)
    ada_signs = []  # Loss/signs/real since the controller's last move
    if resume_path:
        resumed = load_resume(resume_path, G, D, G_ema, step)
        cur_nimg = resumed.get('cur_nimg', cur_nimg)
        batch_idx = resumed.get('batch_idx', batch_idx)
        tick = resumed.get('tick', tick)
        if 'rng_state' in resumed:
            generator.set_state(resumed['rng_state'])
        if 'cond_rnd_state' in resumed:
            cond_rnd.set_state(resumed['cond_rnd_state'])
        ada_p = resumed.get('ada_p', ada_p)
        ada_signs = resumed.get('ada_signs', ada_signs)
    data = make_data_iterator(dataset, batch_size, seed=seed,
                              prefetch=workers, start=batch_idx * batch_size)

    stats = StatsCollector()
    timer = PhaseTimer(device)
    records = []
    if config is not None:
        with open(os.path.join(run_dir, 'training_options.json'), 'wt') as f:
            json.dump(config, f, indent=2, default=str)
    stats_jsonl = open(os.path.join(run_dir, 'stats.jsonl'), 'at')
    tb_writer = SummaryWriter(run_dir)
    tick_start_nimg = cur_nimg
    tick_start_time = start_time = time.time()
    try:
        while True:
            t_fetch = time.perf_counter()
            host = next(data)
            fetch = time.perf_counter() - t_fetch
            real_img = torch.from_numpy(host['image']).to(device)
            gen_z = torch.randn((batch_size, G.z_dim), generator=generator,
                                device=device)
            gen_c, gen_v = dataset.sample_conditioning(cond_rnd, batch_size)
            batch = {'gen_z': gen_z,
                     'gen_c': torch.from_numpy(gen_c).to(device),
                     'gen_v': torch.from_numpy(gen_v).to(device),
                     'real_c': torch.from_numpy(host['c']).to(device)}
            sched, nrr = loss_obj.schedules(cur_nimg)
            sched['aug_p'] = ada_p
            do_greg = g_reg_interval is not None and \
                batch_idx % g_reg_interval == 0
            do_dreg = d_reg_interval is not None and \
                batch_idx % d_reg_interval == 0
            # the EMA beta with its ramp-up (reference :374-381)
            ema_nimg = ema_kimg * 1000
            if ema_rampup is not None:
                ema_nimg = min(ema_nimg, cur_nimg * ema_rampup)
            ema_beta = 0.5 ** (batch_size / max(ema_nimg, 1e-8))
            timed = timing_sample_every and \
                batch_idx % timing_sample_every == 0
            step_stats = step.run_phases(
                G_ema, batch, real_img, generator, sched, nrr,
                do_greg=do_greg, do_dreg=do_dreg,
                g_reg_interval=g_reg_interval, d_reg_interval=d_reg_interval,
                ema_beta=ema_beta, timer=timer if timed else None)
            stats.report_dict(step_stats)
            stats.report_dict({'Timing/data_fetch': fetch})
            cur_nimg += batch_size
            batch_idx += 1
            # the ADA controller (JAX :210-217)
            if 'Loss/signs/real' in step_stats:
                ada_signs.append(float(step_stats['Loss/signs/real']))
            if ada_target is not None and batch_idx % ada_interval == 0 \
                    and ada_signs:
                ada_p = ada_update_p(ada_p, float(np.mean(ada_signs)),
                                     ada_target, batch_size * ada_interval,
                                     ada_kimg=ada_kimg,
                                     batch_size=batch_size)
                ada_signs.clear()
            stats.report_dict({'Progress/augment': ada_p})

            done = cur_nimg >= total_kimg * 1000
            if cur_nimg < tick_start_nimg + kimg_per_tick * 1000 and not done:
                continue

            # ---- tick
            tick_time = time.time() - tick_start_time
            line = (f'tick {tick:<5d} kimg {cur_nimg / 1e3:<8.3f} '
                    f'time {time.time() - start_time:<8.1f}s sec/kimg '
                    f'{tick_time / max((cur_nimg - tick_start_nimg) / 1e3, 1e-8):<7.2f} ')
            for name in ('Loss/G/loss', 'Loss/D/loss'):
                if name in stats.names():
                    line += f"{name.split('/')[-2]}loss {stats.mean(name):<6.3f} "
            print(line, flush=True)
            record = {'tick': tick, 'kimg': cur_nimg / 1e3,
                      'images_per_second': (cur_nimg - tick_start_nimg)
                      / max(tick_time, 1e-8),
                      **{k: stats.mean(k) for k in stats.names()},
                      **timer.report()}
            if device.type == 'cuda':
                record['Resources/peak_device_mem_gb'] = \
                    torch.cuda.max_memory_allocated(device) / 2 ** 30
            records.append(record)
            stats_jsonl.write(json.dumps(record) + '\n')
            stats_jsonl.flush()
            for k, val in record.items():
                if isinstance(val, (int, float)):
                    tb_writer.add_scalar(k, val,
                                         global_step=int(cur_nimg // 1e3))
            tb_writer.flush()
            stats.reset()
            timer.reset()

            if image_snapshot_ticks is not None and snapshot_vis_batch \
                    is not None and (tick % image_snapshot_ticks == 0 or done):
                _save_fakes_grid(G_ema, snapshot_vis_batch, run_dir, cur_nimg,
                                 device)
            if snapshot_ticks is not None and tick > 0 and \
                    (tick % snapshot_ticks == 0 or done):
                snap_path = os.path.join(
                    run_dir, f'network-snapshot-{cur_nimg // 1000:06d}.pkl')
                save_snapshot(
                    snap_path,
                    params_G=state_dict_to_params(G.state_dict()),
                    params_D=state_dict_to_params(D.state_dict()),
                    params_G_ema=state_dict_to_params(G_ema.state_dict()),
                    opt_state_G=optimizer_state(step.opt_G, named_G),
                    opt_state_D=optimizer_state(step.opt_D, named_D),
                    cur_nimg=cur_nimg, rng_key=generator.get_state().numpy(),
                    config=config,
                    extra={'batch_idx': batch_idx, 'tick': tick + 1,
                           'cond_rnd_state': cond_rnd.get_state(),
                           'ada_p': ada_p, 'ada_signs': list(ada_signs)})
                if metrics:
                    _eval_metrics(G_ema, dataset, metrics, run_dir,
                                  snap_path, cur_nimg, device)
            tick += 1
            tick_start_nimg = cur_nimg
            tick_start_time = time.time()
            if done:
                break
    finally:
        stats_jsonl.close()
        tb_writer.close()
        if hasattr(data, 'close'):
            data.close()
    return {'cur_nimg': cur_nimg, 'ticks': records, 'ada_p': ada_p}


def load_resume(path, G, D, G_ema, step):
    """Load the checkpoint at ``path`` for a resume into the networks and
    ``step``'s optimizers; returns the loop's state that it holds (the
    keys ``cur_nimg``, ``ada_p``, ``batch_idx``, ``tick``, ``rng_state``,
    ``cond_rnd_state``, ``ada_signs`` where it has them). Three kinds of
    file, as the JAX loop (JAX :93-120):

    - a format-1 snapshot of the port's loop: everything, so that the run
      continues exactly;
    - a format-1 snapshot of the JAX loop: each parameter tree that is not
      None, each optimizer state that is not None (optax's adam moments,
      ``utils/checkpoint.py load_optimizer_state``), ``cur_nimg`` and
      ``extra['ada_p']``. Its ``rng_key`` is a JAX key, not a torch
      generator's state, so the generator and the conditioning sampler
      start from the seed, as JAX's loop does (JAX :88); so do the batch
      index and the tick;
    - a reference network pickle (a Next3D or EG3D .pkl): a warm start.
      ``G_ema``'s weights, through ``eg3d_to_next3d``, go into both G and
      G_ema, and ``D``'s into D, wherever a name and a shape match
      (``copy_matching_params``); the optimizers stay fresh and cur_nimg
      0."""
    from .warm_start import copy_matching_params, eg3d_to_next3d

    snap = load_snapshot(path)
    if not is_snapshot(snap):
        snap = network_data(snap)
        if not isinstance(snap, dict) or (snap.get('G_ema') is None
                                          and snap.get('D') is None):
            raise ValueError(f'{path} is neither a format-1 snapshot nor a '
                             f'reference network pickle with a G_ema or a D')
        if snap.get('G_ema') is not None:
            imported = eg3d_to_next3d(state_dict_to_params(
                snap['G_ema'].state_dict()))
            for module in (G, G_ema):
                load_jax_params(module, copy_matching_params(
                    state_dict_to_params(module.state_dict()), imported))
        if snap.get('D') is not None:
            load_jax_params(D, copy_matching_params(
                state_dict_to_params(D.state_dict()),
                state_dict_to_params(snap['D'].state_dict())))
        return {}
    for module, key in ((G, 'params_G'), (D, 'params_D'),
                        (G_ema, 'params_G_ema')):
        if snap.get(key):
            load_jax_params(module, snap[key])
    for optimizer, module, key in ((step.opt_G, G, 'opt_state_G'),
                                   (step.opt_D, D, 'opt_state_D')):
        if snap.get(key) is not None:
            load_optimizer_state(optimizer, snap[key],
                                 dict(module.named_parameters()))
    extra = snap.get('extra') or {}
    out = {'cur_nimg': int(snap.get('cur_nimg', 0))}
    if 'ada_p' in extra:
        out['ada_p'] = float(extra['ada_p'])
    if 'batch_idx' in extra:   # the port's own loop wrote it
        out.update(
            batch_idx=int(extra['batch_idx']), tick=int(extra['tick']),
            rng_state=torch.from_numpy(np.array(snap['rng_key'])),
            cond_rnd_state=extra['cond_rnd_state'],
            ada_signs=list(extra.get('ada_signs', [])))
    return out


@torch.no_grad()
def _eval_metrics(G_ema, dataset, metrics, run_dir, snapshot_path,
                  cur_nimg, device):
    """In-training metrics on ``G_ema`` (JAX :318-338, reference
    training_loop.py:479-492): each record goes to its jsonl file in
    ``run_dir``, the dataset's statistics are cached there, and a failure
    (no local Inception pickle, say) is printed and never stops training."""
    from ..metrics import metric_main
    for name in metrics:
        try:
            record = metric_main.calc_metric(
                name, run_dir=run_dir, generator=G_ema, dataset=dataset,
                cache_dir=run_dir, device=device,
                snapshot_pkl=os.path.basename(snapshot_path),
                cur_nimg=cur_nimg)
            print(f"metric {name}: {record['results']}", flush=True)
        except Exception as e:  # a metric never stops training
            traceback.print_exc()
            print(f'metric {name} FAILED: {e!r}', flush=True)


def _save_fakes_grid(G_ema, vis, run_dir, cur_nimg, device):
    """fakes<kimg>.png and fakes<kimg>_raw.png from G_ema with constant
    noise (reference training_loop.py:428-435)."""
    from ..cli.common import save_image_grid
    z, c, v = (torch.from_numpy(vis[k]).to(device)
               for k in ('gen_z', 'gen_c', 'gen_v'))
    out = G_ema(z, c, v, neural_rendering_resolution=vis.get('nrr'),
                noise_mode='const')
    for key, suffix in (('image', ''), ('image_raw', '_raw')):
        save_image_grid(out[key].cpu().numpy(), os.path.join(
            run_dir, f'fakes{cur_nimg // 1000:06d}{suffix}.png'))
