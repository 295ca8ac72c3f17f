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
In-training metrics, the TensorBoard writer and the abort and progress
callbacks are not ported (the ``train`` command refuses ``--metrics``).
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from collections import defaultdict

import numpy as np
import torch

from ..data.dataset import make_data_iterator
from .augment import ada_update_p
from ..utils.checkpoint import (load_optimizer_state, load_snapshot,
                                optimizer_state, save_snapshot)
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
                  ada_interval=4, ada_kimg=500):
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
        snap = load_snapshot(resume_path)
        if snap.get('format_version') != 1:
            raise NotImplementedError(
                f'{resume_path} is not a format-1 snapshot; warm starts from '
                f'a reference .pkl are not ported (ROADMAP.md Queue 1 item 5)')
        for module, key in ((G, 'params_G'), (D, 'params_D'),
                            (G_ema, 'params_G_ema')):
            load_jax_params(module, snap[key])
        load_optimizer_state(step.opt_G, snap['opt_state_G'], named_G)
        load_optimizer_state(step.opt_D, snap['opt_state_D'], named_D)
        extra = snap.get('extra') or {}
        cur_nimg = int(snap['cur_nimg'])
        batch_idx, tick = int(extra['batch_idx']), int(extra['tick'])
        generator.set_state(torch.from_numpy(np.array(snap['rng_key'])))
        cond_rnd.set_state(extra['cond_rnd_state'])
        ada_p = float(extra.get('ada_p', ada_p))
        ada_signs = list(extra.get('ada_signs', []))
    data = make_data_iterator(dataset, batch_size, seed=seed,
                              prefetch=workers, start=batch_idx * batch_size)

    stats = StatsCollector()
    timer = PhaseTimer(device)
    records = []
    if config is not None:
        with open(os.path.join(run_dir, 'training_options.json'), 'wt') as f:
            json.dump(config, f, indent=2, default=str)
    stats_jsonl = open(os.path.join(run_dir, 'stats.jsonl'), 'at')
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
            stats.reset()
            timer.reset()

            if image_snapshot_ticks is not None and snapshot_vis_batch \
                    is not None and (tick % image_snapshot_ticks == 0 or done):
                _save_fakes_grid(G_ema, snapshot_vis_batch, run_dir, cur_nimg,
                                 device)
            if snapshot_ticks is not None and tick > 0 and \
                    (tick % snapshot_ticks == 0 or done):
                save_snapshot(
                    os.path.join(run_dir, f'network-snapshot-'
                                          f'{cur_nimg // 1000:06d}.pkl'),
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
            tick += 1
            tick_start_nimg = cur_nimg
            tick_start_time = time.time()
            if done:
                break
    finally:
        stats_jsonl.close()
        if hasattr(data, 'close'):
            data.close()
    return {'cur_nimg': cur_nimg, 'ticks': records, 'ada_p': ada_p}


@torch.no_grad()
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
