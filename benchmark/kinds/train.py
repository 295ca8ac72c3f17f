"""Training, one card: a unit is one step of the ``train`` command, the
four phases and the G_ema update as ``TrainStep.run_phases`` runs them,
on a batch of real images, labels and meshes made from the seed on the
device (``gen_c = real_c``). The lazy cadence starts at the window's first
step: Greg at steps 0, 4, 8, ..., Dreg at 0, 16, ...

Set-up builds one training step (G, D, G_ema, both Adam states) and drives
it through its first three steps with the window's own call, on rows of
their own: a plain step, one with both regularizations (so that every
shape is warm), a plain one. Those are what the check compares. The
reference, built from the same seed, replays them from the same weights
with the same draws (the loss's generator seeded alike) and gives, each
net apart:

  loss_gap_g, loss_gap_d
              the first step's Gmain and Dmain losses, each computed
              before its net's first update, |program - reference| over
              |reference|;
  grad_gap_g, grad_gap_d
              each leaf's gradient as the optimizer holds it after the
              first step (Adam's first moment: beta1 is 0, so it is
              Gmain's or Dmain's gradient), the gap of the program's norm
              to the reference's over the larger of the reference's norm
              of that leaf and of the net's median leaf, the worst leaf;
  change_gap_g, change_gap_d, change_gap_ema
              each leaf's change over the three steps in G, D and G_ema,
              the same gap of norms, the median leaf's, over the leaves
              whose reference gradient is at least a thousandth of the
              net's median leaf's (the others move by round-off alone
              under Adam). A net whose state is left unchanged reads 1.

Read beside them and not compared: every step's losses and the worst
leaf's change. Adam's first steps move each weight by about its learning
rate whatever the size of its gradient, so round-off sets the sign of
small gradients' steps, and the reference against itself reads those
numbers at up to 11% (PERF.md).
"""

from __future__ import annotations

import copy
import statistics

import torch

from .. import harness, models
from ..traffic import Traffic, generator
from .common import FlopCount, free, generator_shapes

E2E = 'train_img_per_s'
# the compared steps' (Greg, Dreg): the first plain, so that Adam's first
# moment after it is Gmain's and Dmain's gradient at the seed's weights;
# the second with both regularizations, so that every shape is warm
CHECKED = ((False, False), (True, True), (False, False))
LOSSES = ('Loss/G/loss', 'Loss/G/reg', 'Loss/D/loss', 'Loss/D/reg')


def build_step(train_pkg, G, D, mix):
    """(loss, TrainStep) of the package ``train_pkg`` (the program's or the
    reference's) for G and D, as the train command builds them."""
    loss_mod = harness.load_attr(f'{train_pkg}.loss:StyleGAN2Loss')
    cfg_cls = harness.load_attr(f'{train_pkg}.loss:LossConfig')
    step_mod = f'{train_pkg}.train_step'
    TrainStep = harness.load_attr(f'{step_mod}:TrainStep')
    make_optimizer = harness.load_attr(f'{step_mod}:make_optimizer')
    trainable = harness.load_attr(f'{step_mod}:trainable_parameters')
    opt = mix['optimizer']
    loss = loss_mod(G, D, cfg_cls(**mix['loss']))
    step = TrainStep(
        loss,
        make_optimizer(trainable(G), opt['glr'], opt['beta1'], opt['beta2'],
                       opt['eps'], reg_interval=opt['g_reg_interval']),
        make_optimizer(trainable(D, D.frozen_paths()), opt['dlr'],
                       opt['beta1'], opt['beta2'], opt['eps'],
                       reg_interval=opt['d_reg_interval']))
    return loss, step


def cadence(mix, k):
    opt = mix['optimizer']
    return k % opt['g_reg_interval'] == 0, k % opt['d_reg_interval'] == 0


class Trainer:
    """G, D, G_ema and the step of one package, driven unit by unit."""

    def __init__(self, ctx, train_pkg, G, D):
        self.ctx = ctx
        self.mix = ctx.mix
        self.G, self.D = G.train(), D.train()
        self.G_ema = copy.deepcopy(G).eval().requires_grad_(False)
        self.loss, self.step = build_step(train_pkg, G, D, self.mix)
        self.sched, self.nrr = self.loss.schedules(0)
        self.draws = generator(ctx.seed, 'draws', device=ctx.device)

    def run(self, traffic, i, greg, dreg, timer=None):
        u = traffic.unit(i)
        batch = dict(gen_z=u['z'], gen_c=u['c'], gen_v=u['v'],
                     real_c=u['c'])
        opt = self.mix['optimizer']
        stats = self.step.run_phases(
            self.G_ema, batch, u['real'], self.draws, self.sched, self.nrr,
            do_greg=greg, do_dreg=dreg,
            g_reg_interval=opt['g_reg_interval'],
            d_reg_interval=opt['d_reg_interval'],
            ema_beta=self.mix.get('ema_beta', 0.999), timer=timer)
        self.ctx.sync()
        return stats

    def checked_steps(self, traffic, timer_for=None):
        """The three compared steps, on units -1, -2, -3: (losses a step,
        {leaf: gradient norm} after the first, {leaf: parameters} of G, D
        and G_ema after the third, on the host)."""
        losses, grads = [], None
        for k, (greg, dreg) in enumerate(CHECKED):
            timer = timer_for(k) if timer_for else None
            stats = self.run(traffic, -1 - k, greg, dreg, timer)
            losses.append({n: float(stats[n]) for n in LOSSES if n in stats})
            if k == 0:
                grads = self.moment_norms()
        params = {f'{net}.{n}': p.detach().cpu().clone()
                  for net, m in (('G', self.G), ('D', self.D),
                                 ('G_ema', self.G_ema))
                  for n, p in m.named_parameters()}
        return losses, grads, params

    def moment_norms(self):
        """{leaf: norm of Adam's first moment} of G's and D's optimizers."""
        out = {}
        for net, m, opt in (('G', self.G, self.step.opt_G),
                            ('D', self.D, self.step.opt_D)):
            names = {id(p): n for n, p in m.named_parameters()}
            leaves, moments = [], []
            for group in opt.param_groups:
                for p in group['params']:
                    leaves.append(f'{net}.{names[id(p)]}')
                    # a leaf that no step has reached holds no moment
                    moments.append(opt.state[p].get('exp_avg',
                                                    torch.zeros_like(p)))
            norms = torch.stack([torch.linalg.vector_norm(t)
                                 for t in moments]).tolist()
            out.update(zip(leaves, norms))
        return out


def _nets(ctx, mesh, build):
    return (build(ctx.cfg, 'G_kwargs', ctx.seed, ctx.device, 'G', mesh),
            build(ctx.cfg, 'D_kwargs', ctx.seed, ctx.device, 'D'))


class Work:
    def __init__(self, ctx):
        self.ctx = ctx
        self.mix = ctx.mix
        self.batch = self.mix['batch']
        self.traffic = Traffic(self.mix, ctx.seed, ctx.device)
        G, D = _nets(ctx, self.traffic.mesh, models.pair_weights)
        self.trainer = Trainer(ctx, ctx.cfg['program_train'], G, D)
        self.model = self.trainer.G
        self.spans = None
        self.checked = None

    def warm_up(self):
        self.checked = self.trainer.checked_steps(self.traffic)

    def unit(self, i, keep=True):
        self.trainer.run(self.traffic, i, *cadence(self.mix, i),
                         timer=self.spans)

    def profile_unit(self, i):
        """A step without regularization: the steps most of a run takes."""
        self.trainer.run(self.traffic, i, False, False, timer=self.spans)

    def e2e(self, units, window_s, latencies):
        return {E2E: units * self.batch / window_s}

    def shapes(self):
        """A plain step's K4 launches: G's forward in Gmain (under grad, so
        with a backward) and in Dmain (none), two passes each; K1 once in
        each."""
        s = generator_shapes(self.ctx.cfg, self.batch)
        return dict(k4=s['k4'] * 2, k4b=s['k4'], raster=s['raster'],
                    raster_calls=2)

    def release(self):
        del self.trainer, self.model
        free(self.ctx.device)


def _norm_gaps(got, want, leaves, over):
    """``over`` (max or the median) of each leaf's |got - want| over the
    larger of want's norm of that leaf and of the median leaf."""
    median = statistics.median(want[n] for n in leaves)
    return over([abs(got[n] - want[n]) / max(want[n], median, 1e-30)
                 for n in leaves])


class _PhaseFlops:
    """A timer for ``run_phases`` that counts each phase's operations."""

    def __init__(self):
        self.by_phase = {}

    def phase(self, name):
        timer = self

        class _Count(FlopCount):
            def __exit__(self, *exc):
                super().__exit__(*exc)
                timer.by_phase[name] = self.total
        return _Count()


def _replay(ctx, counter=None, low=False):
    """The reference's three steps from the seed's weights (in TF32 with
    ``low``): (what ``checked_steps`` gives, the initial parameters on the
    host, G_ema's those of G)."""
    traffic = Traffic(ctx.mix, ctx.seed, ctx.device)
    G, D = _nets(ctx, traffic.mesh, models.reference)
    p0 = {f'{net}.{n}': p.detach().cpu().clone()
          for net, m in (('G', G), ('D', D)) for n, p in m.named_parameters()}
    p0.update({f'G_ema.{n[2:]}': p for n, p in list(p0.items())
               if n.startswith('G.')})
    ref = Trainer(ctx, ctx.cfg['reference_train'], G, D)
    with harness.tf32(low):
        out = ref.checked_steps(
            traffic,
            (lambda k: counter if k == 1 else None) if counter else None)
    del ref, G, D
    free(ctx.device)
    return out, p0


SUFFIX = {'G': 'g', 'D': 'd', 'G_ema': 'ema'}


def readings(got, want, p0):
    """The compared numbers (``COMPARED``) of the program's (or the
    control's) three steps against the reference's, and beside them those
    not compared: every step's losses and the worst leaf's change, which
    follow the first Adam steps and which the reference against itself
    reads as high (PERF.md)."""
    got_losses, got_grads, got_params = got
    want_losses, want_grads, want_params = want

    def loss_gap(steps, keys=None):
        return max(abs(g.get(k, 0.0) - w[k]) / max(abs(w[k]), 1e-30)
                   for g, w in steps for k in (keys or w))

    def change(params, leaves):
        return {n: float(torch.linalg.vector_norm(params[n] - p0[n]))
                for n in leaves}

    first = list(zip(got_losses, want_losses))[:1]
    out = dict(loss_gap_g=loss_gap(first, ['Loss/G/loss']),
               loss_gap_d=loss_gap(first, ['Loss/D/loss']))
    worst = []
    # each optimized net's leaves, by its own median leaf; G_ema changes
    # over G's leaves
    for net, changed in (('G', ('G', 'G_ema')), ('D', ('D',))):
        leaves = [n for n in sorted(want_grads) if n.startswith(net + '.')]
        out['grad_gap_' + SUFFIX[net]] = _norm_gaps(got_grads, want_grads,
                                                    leaves, max)
        median = statistics.median(want_grads[n] for n in leaves)
        moved = [n[len(net):] for n in leaves
                 if want_grads[n] >= 1e-3 * median]
        for name in changed:
            keys = [name + n for n in moved]
            got_change = change(got_params, keys)
            want_change = change(want_params, keys)
            out['change_gap_' + SUFFIX[name]] = _norm_gaps(
                got_change, want_change, keys, statistics.median)
            worst.append(_norm_gaps(got_change, want_change, keys, max))
    out.update(loss_gap_all_steps=loss_gap(zip(got_losses, want_losses)),
               change_gap_worst=max(worst))
    return out


COMPARED = ('loss_gap_g', 'loss_gap_d', 'grad_gap_g', 'grad_gap_d',
            'change_gap_g', 'change_gap_d', 'change_gap_ema')


def check(ctx, work, record=None):
    counter = _PhaseFlops() if record is not None else None
    want, p0 = _replay(ctx, counter)
    if counter is not None:
        f = counter.by_phase
        opt = ctx.mix['optimizer']
        record.flops_per_unit = (f['Gmain'] + f['Dmain'] + f['G_ema']
                                 + f.get('Greg', 0) / opt['g_reg_interval']
                                 + f.get('Dreg', 0) / opt['d_reg_interval'])
    work.readings = readings(work.checked, want, p0)
    return [(n, work.readings[n], ctx.limits.get(n)) for n in COMPARED]


def control(ctx, work=None):
    """The reference in the program's place, computed in TF32, against
    the reference in float32."""
    want, p0 = _replay(ctx)
    got, _ = _replay(ctx, low=True)
    return [(n, v, None) for n, v in readings(got, want, p0).items()]


def witness(ctx, work=None):
    """The reference run twice against itself: what round-off alone
    reads in each number."""
    want, p0 = _replay(ctx)
    again, _ = _replay(ctx)
    return [(n, v, None) for n, v in readings(again, want, p0).items()]
