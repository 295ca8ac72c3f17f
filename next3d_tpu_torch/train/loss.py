"""The non-saturating GAN loss with R1 and density regularization.

Counterpart of next3d_tpu/train/loss.py (reference:
training_avatar_texture/loss.py:28-310):
  Gmain  softplus(-D(G(z, c, v)))
  Greg   L1 density regularization over perturbed points
  Dmain  softplus(D(G)) + softplus(-D(real))
  Dreg   R1 on image and image_raw (dual discrimination), by
         ``torch.autograd.grad(..., create_graph=True)``
with the conditioning swap, the blur of D's input and the annealed neural
rendering resolution of the JAX ``schedules``.

Randomness: every draw of a phase (the swap, style mixing, Greg's points,
the generator's noise and ray jitter, D's label noise) comes from the
``torch.Generator`` passed to it, on the device of the tensors. With
``deterministic=True`` the generator's synthesis runs with constant noise
and midpoint depths (``noise_mode='const'``, no generator), as the JAX
package's ``rng=None`` path: the parity tests use it. Greg's points, their
perturbations and ray directions can be given (``draws``), so both
packages see the same ones.

Augmentation (``augment_pipe``, train/augment.py) runs inside ``run_D``
as in JAX: one draw for the image beside its upsampled raw image, at the
probability ``sched['aug_p']``. Video clips (``num_frames > 1``): the
phases flatten a batch of clips into frames (``flatten_clips``) and
``run_D`` folds each clip's frames back into channels, so D sees a clip.

``remat_synthesis`` recomputes ``G.synthesis`` in the backward
(``torch.utils.checkpoint``, as JAX's ``jax.checkpoint``), keeping only
its inputs and outputs between the forward and the backward. The
recompute replays the forward's draws: it runs on a generator rebuilt
from the caller's state before the forward, and the caller's generator is
left where a run without remat leaves it, so the losses and gradients are
those of a run without remat. The recompute runs synthesis again, its
host syncs (each a ``sync.*`` span of ``utils/profiling.py``: the mouth
boxes, ``fill_mouth``'s rounds, the projection's constants) and its
rasterizer launch included. The whole synthesis is one checkpoint, so the
recompute holds all its activations again during its own backward: the
peak memory falls only by D's share (``chip_smoke.py`` phase 18 logs
both). The port's default is off (the JAX default is on, because a 16 GB
TPU needs it), and the bench (``next3d_tpu_torch/bench.py``) turns it on,
as ``bench.py`` runs it.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..nn.discriminator import filtered_resizing
from ..ops import setup_filter
from ..ops.interpolate import interpolate_bilinear
from ..utils.profiling import span


@dataclass
class LossConfig:
    r1_gamma: float = 4.0
    blur_init_sigma: float = 0.0
    blur_fade_kimg: float = 0.0
    gpc_reg_prob: Optional[float] = 0.5
    gpc_reg_fade_kimg: float = 1000.0
    neural_rendering_resolution_initial: int = 64
    neural_rendering_resolution_final: Optional[int] = None
    neural_rendering_resolution_fade_kimg: float = 0.0
    dual_discrimination: bool = True
    filter_mode: str = 'antialiased'
    density_reg: float = 0.25
    density_reg_p_dist: float = 0.004
    reg_type: str = 'l1'
    box_warp: float = 1.0
    style_mixing_prob: float = 0.0
    num_frames: int = 1
    # recompute G.synthesis in the backward (module docstring); the JAX
    # default is True
    remat_synthesis: bool = False


def gaussian_blur_dynamic(img, blur_sigma, max_size):
    """The reference's f = exp2(-(x / sigma)^2) taps (loss.py:74-79) with a
    static count 2 * max_size + 1, the taps outside floor(3 * sigma) zero;
    a separable filter with shape-preserving zero padding (JAX :58-83)."""
    if max_size <= 0:
        return img
    x = torch.arange(-max_size, max_size + 1, dtype=torch.float32,
                     device=img.device)
    f = torch.exp2(-(x / max(blur_sigma, 1e-8)).square())
    f = torch.where(x.abs() <= math.floor(blur_sigma * 3), f,
                    torch.zeros_like(f))
    f = f / f.sum()
    shape = img.shape
    x4 = img.reshape(-1, 1, *shape[-2:])
    x4 = F.conv2d(x4, f.reshape(1, 1, 1, -1), padding=(0, max_size))
    x4 = F.conv2d(x4, f.reshape(1, 1, -1, 1), padding=(max_size, 0))
    return x4.reshape(shape)


class StyleGAN2Loss:
    """The four phases' losses for ``G`` and ``D`` (the port's modules)."""

    def __init__(self, G, D, cfg: LossConfig, augment_pipe=None,
                 deterministic=False):
        self.G = G
        self.D = D
        self.cfg = cfg
        self.augment_pipe = augment_pipe
        self.deterministic = deterministic
        self.resample_filter = torch.from_numpy(setup_filter([1, 3, 3, 1]))
        self.blur_max_size = int(np.floor(cfg.blur_init_sigma * 3))

    def flatten_clips(self, batch, real_img=None):
        """Clips (B, T, ...) as frames (B*T, ...), gen_z repeated for each
        frame of its clip (JAX :104-120); as given when num_frames is 1."""
        T = self.cfg.num_frames
        if T <= 1:
            return batch, real_img
        out = dict(batch)
        out['gen_z'] = batch['gen_z'].repeat_interleave(T, dim=0)
        for k in ('gen_c', 'gen_v', 'real_c'):
            out[k] = batch[k].flatten(0, 1)
        if real_img is not None:
            real_img = real_img.flatten(0, 1)
        return out, real_img

    # ------------------------------------------------------------ schedules
    def schedules(self, cur_nimg):
        """The schedule scalars at ``cur_nimg`` and the neural rendering
        resolution (JAX :123-147); ``swapping_prob`` -1 means disabled
        (zero conditioning)."""
        cfg = self.cfg
        blur_sigma = max(1 - cur_nimg / (cfg.blur_fade_kimg * 1e3), 0) * \
            cfg.blur_init_sigma if cfg.blur_fade_kimg > 0 else 0.0
        alpha = min(cur_nimg / (cfg.gpc_reg_fade_kimg * 1e3), 1) \
            if cfg.gpc_reg_fade_kimg > 0 else 1.0
        swapping_prob = (1 - alpha) + alpha * cfg.gpc_reg_prob \
            if cfg.gpc_reg_prob is not None else None
        if cfg.neural_rendering_resolution_final is not None:
            a = min(cur_nimg / (cfg.neural_rendering_resolution_fade_kimg
                                * 1e3), 1)
            nrr = int(np.rint(cfg.neural_rendering_resolution_initial * (1 - a)
                              + cfg.neural_rendering_resolution_final * a))
        else:
            nrr = cfg.neural_rendering_resolution_initial
        return (dict(blur_sigma=float(blur_sigma),
                     swapping_prob=-1.0 if swapping_prob is None
                     else float(swapping_prob),
                     aug_p=0.0), int(nrr))

    # --------------------------------------------------------------- helpers
    def _synthesis_kwargs(self, generator):
        if self.deterministic:
            return dict(noise_mode='const', generator=None)
        return dict(noise_mode='random', generator=generator)

    @staticmethod
    def _swap_conditioning(c, swapping_prob, generator, per_sample=True):
        """Roll-1 conditioning swap (JAX :150-159); a negative
        ``swapping_prob`` (disabled) gives zero conditioning."""
        shape = (c.shape[0], 1) if per_sample else ()
        u = torch.rand(shape, generator=generator, device=c.device)
        if swapping_prob < 0:
            return torch.zeros_like(c)
        return torch.where(u < swapping_prob, c.roll(1, 0), c)

    def _style_mixing(self, ws, z, c, generator):
        """ws[:, cutoff:] from a fresh mapping of the raw c, with
        probability style_mixing_prob (JAX :161-174)."""
        num_ws = ws.shape[1]
        cutoff = int(torch.randint(1, num_ws, (), generator=generator,
                                   device=ws.device))
        gate = float(torch.rand((), generator=generator, device=ws.device))
        if gate >= self.cfg.style_mixing_prob:
            return ws
        z2 = torch.randn(z.shape, generator=generator, device=z.device)
        ws2 = self.G.mapping(z2, c)
        return torch.cat([ws[:, :cutoff], ws2[:, cutoff:]], dim=1)

    def run_G(self, z, c, v, generator, swapping_prob, nrr):
        """(images, ws, w_mean) (JAX :176-192)."""
        c_cond = self._swap_conditioning(c, swapping_prob, generator)
        ws, w_mean = self.G.mapping(z, c_cond, return_w_mean=True)
        if self.cfg.style_mixing_prob > 0:
            ws = self._style_mixing(ws, z, c, generator)
        kw = self._synthesis_kwargs(generator)
        if self.cfg.remat_synthesis and torch.is_grad_enabled():
            out = self._remat_synthesis(ws, c, v, nrr, **kw)
        else:
            out = self.G.synthesis(ws, c, v, neural_rendering_resolution=nrr,
                                   **kw)
        return out, ws, w_mean

    def _remat_synthesis(self, ws, c, v, nrr, noise_mode, generator):
        """G.synthesis under ``torch.utils.checkpoint``. Both the forward
        and the recompute draw from a generator rebuilt from ``generator``'s
        state before the call (checkpoint restores only the global RNGs),
        and ``generator`` ends where the forward's draws leave it."""
        state = generator.get_state() if generator is not None else None
        after = []

        def synthesis(ws):
            g = None
            if state is not None:
                g = torch.Generator(device=generator.device)
                g.set_state(state)
            out = self.G.synthesis(ws, c, v, neural_rendering_resolution=nrr,
                                   noise_mode=noise_mode, generator=g)
            if g is not None and not after:
                after.append(g.get_state())
            return out

        out = checkpoint(synthesis, ws, use_reentrant=False)
        if after:
            generator.set_state(after[0])
        return out

    def run_D(self, img, c, generator, sched):
        """D's logits (JAX :194-222): the image blurred while blur_sigma >
        0; with the augment pipe, one draw at p = sched['aug_p'] for the
        image and the raw image upsampled to it (antialiased bilinear), the
        raw half resized back; with clips, each clip's frames folded into
        channels (frame-major) and its labels concatenated."""
        image = img['image']
        if self.blur_max_size > 0 and sched['blur_sigma'] > 0:
            image = gaussian_blur_dynamic(image, sched['blur_sigma'],
                                          self.blur_max_size)
        raw = img['image_raw']
        if self.augment_pipe is not None:
            C = image.shape[1]
            up = interpolate_bilinear(raw, image.shape[-1], antialias=True)
            pair = self.augment_pipe(torch.cat([image, up], 1),
                                     sched['aug_p'], generator)
            image = pair[:, :C]
            raw = interpolate_bilinear(pair[:, C:], raw.shape[-1],
                                       antialias=True)
        img = {'image': image, 'image_raw': raw}
        T = self.cfg.num_frames
        if T > 1:
            img = {k: v.reshape(-1, T * v.shape[1], *v.shape[2:])
                   for k, v in img.items()}
            c = c.reshape(-1, T * c.shape[-1])
        return self.D(img, c, generator=generator)

    def prepare_real(self, real_img, blur_sigma, nrr):
        """The raw-branch target of a real batch (JAX :224-234)."""
        with span('sync.real_filter'):
            f = self.resample_filter.to(real_img.device)
        raw = filtered_resizing(real_img, size=nrr, f=f,
                                filter_mode=self.cfg.filter_mode)
        if self.blur_max_size > 0 and blur_sigma > 0:
            raw = gaussian_blur_dynamic(raw, blur_sigma, self.blur_max_size)
        return {'image': real_img, 'image_raw': raw}

    # ---------------------------------------------------------------- phases
    def gmain_loss(self, batch, generator, sched, nrr):
        """(loss, stats, w_mean) (JAX :237-248)."""
        gen_img, _, w_mean = self.run_G(batch['gen_z'], batch['gen_c'],
                                        batch['gen_v'], generator,
                                        sched['swapping_prob'], nrr)
        logits = self.run_D(gen_img, batch['gen_c'], generator, sched)
        loss = F.softplus(-logits).mean()
        stats = {'Loss/scores/fake': logits.mean(),
                 'Loss/signs/fake': logits.sign().mean(),
                 'Loss/G/loss': loss}
        return loss, stats, w_mean

    def _mapped_ws(self, batch, generator, sched):
        """A fresh mapping with one swap draw for the batch (JAX
        :250-261; no style mixing, as there)."""
        c = self._swap_conditioning(batch['gen_c'], sched['swapping_prob'],
                                    generator, per_sample=False)
        return self.G.mapping(batch['gen_z'], c)

    def _sigma_pair(self, ws, gen_v, initial, perturbed, generator,
                    dirs=None):
        coords = torch.cat([initial, perturbed], dim=1)
        if dirs is None:
            dirs = torch.randn(coords.shape, generator=generator,
                               device=coords.device)
        sigma = self.G.sample_mixed(coords, dirs, ws, gen_v,
                                    **self._synthesis_kwargs(generator)
                                    )['sigma']
        half = sigma.shape[1] // 2
        return sigma[:, :half], sigma[:, half:]

    def _points(self, n, count, offset, generator, device, draws):
        """Greg's (initial, perturbed, dirs): ``draws.pop(0)`` when draws
        are given, else uniform points in the box, perturbed by
        ``offset(initial)``."""
        if draws:
            return draws.pop(0)
        initial = torch.rand((n, count, 3), generator=generator,
                             device=device) * 2 - 1
        return initial, initial + offset(initial), None

    def greg_loss(self, batch, generator, sched, draws=None):
        """Density regularization (JAX :271-321), ``reg_type`` 'l1',
        'monotonic-detach' or 'monotonic-fixed'. ``draws``: a list of
        (initial, perturbed, dirs) tuples, one for each sigma pair (one for
        'l1', two for the monotonic types), in place of the drawn ones."""
        cfg = self.cfg
        draws = list(draws) if draws is not None else None
        ws = self._mapped_ws(batch, generator, sched)
        n, dev = ws.shape[0], ws.device

        def noise(scale):
            return lambda x: torch.randn(x.shape, generator=generator,
                                         device=dev) * scale

        if cfg.reg_type == 'l1':
            initial, perturbed, dirs = self._points(
                n, 1000, noise(cfg.density_reg_p_dist), generator, dev,
                draws)
            s0, s1 = self._sigma_pair(ws, batch['gen_v'], initial, perturbed,
                                      generator, dirs)
            loss = (s0 - s1).abs().mean() * cfg.density_reg
            return loss, {'Loss/G/reg': loss}

        if cfg.reg_type not in ('monotonic-detach', 'monotonic-fixed'):
            raise ValueError(f'unknown reg_type {cfg.reg_type!r}')
        step = torch.tensor([0., 0., -1.], device=dev) / 256 * cfg.box_warp
        initial, behind, dirs = self._points(
            n, 2000, lambda x: step.expand_as(x), generator, dev, draws)
        s_front, s_behind = self._sigma_pair(ws, batch['gen_v'], initial,
                                             behind, generator, dirs)
        if cfg.reg_type == 'monotonic-detach':
            s_front = s_front.detach()
        monotonic = F.relu(s_front - s_behind).mean() * 10
        ws2 = self._mapped_ws(batch, generator, sched)
        initial2, perturbed2, dirs2 = self._points(
            n, 1000, noise(cfg.box_warp / 256), generator, dev, draws)
        s0, s1 = self._sigma_pair(ws2, batch['gen_v'], initial2, perturbed2,
                                  generator, dirs2)
        loss = monotonic + (s0 - s1).abs().mean() * cfg.density_reg
        return loss, {'Loss/G/reg': loss}

    def dmain_loss(self, batch, real_img, generator, sched, nrr):
        """(loss, stats, w_mean) (JAX :323-340); G runs without autograd,
        as JAX stops the gradient of its images."""
        with torch.no_grad():
            gen_img, _, w_mean = self.run_G(
                batch['gen_z'], batch['gen_c'], batch['gen_v'], generator,
                sched['swapping_prob'], nrr)
        gen_logits = self.run_D(gen_img, batch['gen_c'], generator, sched)
        loss_dgen = F.softplus(gen_logits).mean()
        real_logits = self.run_D(real_img, batch['real_c'], generator, sched)
        loss_dreal = F.softplus(-real_logits).mean()
        stats = {'Loss/scores/fake': gen_logits.mean(),
                 'Loss/signs/fake': gen_logits.sign().mean(),
                 'Loss/scores/real': real_logits.mean(),
                 'Loss/signs/real': real_logits.sign().mean(),
                 'Loss/D/loss': loss_dgen + loss_dreal}
        return loss_dgen + loss_dreal, stats, w_mean

    def dreg_loss(self, batch, real_img, generator, sched):
        """R1 on image and, with dual discrimination, image_raw: the
        gradient of D's summed logits with respect to them, taken with
        create_graph so that the penalty differentiates into D (JAX
        :342-362)."""
        image = real_img['image'].detach().requires_grad_()
        raw = real_img['image_raw'].detach().requires_grad_(
            self.cfg.dual_discrimination)
        logits = self.run_D({'image': image, 'image_raw': raw},
                            batch['real_c'], generator, sched)
        inputs = [image, raw] if self.cfg.dual_discrimination else [image]
        grads = torch.autograd.grad(logits.sum(), inputs, create_graph=True)
        r1_penalty = sum(g.square().sum(dim=(1, 2, 3)) for g in grads)
        loss = r1_penalty.mean() * (self.cfg.r1_gamma / 2)
        return loss, {'Loss/r1_penalty': r1_penalty.mean(),
                      'Loss/D/reg': loss}
