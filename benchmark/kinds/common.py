"""Pieces the kinds of work share: the sample of kept units, the gaps of
a generator's outputs to the reference's, and the roofline's shapes of a
generator."""

from __future__ import annotations

import random

import torch

from ..traffic import subseed


class Sample:
    """A uniform sample, drawn from the seed, of at most ``k`` of the units
    a window finishes (reservoir sampling), so that what the check keeps
    does not grow with the rate."""

    def __init__(self, seed, k):
        self.rng = random.Random(subseed(seed, 'sample'))
        self.k = k
        self.seen = 0
        self.kept = {}

    def offer(self, i, value):
        if len(self.kept) < self.k:
            self.kept[i] = value
        else:
            j = self.rng.randrange(self.seen + 1)
            if j < self.k:
                del self.kept[sorted(self.kept)[j]]
                self.kept[i] = value
        self.seen += 1


def gap(got, want):
    """max |got - want| over max |want|: the widest gap of an output,
    relative to the reference's own scale."""
    got, want = got.double(), want.double()
    return float((got - want).abs().max() / want.abs().max())


def opaque_gap(got, want, opacity):
    """max(opacity * |got - want|) over max |want|: the widest gap of a
    depth image, each ray's weighted by the reference's opacity of it. A
    ray's depth is its weights' mean depth, sum(w d) / sum(w); on a ray
    that is all but empty (sum(w) of 1e-6 to 1e-4) float32's round-off in
    the weights (1 - exp(-sigma delta) of a tiny sigma delta) moves that
    mean by up to a tenth of the ray's depth range, on either side alike,
    and the opacity weighs it back to the round-off it is."""
    got, want, opacity = got.double(), want.double(), opacity.double()
    return float((opacity * (got - want).abs()).max() / want.abs().max())


def image_gaps(got, want):
    """The compared numbers of a generator's outputs ``got`` against the
    reference's ``want`` (which also holds its ``image_opacity``)."""
    return {'image_gap': gap(got['image'], want['image']),
            'image_raw_gap': gap(got['image_raw'], want['image_raw']),
            'opaque_depth_gap': opaque_gap(got['image_depth'],
                                           want['image_depth'],
                                           want['image_opacity'])}


COMPARED = ('image_gap', 'image_raw_gap', 'opaque_depth_gap')


def worst_gaps(pairs):
    """The widest of each compared number over (got, want) pairs."""
    worst = dict.fromkeys(COMPARED, 0.0)
    for got, want in pairs:
        for k, v in image_gaps(got, want).items():
            worst[k] = max(worst[k], v)
    return worst


def generator_shapes(cfg, batch):
    """The roofline's shapes of one batch of a tri-plane generator's
    forward: K4's two passes and the rasterizer's 4 views."""
    g = cfg['G_kwargs']
    rk = g['rendering_kwargs']
    res = g.get('plane_resolution', 256)
    rays = cfg['neural_rendering_resolution'] ** 2
    planes = dict(N=batch, H=res, W=res, C=cfg['plane_channels'])
    k4 = [dict(planes, M=rays * rk['depth_resolution']),
          dict(planes, M=rays * rk['depth_resolution_importance'])]
    raster = dict(B=4 * batch, V=cfg['mesh_verts'], F=cfg['mesh_faces'],
                  R=res)
    return dict(k4=k4, raster=raster)


def no_grad_eval(net):
    return net.eval().requires_grad_(False)


class FlopCount:
    """Counts the floating-point operations of the ops run under it, by
    ``torch.utils.flop_counter``'s table (matrix products and
    convolutions, forward and backward). A plain dispatch mode: unlike
    ``FlopCounterMode`` it tracks no modules, so it works under
    ``torch.autograd.grad`` (R1)."""

    def __init__(self):
        self.total = 0
        self._mode = None

    def __enter__(self):
        from torch.utils._python_dispatch import TorchDispatchMode
        from torch.utils.flop_counter import flop_registry
        counter = self

        class _Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                kwargs = kwargs or {}
                out = func(*args, **kwargs)
                count = flop_registry.get(func._overloadpacket)
                if count is not None:
                    counter.total += count(*args, **kwargs, out_val=out)
                return out
        self._mode = _Mode()
        self._mode.__enter__()
        return self

    def __exit__(self, *exc):
        self._mode.__exit__(*exc)


def flops(fn):
    """Floating-point operations of ``fn()`` (``FlopCount``)."""
    with FlopCount() as counter:
        fn()
    return counter.total


def free(device):
    if device.type == 'cuda':
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
