"""The program's networks and the reference's, with the same weights.

A configuration names the program's class and the reference's
(``program_class`` / ``reference_class``, as 'module:Name') and their
keyword arguments. The weights are the reference's: its constructor's
constants and its random leaves drawn on the device from the seed
(``reference/init.py``). The program is built by its own constructor and
then loads them with ``load_state_dict(strict=True)``, so both sides hold
the same numbers and neither takes anything from the other.
"""

from __future__ import annotations

import torch

from . import harness
from .reference import init
from .traffic import subseed


def reference(cfg, kwargs_key, seed, device, tag, mesh=None):
    """The reference network ``kwargs_key`` of ``cfg`` (``G_kwargs`` or
    ``D_kwargs``) on ``device``, its random leaves from (seed, tag)."""
    cls = harness.load_attr(cfg['reference_class'][kwargs_key])
    kw = dict(cfg[kwargs_key])
    if mesh is not None:
        kw['topology_path'] = mesh
    return init.build(lambda: cls(**kw), subseed(seed, 'weights', tag),
                      device)


def program(cfg, kwargs_key, state, device, mesh=None):
    """The program's network ``kwargs_key`` of ``cfg`` on ``device``,
    holding the weights ``state``."""
    cls = harness.load_attr(cfg['program_class'][kwargs_key])
    kw = dict(cfg[kwargs_key])
    if mesh is not None:
        kw['topology_path'] = harness.load_attr(cfg['program_mesh'])(*mesh)
    net = cls(**kw).to(device)
    net.load_state_dict(state, strict=True)
    return net


def pair_weights(cfg, kwargs_key, seed, device, tag, mesh=None):
    """The program's network with the weights of the seed, the reference
    already freed."""
    ref = reference(cfg, kwargs_key, seed, device, tag, mesh)
    net = program(cfg, kwargs_key, ref.state_dict(), device, mesh)
    del ref
    if device.type == 'cuda':
        torch.cuda.empty_cache()
    return net
