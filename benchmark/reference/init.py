"""Random parameters drawn on the device from a seed, in one call.

The model constructors of this package take their standard-normal leaves
from ``randn``. Inside ``build`` each such leaf is left empty and recorded
with its scale; once the module stands, one ``torch.randn`` over all of
them, on the device from a ``torch.Generator`` seeded with the seed, fills
them in the order of construction. The constant leaves (biases, the
orthographic scale and shift, ``w_avg``) keep the values their
constructors give. The same seed gives the same weights on every call,
and the benchmark hands them to the program (``load_state_dict``) and to
this reference alike.
"""

from __future__ import annotations

import contextlib
import itertools

import torch

_pending = None


def randn(*shape, generator=None, scale=1.0):
    """A standard-normal leaf times ``scale``: drawn now from ``generator``
    outside ``build``, recorded to be drawn inside it."""
    if _pending is None:
        return torch.randn(*shape, generator=generator) * scale
    leaf = torch.empty(*shape)
    _pending.append((leaf, scale))
    return leaf


@contextlib.contextmanager
def _deferred():
    global _pending
    _pending = []
    try:
        yield _pending
    finally:
        _pending = None


def build(make, seed, device):
    """``make()`` on ``device`` with its random leaves drawn from ``seed``."""
    with _deferred() as pending:
        module = make()
    owner = {t.data_ptr(): name for name, t in itertools.chain(
        module.named_parameters(), module.named_buffers())}
    order = [(owner[leaf.data_ptr()], scale) for leaf, scale in pending]
    module = module.to(device)
    leaves = dict(itertools.chain(module.named_parameters(),
                                  module.named_buffers()))
    total = sum(leaves[name].numel() for name, _ in order)
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(total, generator=gen, device=device)
    with torch.no_grad():
        at = 0
        for name, scale in order:
            leaf = leaves[name]
            leaf.copy_(flat[at:at + leaf.numel()].view_as(leaf) * scale)
            at += leaf.numel()
    return module
