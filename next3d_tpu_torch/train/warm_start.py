"""Warm-start remapping for reference checkpoints.

Counterpart of next3d_tpu/train/warm_start.py, on the port's parameter
trees (nested dicts of numpy arrays, ``utils/weights.py
state_dict_to_params``), so that the result loads with ``load_jax_params``.
Behavioral spec: training_avatar_texture/training_loop.py:180-207 — when
resuming from a vanilla EG3D pickle, the single 'backbone' weights are also
copied into the texture/mouth/blending backbones (with require_all=False:
only matching names+shapes transfer).
"""

from __future__ import annotations

import numpy as np


def copy_matching_params(dst, src):
    """Recursively copy leaves from src into dst where names AND shapes match
    (the reference's misc.copy_params_and_buffers with require_all=False);
    every other leaf of dst stays."""
    if not isinstance(dst, dict):
        if src is None or isinstance(src, dict):
            return dst
        src_arr = np.asarray(src)
        if src_arr.shape == np.shape(dst):
            return np.array(src_arr)
        return dst
    return {k: copy_matching_params(
        v, src.get(k) if isinstance(src, dict) else None)
        for k, v in dst.items()}


def eg3d_to_next3d(params):
    """EG3D -> Next3D warm-start mapping (reference training_loop.py:187-207):
    the EG3D backbone seeds texture_backbone / mouth_backbone /
    neural_blending alongside the static backbone."""
    if 'backbone' not in params:
        return params
    out = dict(params)
    for name in ('texture_backbone', 'mouth_backbone', 'neural_blending'):
        out.setdefault(name, params['backbone'])
    return out
