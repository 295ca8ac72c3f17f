"""TF-era (StyleGAN2/StyleGAN2-ADA TensorFlow) pickle conversion.

The port's numpy copy of next3d_tpu/utils/legacy.py. Behavioral spec:
legacy.py:24-295 — a legacy pickle is a 3-tuple of
`dnnlib.tflib.network.Network` objects (G, D, Gs); `convert_tf_generator` /
`convert_tf_discriminator` map their static_kwargs + variable collections
onto the torch module tree. This module produces (init_kwargs, flat
state_dict) pairs directly: same kwarg translation (legacy.py:125-160,229-252),
same variable-name mapping incl. the up/down conv weight flips and the
mod_bias + 1 shift (:175-207,275-293). The converted G loads into
``nn/stylegan2.py Generator``, the converted D into ``nn/discriminator.py
Discriminator``.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np


class TFNetworkStub:
    """Attribute bag standing in for dnnlib.tflib.network.Network during
    unpickling (reference legacy.py:64-66)."""

    def __setstate__(self, state):
        self.__dict__.update(state)


def is_tf_legacy_data(data) -> bool:
    return (isinstance(data, tuple) and len(data) == 3
            and all(isinstance(n, TFNetworkStub) for n in data))


def collect_tf_params(tf_net) -> Dict[str, np.ndarray]:
    """Flatten the Network's variable collections (legacy.py:78-88)."""
    out: Dict[str, np.ndarray] = {}

    def recurse(prefix, net):
        for name, value in net.variables:
            out[prefix + name] = np.asarray(value)
        for name, comp in getattr(net, 'components', {}).items():
            recurse(prefix + name + '/', comp)

    recurse('', tf_net)
    return out


def _kwargs(tf_kwargs, spec, passthrough=()):
    known = set(passthrough)
    out = {}
    for our_name, tf_name, default in spec:
        known.add(tf_name)
        val = tf_kwargs.get(tf_name, default)
        out[our_name] = val
    unknown = set(tf_kwargs) - known
    if unknown:
        raise ValueError('Unknown TensorFlow kwarg', sorted(unknown)[0])
    return out


def convert_tf_generator(tf_G) -> Tuple[Dict[str, Any], Dict[str, np.ndarray]]:
    """-> (init_kwargs for nn.Generator, torch-style flat state_dict)."""
    if tf_G.version < 4:
        raise ValueError('TensorFlow pickle version too low')
    k = dict(tf_G.static_kwargs)
    top = _kwargs(k, [
        ('z_dim', 'latent_size', 512),
        ('c_dim', 'label_size', 0),
        ('w_dim', 'dlatent_size', 512),
        ('img_resolution', 'resolution', 1024),
        ('img_channels', 'num_channels', 3),
        ('channel_base', 'fmap_base', 16384),
        ('channel_max', 'fmap_max', 512),
        ('num_fp16_res', 'num_fp16_res', 0),
        ('conv_clamp', 'conv_clamp', None),
        ('architecture', 'architecture', 'skip'),
        ('resample_filter', 'resample_kernel', [1, 3, 3, 1]),
        ('use_noise', 'use_noise', True),
        ('activation', 'nonlinearity', 'lrelu'),
        ('_map_layers', 'mapping_layers', 8),
        ('_map_embed', 'label_fmaps', None),
        ('_map_feats', 'mapping_fmaps', None),
        ('_map_act', 'mapping_nonlinearity', 'lrelu'),
        ('_map_lr', 'mapping_lrmul', 0.01),
        ('_map_beta', 'w_avg_beta', 0.995),
    ], passthrough=('truncation_psi', 'truncation_cutoff',
                    'style_mixing_prob', 'structure', 'conditioning',
                    'fused_modconv'))
    top['channel_base'] *= 2
    mapping_kwargs = dict(
        num_layers=top.pop('_map_layers'),
        embed_features=top.pop('_map_embed'),
        layer_features=top.pop('_map_feats'),
        activation=top.pop('_map_act'),
        lr_multiplier=top.pop('_map_lr'),
        w_avg_beta=top.pop('_map_beta') or 1,
    )
    init_kwargs = dict(top, mapping_kwargs=mapping_kwargs)

    p = collect_tf_params(tf_G)
    res = init_kwargs['img_resolution']
    import re
    for name, value in list(p.items()):
        m = re.fullmatch(r'ToRGB_lod(\d+)/(.*)', name)
        if m:  # progressive-growing export (legacy.py:164-169)
            r = res // (2 ** int(m.group(1)))
            p[f'{r}x{r}/ToRGB/{m.group(2)}'] = value
            init_kwargs['architecture'] = 'orig'

    sd: Dict[str, np.ndarray] = {'mapping.w_avg': p['dlatent_avg']}
    if init_kwargs['c_dim'] > 0:
        sd['mapping.embed.weight'] = p['mapping/LabelEmbed/weight'].T
        sd['mapping.embed.bias'] = p['mapping/LabelEmbed/bias']
    for i in range(mapping_kwargs['num_layers']):
        sd[f'mapping.fc{i}.weight'] = p[f'mapping/Dense{i}/weight'].T
        sd[f'mapping.fc{i}.bias'] = p[f'mapping/Dense{i}/bias']

    def conv(dst, src, flip=False, noise=None):
        w = p[f'{src}/weight']
        if flip:
            w = w[::-1, ::-1]
        sd[f'{dst}.weight'] = w.transpose(3, 2, 0, 1)
        sd[f'{dst}.bias'] = p[f'{src}/bias']
        sd[f'{dst}.affine.weight'] = p[f'{src}/mod_weight'].T
        sd[f'{dst}.affine.bias'] = p[f'{src}/mod_bias'] + 1
        if noise is not None:
            sd[f'{dst}.noise_const'] = p[f'synthesis/noise{noise}'][0, 0]
            sd[f'{dst}.noise_strength'] = \
                np.asarray(p[f'{src}/noise_strength'])

    sd['synthesis.b4.const'] = p['synthesis/4x4/Const/const'][0]
    conv('synthesis.b4.conv1', 'synthesis/4x4/Conv', noise=0)
    r = 8
    while r <= res:
        lg = int(np.log2(r))
        conv(f'synthesis.b{r}.conv0', f'synthesis/{r}x{r}/Conv0_up',
             flip=True, noise=2 * lg - 5)
        conv(f'synthesis.b{r}.conv1', f'synthesis/{r}x{r}/Conv1',
             noise=2 * lg - 4)
        if init_kwargs['architecture'] == 'resnet':
            sd[f'synthesis.b{r}.skip.weight'] = \
                p[f'{r}x{r}/Skip/weight'][::-1, ::-1].transpose(3, 2, 0, 1)
        r *= 2
    # torgb for every block in 'skip'/'orig' architectures
    r = 4
    while r <= res:
        key = f'synthesis/{r}x{r}/ToRGB'
        if f'{key}/weight' in p:
            sd[f'synthesis.b{r}.torgb.weight'] = \
                p[f'{key}/weight'].transpose(3, 2, 0, 1)
            sd[f'synthesis.b{r}.torgb.bias'] = p[f'{key}/bias']
            sd[f'synthesis.b{r}.torgb.affine.weight'] = \
                p[f'{key}/mod_weight'].T
            sd[f'synthesis.b{r}.torgb.affine.bias'] = \
                p[f'{key}/mod_bias'] + 1
        r *= 2
    return init_kwargs, sd


def convert_tf_discriminator(tf_D):
    """-> (init_kwargs for nn.Discriminator, torch-style flat state_dict)."""
    if tf_D.version < 4:
        raise ValueError('TensorFlow pickle version too low')
    k = dict(tf_D.static_kwargs)
    top = _kwargs(k, [
        ('c_dim', 'label_size', 0),
        ('img_resolution', 'resolution', 1024),
        ('img_channels', 'num_channels', 3),
        ('architecture', 'architecture', 'resnet'),
        ('channel_base', 'fmap_base', 16384),
        ('channel_max', 'fmap_max', 512),
        ('num_fp16_res', 'num_fp16_res', 0),
        ('conv_clamp', 'conv_clamp', None),
        ('cmap_dim', 'mapping_fmaps', None),
        ('_act', 'nonlinearity', 'lrelu'),
        ('_filter', 'resample_kernel', [1, 3, 3, 1]),
        ('_freeze', 'freeze_layers', 0),
        ('_map_layers', 'mapping_layers', 0),
        ('_map_lr', 'mapping_lrmul', 0.1),
        ('_mbstd_group', 'mbstd_group_size', None),
        ('_mbstd_feats', 'mbstd_num_features', 1),
    ], passthrough=('structure', 'conditioning'))
    top['channel_base'] *= 2
    init_kwargs = dict(
        {kk: v for kk, v in top.items() if not kk.startswith('_')},
        block_kwargs=dict(activation=top['_act'],
                          resample_filter=top['_filter'],
                          freeze_layers=top['_freeze']),
        mapping_kwargs=dict(num_layers=top['_map_layers'],
                            lr_multiplier=top['_map_lr']),
        epilogue_kwargs=dict(mbstd_group_size=top['_mbstd_group'],
                             mbstd_num_channels=top['_mbstd_feats'],
                             activation=top['_act']))

    p = collect_tf_params(tf_D)
    res = init_kwargs['img_resolution']
    import re
    for name, value in list(p.items()):
        m = re.fullmatch(r'FromRGB_lod(\d+)/(.*)', name)
        if m:
            r = res // (2 ** int(m.group(1)))
            p[f'{r}x{r}/FromRGB/{m.group(2)}'] = value
            init_kwargs['architecture'] = 'orig'

    sd: Dict[str, np.ndarray] = {}
    r = res
    while r >= 8:
        if f'{r}x{r}/FromRGB/weight' in p:
            sd[f'b{r}.fromrgb.weight'] = \
                p[f'{r}x{r}/FromRGB/weight'].transpose(3, 2, 0, 1)
            sd[f'b{r}.fromrgb.bias'] = p[f'{r}x{r}/FromRGB/bias']
        for i, suffix in ((0, ''), (1, '_down')):
            sd[f'b{r}.conv{i}.weight'] = \
                p[f'{r}x{r}/Conv{i}{suffix}/weight'].transpose(3, 2, 0, 1)
            sd[f'b{r}.conv{i}.bias'] = p[f'{r}x{r}/Conv{i}{suffix}/bias']
        if init_kwargs['architecture'] == 'resnet':
            sd[f'b{r}.skip.weight'] = \
                p[f'{r}x{r}/Skip/weight'].transpose(3, 2, 0, 1)
        r //= 2
    for i in range(init_kwargs['mapping_kwargs']['num_layers']):
        sd[f'mapping.fc{i}.weight'] = p[f'Mapping{i}/weight'].T
        sd[f'mapping.fc{i}.bias'] = p[f'Mapping{i}/bias']
    if init_kwargs['c_dim'] > 0 and 'LabelEmbed/weight' in p:
        sd['mapping.embed.weight'] = p['LabelEmbed/weight'].T
        sd['mapping.embed.bias'] = p['LabelEmbed/bias']
    sd['b4.conv.weight'] = p['4x4/Conv/weight'].transpose(3, 2, 0, 1)
    sd['b4.conv.bias'] = p['4x4/Conv/bias']
    sd['b4.fc.weight'] = p['4x4/Dense0/weight'].T
    sd['b4.fc.bias'] = p['4x4/Dense0/bias']
    sd['b4.out.weight'] = p['Output/weight'].T
    sd['b4.out.bias'] = p['Output/bias']
    return init_kwargs, sd
