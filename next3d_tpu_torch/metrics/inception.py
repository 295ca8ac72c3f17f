"""The Inception-2015 feature detector (FID/KID/PR features, IS
probabilities) as a torch module.

Counterpart of next3d_tpu/metrics/inception_jax.py. The reference runs
NVIDIA's ``inception-2015-12-05`` TorchScript pickle
(``metrics/frechet_inception_distance.py:24``): TensorFlow's Inception
2015-12-05 graph up to ``pool_3`` (2048 features) and its 1008-way output
layer. ``InceptionV3`` is that graph: each convolution is conv -> batch norm
(eps 1e-3, beta only) -> relu; the stem, the 35x35 blocks mixed_0-2
(``MixedA``), the grid reduction mixed_3 (``MixedB``), the 17x17 blocks
mixed_4-7 with factorized 7x7s (``MixedC``), the grid reduction mixed_8
(``MixedD``) and the 8x8 blocks mixed_9 and mixed_10 (``MixedE``, whose
pool branch averages in mixed_9 and takes the maximum in mixed_10, as the
2015 graph does); average pooling counts the padding.

The input is uint8 (N, 3, H, W) RGB of any size: resized to 299x299 by
antialiased bilinear interpolation (half-pixel centres) when its size
differs, which equals ``jax.image.resize(..., 'bilinear')`` of the JAX
package in both directions, then normalised as (x - 128) / 128. The module
takes the pickle's calling convention: ``model(images,
return_features=True)`` gives the features, ``model(images,
no_output_bias=True)`` the softmax of the logits without the output bias
(the IS detector, reference inception_score.py:23), and it scripts with
``torch.jit.script``.

``convert_torchscript_inception`` reads the pickle's convolutions in
definition order with strict shape checks, as the JAX converter does;
``attest_parity`` holds the converted module to the pickle run on the same
device before ``make_detector`` hands it out, and raises where they
disagree. ``state_dict_of_params`` carries the JAX package's param tree
(``inception_jax.init_params``) into the module.
"""

from __future__ import annotations

import functools
import hashlib
import json
import os
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .metric_utils import to_device

BN_EPS = 1e-3
NUM_FEATURES = 2048
NUM_LOGITS = 1008  # the 2015 graph's 1008-way softmax (background class)
PARITY_TOL = 5e-2  # the JAX package's attestation bound (inception_jax.py)

# convolutions that do not pad although their kernel is wider than 1 (the
# others of stride 1 pad as 'SAME'), and those of stride 2 (none pads)
_VALID = {('stem', 'conv2'), ('stem', 'conv5')}
_STRIDE2 = {('stem', 'conv1'), ('mixed_3', 'conv3x3'), ('mixed_3', 'dbl_3'),
            ('mixed_8', 'c3_2'), ('mixed_8', 'c7_4')}


def conv_specs():
    """(block, name, (out_c, in_c, kh, kw)) of every convolution, in
    definition order: the converter's matching key (JAX :123-178)."""
    specs = []

    def c(block, key, oc, ic, kh, kw):
        specs.append((block, key, (oc, ic, kh, kw)))

    c('stem', 'conv1', 32, 3, 3, 3)
    c('stem', 'conv2', 32, 32, 3, 3)
    c('stem', 'conv3', 64, 32, 3, 3)
    c('stem', 'conv4', 80, 64, 1, 1)
    c('stem', 'conv5', 192, 80, 3, 3)
    for i, pool_c in enumerate((32, 64, 64)):
        blk = f'mixed_{i}'
        in_c = (192, 256, 288)[i]
        c(blk, 'conv1x1', 64, in_c, 1, 1)
        c(blk, 'conv5x5_1', 48, in_c, 1, 1)
        c(blk, 'conv5x5_2', 64, 48, 5, 5)
        c(blk, 'conv3x3_1', 64, in_c, 1, 1)
        c(blk, 'conv3x3_2', 96, 64, 3, 3)
        c(blk, 'conv3x3_3', 96, 96, 3, 3)
        c(blk, 'pool', pool_c, in_c, 1, 1)
    c('mixed_3', 'conv3x3', 384, 288, 3, 3)
    c('mixed_3', 'dbl_1', 64, 288, 1, 1)
    c('mixed_3', 'dbl_2', 96, 64, 3, 3)
    c('mixed_3', 'dbl_3', 96, 96, 3, 3)
    for i, c7 in enumerate((128, 160, 160, 192)):
        blk = f'mixed_{4 + i}'
        c(blk, 'conv1x1', 192, 768, 1, 1)
        c(blk, 'c7_1', c7, 768, 1, 1)
        c(blk, 'c7_2', c7, c7, 1, 7)
        c(blk, 'c7_3', 192, c7, 7, 1)
        c(blk, 'dbl_1', c7, 768, 1, 1)
        c(blk, 'dbl_2', c7, c7, 7, 1)
        c(blk, 'dbl_3', c7, c7, 1, 7)
        c(blk, 'dbl_4', c7, c7, 7, 1)
        c(blk, 'dbl_5', 192, c7, 1, 7)
        c(blk, 'pool', 192, 768, 1, 1)
    c('mixed_8', 'c3_1', 192, 768, 1, 1)
    c('mixed_8', 'c3_2', 320, 192, 3, 3)
    c('mixed_8', 'c7_1', 192, 768, 1, 1)
    c('mixed_8', 'c7_2', 192, 192, 1, 7)
    c('mixed_8', 'c7_3', 192, 192, 7, 1)
    c('mixed_8', 'c7_4', 192, 192, 3, 3)
    for i in range(2):
        blk = f'mixed_{9 + i}'
        in_c = (1280, 2048)[i]
        c(blk, 'conv1x1', 320, in_c, 1, 1)
        c(blk, 'c3_1', 384, in_c, 1, 1)
        c(blk, 'c3_2a', 384, 384, 1, 3)
        c(blk, 'c3_2b', 384, 384, 3, 1)
        c(blk, 'dbl_1', 448, in_c, 1, 1)
        c(blk, 'dbl_2', 384, 448, 3, 3)
        c(blk, 'dbl_3a', 384, 384, 1, 3)
        c(blk, 'dbl_3b', 384, 384, 3, 1)
        c(blk, 'pool', 192, in_c, 1, 1)
    return specs


class ConvBN(nn.Module):
    """conv -> batch norm with running statistics and beta only -> relu.
    ``weight`` and ``bias`` (beta) with ``running_mean`` and
    ``running_var`` in one module, as the converter finds them."""

    def __init__(self, shape: Tuple[int, int, int, int], stride: int,
                 padding: Tuple[int, int]):
        super().__init__()
        oc = shape[0]
        self.weight = nn.Parameter(torch.zeros(shape), requires_grad=False)
        self.bias = nn.Parameter(torch.zeros(oc), requires_grad=False)
        self.register_buffer('running_mean', torch.zeros(oc))
        self.register_buffer('running_var', torch.ones(oc))
        self.stride = stride
        self.padding = padding
        self.eps = BN_EPS

    def forward(self, x):
        y = F.conv2d(x, self.weight, stride=self.stride,
                     padding=self.padding)
        scale = torch.rsqrt(self.running_var + self.eps)
        y = (y - self.running_mean[None, :, None, None]) \
            * scale[None, :, None, None] + self.bias[None, :, None, None]
        return F.relu(y)


class _Block(nn.Module):
    """The convolutions of one block of ``conv_specs``, as attributes in
    definition order."""

    def __init__(self, block):
        super().__init__()
        for blk, name, shape in conv_specs():
            if blk != block:
                continue
            stride = 2 if (blk, name) in _STRIDE2 else 1
            same = stride == 1 and (blk, name) not in _VALID
            padding = ((shape[2] - 1) // 2, (shape[3] - 1) // 2) if same \
                else (0, 0)
            setattr(self, name, ConvBN(shape, stride, padding))


def _max_pool(x, stride: int = 2):
    return F.max_pool2d(x, 3, stride)


def _avg_pool_same(x):
    """3x3 stride-1 average pool padded by 1, counting the padding (TF's
    avg_pool in the 2015 graph)."""
    return F.avg_pool2d(x, 3, 1, 1, count_include_pad=True)


class Stem(_Block):
    def __init__(self):
        super().__init__('stem')

    def forward(self, x):
        x = self.conv3(self.conv2(self.conv1(x)))
        x = self.conv5(self.conv4(_max_pool(x)))
        return _max_pool(x)


class MixedA(_Block):
    """35x35 block (mixed_0, mixed_1, mixed_2)."""

    def forward(self, x):
        b0 = self.conv1x1(x)
        b1 = self.conv5x5_2(self.conv5x5_1(x))
        b2 = self.conv3x3_3(self.conv3x3_2(self.conv3x3_1(x)))
        b3 = self.pool(_avg_pool_same(x))
        return torch.cat([b0, b1, b2, b3], 1)


class MixedB(_Block):
    """Grid reduction 35 -> 17 (mixed_3)."""

    def forward(self, x):
        b0 = self.conv3x3(x)
        b1 = self.dbl_3(self.dbl_2(self.dbl_1(x)))
        return torch.cat([b0, b1, _max_pool(x)], 1)


class MixedC(_Block):
    """17x17 block with factorized 7x7s (mixed_4 .. mixed_7)."""

    def forward(self, x):
        b0 = self.conv1x1(x)
        b1 = self.c7_3(self.c7_2(self.c7_1(x)))
        b2 = self.dbl_5(self.dbl_4(self.dbl_3(self.dbl_2(self.dbl_1(x)))))
        b3 = self.pool(_avg_pool_same(x))
        return torch.cat([b0, b1, b2, b3], 1)


class MixedD(_Block):
    """Grid reduction 17 -> 8 (mixed_8)."""

    def forward(self, x):
        b0 = self.c3_2(self.c3_1(x))
        b1 = self.c7_4(self.c7_3(self.c7_2(self.c7_1(x))))
        return torch.cat([b0, b1, _max_pool(x)], 1)


class MixedE(_Block):
    """8x8 block (mixed_9 with an average-pool branch, mixed_10 with a
    max-pool branch)."""

    def __init__(self, block: str, pool_max: bool):
        super().__init__(block)
        self.pool_max = pool_max

    def forward(self, x):
        b0 = self.conv1x1(x)
        b1 = self.c3_1(x)
        b1 = torch.cat([self.c3_2a(b1), self.c3_2b(b1)], 1)
        b2 = self.dbl_2(self.dbl_1(x))
        b2 = torch.cat([self.dbl_3a(b2), self.dbl_3b(b2)], 1)
        if self.pool_max:
            pooled = F.max_pool2d(x, 3, 1, 1)
        else:
            pooled = _avg_pool_same(x)
        return torch.cat([b0, b1, b2, self.pool(pooled)], 1)


def resize_299(x):
    """float (N, C, H, W) -> (N, C, 299, 299) by antialiased bilinear
    interpolation, or ``x`` at that size already."""
    if x.shape[2] == 299 and x.shape[3] == 299:
        return x
    return F.interpolate(x, size=(299, 299), mode='bilinear',
                         align_corners=False, antialias=True)


class InceptionV3(nn.Module):
    """The Inception-2015 graph; random weights until a checkpoint loads
    (``state_dict_of_params``, ``convert_torchscript_inception``)."""

    def __init__(self):
        super().__init__()
        self.stem = Stem()
        self.mixed_0 = MixedA('mixed_0')
        self.mixed_1 = MixedA('mixed_1')
        self.mixed_2 = MixedA('mixed_2')
        self.mixed_3 = MixedB('mixed_3')
        self.mixed_4 = MixedC('mixed_4')
        self.mixed_5 = MixedC('mixed_5')
        self.mixed_6 = MixedC('mixed_6')
        self.mixed_7 = MixedC('mixed_7')
        self.mixed_8 = MixedD('mixed_8')
        self.mixed_9 = MixedE('mixed_9', False)
        self.mixed_10 = MixedE('mixed_10', True)
        self.output = nn.Linear(NUM_FEATURES, NUM_LOGITS)
        for p in self.output.parameters():
            p.requires_grad_(False)

    def features(self, img):
        """uint8 (N, 3, H, W) -> (N, 2048) pool_3 features."""
        x = resize_299(img.to(torch.float32))
        x = (x - 128.0) / 128.0
        x = self.stem(x)
        x = self.mixed_2(self.mixed_1(self.mixed_0(x)))
        x = self.mixed_3(x)
        x = self.mixed_7(self.mixed_6(self.mixed_5(self.mixed_4(x))))
        x = self.mixed_10(self.mixed_9(self.mixed_8(x)))
        return x.mean(dim=[2, 3])

    def forward(self, img, return_features: bool = False,
                no_output_bias: bool = False):
        feat = self.features(img)
        if return_features:
            return feat
        if no_output_bias:
            logits = F.linear(feat, self.output.weight)
        else:
            logits = self.output(feat)
        return F.softmax(logits, dim=1)


# ------------------------------------------------------------------ weights
def init_params(seed):
    """A seeded param tree of numpy arrays in the layout of
    ``inception_jax.init_params`` (per convolution w, beta, mean, var; the
    output layer's w (2048, 1008) and b): He-scaled weights and batch-norm
    statistics away from the identity, so that every leaf moves the
    features."""
    rs = np.random.RandomState(seed)
    params = {}
    for blk, name, (oc, ic, kh, kw) in conv_specs():
        params.setdefault(blk, {})[name] = dict(
            w=(rs.randn(oc, ic, kh, kw) * np.sqrt(2.0 / (ic * kh * kw)))
            .astype(np.float32),
            beta=(rs.randn(oc) * 0.1).astype(np.float32),
            mean=(rs.randn(oc) * 0.1).astype(np.float32),
            var=rs.uniform(0.5, 1.5, oc).astype(np.float32))
    params['output'] = dict(
        w=(rs.randn(NUM_FEATURES, NUM_LOGITS) / np.sqrt(NUM_FEATURES))
        .astype(np.float32),
        b=(rs.randn(NUM_LOGITS) * 0.1).astype(np.float32))
    return params


def state_dict_of_params(params):
    """The JAX package's Inception param tree (numpy or JAX arrays) as
    ``InceptionV3``'s state_dict."""
    sd = {}
    for blk, name, _ in conv_specs():
        p = params[blk][name]
        for leaf, key in (('w', 'weight'), ('beta', 'bias'),
                          ('mean', 'running_mean'), ('var', 'running_var')):
            sd[f'{blk}.{name}.{key}'] = torch.from_numpy(
                np.array(p[leaf], np.float32))
    sd['output.weight'] = torch.from_numpy(
        np.array(params['output']['w'], np.float32).T.copy())
    sd['output.bias'] = torch.from_numpy(
        np.array(params['output']['b'], np.float32))
    return sd


def inception_of_params(params, device='cpu'):
    """An ``InceptionV3`` in eval mode on ``device`` with the weights of a
    JAX-layout param tree."""
    model = InceptionV3()
    model.load_state_dict(state_dict_of_params(params))
    return model.to(device).eval()


# ---------------------------------------------------------------- converter
def convert_torchscript_inception(path):
    """The TorchScript pickle's weights as a JAX-layout param tree of numpy
    arrays (JAX :253-318): its 4-D weights, in definition order, matched
    to ``conv_specs`` with strict shape checks, each with the batch-norm
    statistics of its own module or else of the one sibling with as many
    channels; the 2-D weight is the output layer. A count or shape that
    does not match raises: no detector rather than a wrong one."""
    model = torch.jit.load(path, map_location='cpu').eval()
    by_mod = {}
    for name, t in list(model.named_parameters()) + \
            list(model.named_buffers()):
        mod, _, leaf = name.rpartition('.')
        by_mod.setdefault(mod, {})[leaf] = t.detach().cpu().numpy()
    conv_mods, bns, fc = [], {}, None
    for mod, leaves in by_mod.items():
        if 'weight' in leaves and leaves['weight'].ndim == 4:
            conv_mods.append((mod, leaves))
        elif 'weight' in leaves and leaves['weight'].ndim == 2:
            fc = leaves
        if 'running_mean' in leaves:
            bns[mod] = leaves

    specs = conv_specs()
    if len(conv_mods) != len(specs):
        raise RuntimeError(
            f'TorchScript inception has {len(conv_mods)} convs, expected '
            f'{len(specs)} — architecture mismatch, refusing to convert')
    params = {}
    for (blk, name, shape), (mod, leaves) in zip(specs, conv_mods):
        w = leaves['weight']
        if tuple(w.shape) != shape:
            raise RuntimeError(
                f'{blk}.{name}: TorchScript conv {mod} has shape '
                f'{tuple(w.shape)}, expected {shape}')
        bn = bns.get(mod)
        if bn is None:
            cands = [m for m, lv in bns.items()
                     if m.startswith(mod.rsplit('.', 1)[0])
                     and lv['running_mean'].shape[0] == shape[0]]
            if len(cands) != 1:
                raise RuntimeError(f'cannot locate BN for conv {mod}')
            bn = bns[cands[0]]
        params.setdefault(blk, {})[name] = dict(
            w=w, beta=bn.get('bias', np.zeros(shape[0], np.float32)),
            mean=bn['running_mean'], var=bn['running_var'])
    if fc is not None:
        params['output'] = dict(
            w=fc['weight'].T,
            b=fc.get('bias', np.zeros(NUM_LOGITS, np.float32)))
    else:
        params['output'] = dict(
            w=np.zeros((NUM_FEATURES, NUM_LOGITS), np.float32),
            b=np.zeros(NUM_LOGITS, np.float32))
    return params


def attest_batch():
    """The fixed attestation input (seeded, so the record is
    reproducible): the JAX package's."""
    return np.random.RandomState(0).randint(
        0, 256, (4, 3, 128, 128)).astype(np.uint8)


def _detector_of(model, device, **kwargs):
    """images (numpy or torch uint8) -> numpy ``model(images, **kwargs)``,
    run on ``device``."""
    def detect(images):
        with torch.no_grad():
            return model(to_device(images, device), **kwargs).cpu().numpy()
    return detect


def torchscript_detector(path, device, **kwargs):
    """The TorchScript pickle itself on ``device``."""
    return _detector_of(torch.jit.load(path, map_location=device).eval(),
                        device, **kwargs)


def attest_parity(path, model, device):
    """Hold the converted ``model`` to the pickle on the same ``device``
    (JAX :326-394): both run the fixed attestation batch, and the record
    (input hash, max-abs feature delta, device type) is returned. A delta
    above ``PARITY_TOL`` raises. A passing record is kept in a sidecar
    JSON next to the pickle (``<path>.torch_parity.json``, keyed by the
    pickle's size and mtime and the device type), so that later runs skip
    the pickle's forward."""
    device = torch.device(device)
    st = os.stat(path)
    sig = f'{st.st_size}:{int(st.st_mtime)}'
    side_path = path + '.torch_parity.json'
    if os.path.exists(side_path):
        try:
            with open(side_path) as f:
                rec = json.load(f)
            if rec.get('pickle_sig') == sig and \
                    rec.get('device') == device.type and \
                    rec.get('max_abs_feature_delta', np.inf) <= rec.get(
                        'tol', PARITY_TOL):
                return rec
        except (OSError, ValueError):
            pass
    imgs = attest_batch()
    ref = torchscript_detector(path, device, return_features=True)(imgs)
    with torch.no_grad():
        got = model(torch.from_numpy(imgs).to(device),
                    return_features=True).cpu().numpy()
    delta = float(np.abs(got - ref).max())
    rec = {'pickle_sig': sig,
           'input_sha256': hashlib.sha256(imgs.tobytes()).hexdigest()[:16],
           'max_abs_feature_delta': delta, 'tol': PARITY_TOL,
           'device': device.type}
    if delta > PARITY_TOL:
        raise RuntimeError(
            f'converted Inception FAILED parity attestation: max-abs '
            f'feature delta {delta:.4g} > tol {PARITY_TOL:g} on '
            f'{device.type}; refusing the converted detector (set '
            f'NEXT3D_DETECTOR_IMPL=torch to run the pickle itself, or fix '
            f'the converter)')
    try:
        with open(side_path, 'w') as f:
            json.dump(rec, f)
    except OSError:
        pass  # a read-only cache dir: attest again next process
    return rec


@functools.lru_cache(maxsize=2)
def converted_inception(path, device):
    """The pickle at ``path`` converted and attested on ``device`` (a
    string), once a process."""
    model = inception_of_params(convert_torchscript_inception(path), device)
    attest_parity(path, model, device)
    return model


def make_detector(path, device, **kwargs):
    """detect(uint8 images) -> numpy ``model(images, **kwargs)`` of the
    converted, attested pickle on ``device``: the (N, 2048) features with
    ``return_features=True``, the Inception-score probabilities (the
    softmax over the 1008 logits without the output bias, reference
    inception_score.py:23) with ``no_output_bias=True``."""
    device = str(torch.device(device))
    return _detector_of(converted_inception(path, device), device, **kwargs)
