"""The FIR resampling kernel (``csrc/upfirdn2d.cu``) and its autograd
function (``ops/upfirdn2d.py``).

On the CPU: the function's backward (the same function on transposed
parameters) against numerical and plain-autograd gradients in float64,
to the second order; the kernel's tiling (``tile_model``, the kernel's
index arithmetic written in torch) against the plain version; CPU tensors
on the plain route. On the card (``cuda``): the kernel against the plain
version at every FIR call the benchmark's models make, at every call of
StyleGAN3-T and -R, ADA's augment pipe and the equivariance metrics, and
at the CPU cases, in both layouts and both dtypes, forward, backward and
double backward; one launch a call and no library depthwise convolution
left in a synthesis; inputs it does not take raise.

No JAX is imported, so the card's machine runs this file with
``python -m pytest --noconftest -p no:cacheprovider
tests/test_torch_upfirdn2d.py -q``.
"""

import contextlib
import importlib
import json
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from next3d_tpu_torch.ops.upfirdn2d import (
    _plain, instance, is_channels_last, plain_layout,
    resample, resampling, setup_filter, transposed, upfirdn2d,
    upfirdn2d_cuda, upfirdn2d_plain)

U = importlib.import_module('next3d_tpu_torch.ops.upfirdn2d')
ROOT = Path(__file__).resolve().parent.parent

# (up, down, padding, flip_filter, gain, taps, separable): up 1/2/4, down
# 1/2, negative padding, flip, gain, 1-D and 2-D filters, and the calls of
# the models (4x4 at up 2, pad 2/1; up 1, pad 1 or 2; down 2, pad 1)
CASES = [
    (1, 1, 1, False, 4.0, [1, 3, 3, 1], False),
    (1, 1, 2, False, 1.0, [1, 3, 3, 1], False),
    (2, 1, [2, 1, 2, 1], False, 4.0, [1, 3, 3, 1], False),
    (1, 2, 1, False, 1.0, [1, 3, 3, 1], False),
    (4, 1, [3, 2, 1, 3], False, 16.0, [1, 3, 3, 1], False),
    (1, 2, [-1, 2, 0, -1], True, 1.0, [1, 2, 3, 2, 1], False),
    (2, 2, [1, -1, 2, 0], True, 2.5, [1, 3, 3, 1], True),
    ((2, 1), (1, 2), [2, 1, 0, 1], False, 3.0, [1, 4, 6, 4, 1], False),
    (2, 1, [5, 4, 5, 4], False, 4.0, [1, 3, 3, 1] * 3, True),
    (1, 2, [-2, -1, 1, 0], True, 1.0, [2, 1, 5, 1, 3, 1, 2, 1], True),
    (4, 2, 2, False, 1.0, [1, 3, 3, 1], True),
    (1, 1, 0, False, 2.0, None, False),
]
IDS = [f'case{k}' for k in range(len(CASES))]


def _call(case, dtype=torch.float64):
    up, down, padding, flip, gain, taps, separable = case
    f = torch.ones(1, 1) if taps is None else torch.from_numpy(
        setup_filter(taps, separable=separable))
    return f.to(dtype), resampling(up, down, padding, flip, gain)


@pytest.mark.parametrize('case', CASES, ids=IDS)
def test_backward_is_the_transposed_call(case):
    """gradcheck and gradgradcheck of the function run with the plain
    forward: its backward, the same function on ``transposed``
    parameters, is the plain forward's gradient to the second order."""
    f, p = _call(case)
    g = torch.Generator().manual_seed(0)
    x = torch.randn(1, 2, 9, 12, dtype=torch.float64, generator=g,
                    requires_grad=True)

    def fn(x):
        return resample(x, f, p, _plain)

    assert torch.autograd.gradcheck(fn, (x,))
    assert torch.autograd.gradgradcheck(fn, (x,))
    # and it equals autograd through the plain forward itself
    y = fn(x)
    dy = torch.randn(y.shape, dtype=torch.float64, generator=g)
    got, = torch.autograd.grad(y, x, dy)
    want, = torch.autograd.grad(_plain(x, f, p), x, dy)
    torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)
    # transposing twice gives the call back (a trailing pad may differ
    # where down > 1 drops the outputs it reaches)
    q = transposed(p, f, x.shape[2:], y.shape[2:])
    assert torch.equal(_plain(x, f, transposed(q, f, y.shape[2:],
                                                x.shape[2:])), y)


def tile_model(x, f, p, tile_oh, tile_ow):
    """The kernel's arithmetic in torch (``csrc/upfirdn2d.cu``): for each
    output tile, the input tile from its first row and column (r0, c0) and
    of the kernel's size (``geometry``), filled with zeros outside the
    image; then each output's phase (first input row and tap) and its taps
    from the tile. The indices must stay inside the tile."""
    if f.ndim == 1:
        x = tile_model(x, f[None], p._replace(
            upy=1, downy=1, pady0=0, pady1=0, gain=1.0), tile_oh, tile_ow)
        return tile_model(x, f[:, None], p._replace(
            upx=1, downx=1, padx0=0, padx1=0), tile_oh, tile_ow)
    fh, fw = f.shape
    N, C, H, W = x.shape
    oh = (H * p.upy + p.pady0 + p.pady1 - fh) // p.downy + 1
    ow = (W * p.upx + p.padx0 + p.padx1 - fw) // p.downx + 1
    g = f if p.flip_filter else f.flip([0, 1])
    g = g * p.gain
    in_tw = ((tile_ow - 1) * p.downx + fw - 1) // p.upx + 1
    in_th = ((tile_oh - 1) * p.downy + fh - 1) // p.upy + 1

    def phase(o, down, pad, up):
        e = o * down - pad
        r = -(-e // up)      # the first input index at or after e / up
        return r, r * up - e

    out = torch.full((N, C, oh, ow), float('nan'), dtype=x.dtype)
    for oy0 in range(0, oh, tile_oh):
        for ox0 in range(0, ow, tile_ow):
            r0 = phase(oy0, p.downy, p.pady0, p.upy)[0]
            c0 = phase(ox0, p.downx, p.padx0, p.upx)[0]
            tile = torch.zeros(N, C, in_th, in_tw, dtype=x.dtype)
            rs = slice(max(r0, 0), min(r0 + in_th, H))
            cs = slice(max(c0, 0), min(c0 + in_tw, W))
            if rs.start < rs.stop and cs.start < cs.stop:
                tile[:, :, rs.start - r0: rs.stop - r0,
                     cs.start - c0: cs.stop - c0] = x[:, :, rs, cs]
            for oy in range(oy0, min(oy0 + tile_oh, oh)):
                ry, iy = phase(oy, p.downy, p.pady0, p.upy)
                for ox in range(ox0, min(ox0 + tile_ow, ow)):
                    rx, jx = phase(ox, p.downx, p.padx0, p.upx)
                    acc = torch.zeros(N, C, dtype=x.dtype)
                    for ki, i in enumerate(range(iy, fh, p.upy)):
                        for kj, j in enumerate(range(jx, fw, p.upx)):
                            r, c = ry - r0 + ki, rx - c0 + kj
                            assert 0 <= r < in_th and 0 <= c < in_tw
                            acc += tile[:, :, r, c] * g[i, j]
                    out[:, :, oy, ox] = acc
    return out


# the fixed instances' output tiles (rows, columns), and instance 0's in
# NHWC order (``any_model`` follows its NCHW kernel): NCHW (64, 32) at up 1
# and up 2, (32, 32) at down 2, (16, 32) for an output shorter than those;
# NHWC (16, 16) at up 1 and up 2, (8, 8) at down 2, (4, 8) in instance 0;
# and small ones that put tile edges inside the image
TILES = [(64, 32), (32, 32), (16, 32), (16, 16), (8, 8), (4, 8), (3, 2),
         (2, 5), (4, 4)]


@pytest.mark.parametrize('case', CASES, ids=IDS)
def test_tiling_matches_plain(case):
    f, p = _call(case)
    x = torch.randn(1, 2, 9, 11, dtype=torch.float64,
                    generator=torch.Generator().manual_seed(1))
    want = _plain(x, f, p)
    for tile in TILES:
        got = tile_model(x, f, p, *tile)
        assert not got.isnan().any()
        # the plain version scales its taps in float32
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


# ---------------------------------------------- instance 0, NCHW: any_model

# the constants of ``csrc/upfirdn2d.cu any_nchw``: taps a segment, outputs a
# thread along y (y pass, 2-D pass) and x, warps a block, the shared memory
# a tile aims at (separable, 2-D) and the most a block has
KTAPS, KROWS, KROWS2, KCOLS, KWARPS = 6, 8, 4, 3, 8
TARGET_SEP, TARGET_2D, MOST = 56 * 1024, 75 * 1024, 227 * 1024 - 64


def _axis_phase(ax, ph):
    """(first input, its tap, taps) of phase ``ph``."""
    e = ph * ax['down'] - ax['pad']
    first = -(-e // ax['up'])
    tap = first * ax['up'] - e
    n = -(-(ax['taps'] - tap) // ax['up']) if tap < ax['taps'] else 0
    return first, tap, n


def _axis(up, down, pad, taps, out, per, groups):
    """``axis_geometry``: an axis's phases, segments, planes and tiles."""
    g = math.gcd(up, down)
    ax = dict(up=up, down=down, pad=pad, taps=taps, phases=up // g,
              step=down // g)
    ax['first'] = min(_axis_phase(ax, ph)[0] for ph in range(ax['phases']))
    most, reach = 1, 0
    for ph in range(ax['phases']):
        first, _, n = _axis_phase(ax, ph)
        d = first - ax['first']
        for b in range(ax['step']):
            k = (b - d) % ax['step']
            nb = -(-(n - k) // ax['step']) if n > k else 0
            most = max(most, -(-nb // KTAPS))
            reach = max(reach, (d + k - b) // ax['step'])
    span = per * groups
    ax.update(per_plane=most, segs=ax['step'] * most, groups=groups,
              span=span, tile=ax['phases'] * span,
              plane=reach + (most - 1) * KTAPS + span + KTAPS - 1,
              tiles=-(-out // (ax['phases'] * span)))
    return ax


def _segment(ax, ph, j):
    """``segment``: (plane, offset in the plane, first tap, tap stride) of
    segment ``j`` of phase ``ph``."""
    first, tap, _ = _axis_phase(ax, ph)
    plane, q = divmod(j, ax['per_plane'])
    d = first - ax['first']
    k = (plane - d) % ax['step']
    assert (d + k - plane) % ax['step'] == 0 and d + k - plane >= 0
    return (plane, (d + k - plane) // ax['step'] + q * KTAPS,
            tap + ax['up'] * (k + q * KTAPS * ax['step']),
            ax['up'] * ax['step'])


def any_geometry(p, fh, fw, oh, ow, separable, elem=4, groups=None):
    """``any_nchw::launch``: both axes and the block's shared memory (taps,
    segment table, the x pass's map, the fetched tile of ``elem``-byte
    elements in rows of 16-byte words, one word more than its columns
    need); the row jobs, then the lanes, halved while it takes more than
    the target. ``groups`` (lanes, row jobs) fixes them instead. Returns
    the axes, the fetched tile's rows, columns and pitch, and the bytes.
    Raises where the launch refuses: more x phases than a warp's lanes."""
    px = p.upx // math.gcd(p.upx, p.downx)
    py = p.upy // math.gcd(p.upy, p.downy)
    if px > U.ANY_NCHW_PHASES:
        raise ValueError(f'{px} x phases: more than a warp has lanes')
    gx, gy = groups or (32 // px if px < 32 else 1,
                        KWARPS // py if py < KWARPS else 1)
    rows_a_job = KROWS if separable else KROWS2
    while True:
        ax = _axis(p.upx, p.downx, p.padx0, fw, ow, KCOLS, gx)
        ay = _axis(p.upy, p.downy, p.pady0, fh, oh, rows_a_job, gy)
        nx, ny = ax['phases'] * ax['segs'], ay['phases'] * ay['segs']
        taps = ((nx + ny) * KTAPS + 3) & ~3 if separable \
            else nx * ny * KTAPS * KTAPS
        mid = (ay['plane'] * ax['tile'] + 3) & ~3 if separable else 0
        raw_at = taps + (((nx + ny) * 2 + 3) & ~3) + ay['step'] * mid
        rows, cols = ay['step'] * ay['plane'], ax['step'] * ax['plane']
        vec = 16 // elem
        pitch = vec * (-(-cols // vec) + 1)
        size = 4 * raw_at + elem * pitch * rows
        target = TARGET_SEP if separable else TARGET_2D
        if groups or size <= target or (gx == 1 and gy == 1):
            break
        if gy > 1:
            gy //= 2
        else:
            gx //= 2
    assert size <= MOST, size
    return ax, ay, (rows, cols, pitch), size


def _correlation(f, p, separable):
    """The correlation taps as the kernel arranges them: g(i, j) of a 2-D
    filter, or (gx(j), gy(i)) of a 1-D one with the gain on y's."""
    if separable:
        g = f if p.flip_filter else f.flip(0)
        return g, g * p.gain
    return (f if p.flip_filter else f.flip([0, 1])) * p.gain


def any_model(x, f, p, groups=None, elem=4):
    """Instance 0's NCHW kernel (``csrc/upfirdn2d.cu any_nchw``) in torch:
    per output tile, the fetched input tile (zeros outside the image; a
    row may start up to a 16-byte word before its first column), then each
    thread's block of outputs of one phase from its segments, segment
    (plane b, offset o) reading the tile at (o + i) * s + b along its axis;
    a 2-D filter in one pass, a 1-D one through the x pass's map ``mid``
    (s planes by row mod s) and the y pass. Every index must stay inside
    the tile and the map, every output be written once."""
    separable = f.ndim == 1
    fh, fw = (f.shape[0],) * 2 if separable else f.shape
    N, C, H, W = x.shape
    oh = (H * p.upy + p.pady0 + p.pady1 - fh) // p.downy + 1
    ow = (W * p.upx + p.padx0 + p.padx1 - fw) // p.downx + 1
    ax, ay, (rows, cols, pitch), _ = any_geometry(p, fh, fw, oh, ow,
                                                  separable, elem, groups)
    g = _correlation(f, p, separable)
    sx, sy = ax['step'], ay['step']
    shift = 16 // elem - 1    # the most elements a row starts early
    out = torch.full((N, C, oh, ow), float('nan'), dtype=x.dtype)
    written = torch.zeros(oh, ow, dtype=torch.int64)

    def taps(axis, ph, j):
        """Segment ``j``'s taps of phase ``ph``: their indices (clamped)
        and which of them land on the filter."""
        _, _, tap, stride = _segment(axis, ph, j)
        k = torch.arange(KTAPS) * stride + tap
        return k.clamp(max=axis['taps'] - 1), k < axis['taps']

    def reads(axis, ph, j, first, count, length):
        """The tile indices that ``count`` values from a segment's element
        ``first`` on read: (offset + first + i) * s + plane."""
        plane, off, _, _ = _segment(axis, ph, j)
        idx = (off + first + torch.arange(count)) * axis['step'] + plane
        assert int(idx.min()) >= 0 and int(idx.max()) < length
        return idx

    def write(oy0, ox0, out_rows, out_cols, acc):
        """acc (N, C, len(out_rows), len(out_cols)) at the tile's rows and
        columns."""
        r = oy0 + torch.tensor(out_rows)[:, None].expand(-1, len(out_cols))
        c = ox0 + torch.tensor(out_cols)[None].expand(len(out_rows), -1)
        kept = (r < oh) & (c < ow)
        r, c = r[kept], c[kept]
        assert bool((written[r, c] == 0).all())
        written.index_put_((r, c), torch.ones_like(r), accumulate=True)
        out[:, :, r, c] = acc[:, :, kept]

    lanes = [(lane % ax['phases'], lane // ax['phases'])
             for lane in range(min(32, ax['phases'] * ax['groups']))]
    row_jobs = [(yj % ay['phases'], yj // ay['phases'])
                for yj in range(ay['phases'] * ay['groups'])]
    assert cols + shift <= pitch
    for by in range(ay['tiles']):
        for bx in range(ax['tiles']):
            oy0, ox0 = by * ay['tile'], bx * ax['tile']
            r0 = ay['first'] + by * ay['span'] * sy
            c0 = ax['first'] + bx * ax['span'] * sx
            tile = torch.zeros(N, C, rows, cols, dtype=x.dtype)
            rs = slice(max(r0, 0), min(r0 + rows, H))
            cs = slice(max(c0, 0), min(c0 + cols, W))
            if rs.start < rs.stop and cs.start < cs.stop:
                tile[:, :, rs.start - r0: rs.stop - r0,
                     cs.start - c0: cs.stop - c0] = x[:, :, rs, cs]
            if separable:
                mid = torch.full((N, C, sy, ay['plane'], ax['tile']),
                                 float('nan'), dtype=x.dtype)
                for phx, gx in lanes:
                    cols_out = [(gx * KCOLS + m) * ax['phases'] + phx
                                for m in range(KCOLS)]
                    assert max(cols_out) < ax['tile']
                    acc = 0
                    for j in range(ax['segs']):
                        c = reads(ax, phx, j, gx * KCOLS,
                                  KCOLS + KTAPS - 1, cols)
                        k, real = taps(ax, phx, j)
                        h = torch.where(real, g[0][k], 0.0)
                        # (N, C, rows, KCOLS, KTAPS) windows
                        acc = acc + tile[:, :, :, c].unfold(3, KTAPS, 1) @ h
                    for r in range(rows):
                        assert r // sy < ay['plane']
                        mid[:, :, r % sy, r // sy, cols_out] = acc[:, :, r]
                for phy, gy in row_jobs:
                    acc = 0
                    for j in range(ay['segs']):
                        r = reads(ay, phy, j, gy * KROWS, KROWS + KTAPS - 1,
                                  rows)
                        # mid holds row r of the tile at (r % s, r // s)
                        src = mid[:, :, r % sy, r // sy]
                        k, real = taps(ay, phy, j)
                        h = torch.where(real, g[1][k], 0.0)
                        acc = acc + src.unfold(2, KTAPS, 1) @ h
                    assert not acc.isnan().any()
                    write(oy0, ox0, [(gy * KROWS + k) * ay['phases'] + phy
                                     for k in range(KROWS)],
                          list(range(ax['tile'])), acc)
            else:
                for phy, gy in row_jobs:
                    for phx, gx in lanes:
                        acc = 0
                        for jy in range(ay['segs']):
                            r = reads(ay, phy, jy, gy * KROWS2,
                                      KROWS2 + KTAPS - 1, rows)
                            ki, ri = taps(ay, phy, jy)
                            for jx in range(ax['segs']):
                                c = reads(ax, phx, jx, gx * KCOLS,
                                          KCOLS + KTAPS - 1, cols)
                                kj, rj = taps(ax, phx, jx)
                                block = torch.where(ri[:, None] & rj[None],
                                                    g[ki][:, kj], 0.0)
                                win = tile[:, :, r][:, :, :, c].unfold(
                                    2, KTAPS, 1).unfold(3, KTAPS, 1)
                                acc = acc + torch.einsum('nckmij,ij->nckm',
                                                         win, block)
                        write(oy0, ox0,
                              [(gy * KROWS2 + k) * ay['phases'] + phy
                               for k in range(KROWS2)],
                              [(gx * KCOLS + m) * ax['phases'] + phx
                               for m in range(KCOLS)], acc)
    assert bool((written == 1).all())
    return out


@pytest.mark.parametrize('case', CASES, ids=IDS)
def test_any_model_matches_plain(case):
    """Instance 0's NCHW arithmetic at the cases, with the kernel's tiles
    for float32 and bf16 (rows of 4 or 8 elements a 16-byte word), and
    with one lane and one row job a phase (tile edges inside the image)."""
    f, p = _call(case)
    x = torch.randn(1, 2, 9, 11, dtype=torch.float64,
                    generator=torch.Generator().manual_seed(1))
    want = _plain(x, f, p)
    for groups, elem in ((None, 4), (None, 2), ((1, 1), 4), ((2, 1), 4)):
        got = any_model(x, f, p, groups, elem)
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


# StyleGAN3-R's distinct FIR calls at its FFHQ-U 1024² configuration, by
# (layer index, filter): the filters, up, down and padding follow the
# layers' sampling rates, not their widths
SG3R_CALLS = [(0, 'up'), (0, 'down'), (2, 'up'), (12, 'down'), (13, 'up'),
              (14, 'up')]


@pytest.fixture(scope='module')
def sg3r_synthesis():
    """The benchmark's reference SG3-R synthesis, narrowed to 4 channels."""
    import sys
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    from benchmark import harness
    from benchmark.reference.nn import stylegan3 as ref_sg3
    kw = dict(harness.config('sg3r_ffhqu1024')['G_kwargs'])
    for key in ('mapping_kwargs', 'z_dim', 'c_dim', 'rendering_kwargs'):
        kw.pop(key)
    kw.update(channel_base=512, channel_max=4)
    return ref_sg3.SynthesisNetwork(**kw)


def _sg3r_call(synthesis, index, which):
    """(filter in float64, parameters, input shape) of a layer's call."""
    layer = getattr(synthesis, synthesis.layer_names[index])
    if which == 'up':
        f, p = layer.up_filter, resampling(
            layer.up_factor, 1, layer.padding, False, layer.up_factor ** 2)
        shape = (1, 2, 18, 21)
    else:
        f, p = layer.down_filter, resampling(1, layer.down_factor)
        shape = (1, 2, 37, 40)
    f = torch.ones(1, 1) if f is None else f
    return f.double(), p, shape


def test_sg3r_calls_are_the_listed_ones(sg3r_synthesis):
    """SG3R_CALLS holds one of each distinct call of the 15 layers."""
    def key(f, p):
        return tuple(f.shape), p
    every = {key(*_sg3r_call(sg3r_synthesis, i, w)[:2])
             for i in range(len(sg3r_synthesis.layer_names))
             for w in ('up', 'down')}
    listed = [key(*_sg3r_call(sg3r_synthesis, i, w)[:2])
              for i, w in SG3R_CALLS]
    assert len(set(listed)) == len(listed) and set(listed) == every


@pytest.mark.parametrize('transpose', (False, True),
                         ids=('forward', 'transposed'))
@pytest.mark.parametrize('call', SG3R_CALLS,
                         ids=[f'L{i}-{w}' for i, w in SG3R_CALLS])
def test_any_model_at_sg3r_calls(sg3r_synthesis, call, transpose):
    """Each distinct SG3-R call and its transposed call (its backward):
    the separable route through the x pass's map at up 2 and up 4 (and
    down 2 and 4, transposed), the 12x12 radial filter split in 2 x 2
    planes, the 1x1 ToRGB pass."""
    f, p, shape = _sg3r_call(sg3r_synthesis, *call)
    g = torch.Generator().manual_seed(2)
    x = torch.randn(shape, dtype=torch.float64, generator=g)
    if transpose:
        y = _plain(x, f, p)
        p = transposed(p, f, x.shape[2:], y.shape[2:])
        x = torch.randn(y.shape, dtype=torch.float64, generator=g)
    want = _plain(x, f, p)
    for groups in (None, (1, 1)):
        got = any_model(x, f, p, groups)
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize('transpose', (False, True),
                         ids=('forward', 'transposed'))
@pytest.mark.parametrize('which', ('up', 'down'))
def test_any_model_at_ada_calls(which, transpose):
    """ADA's geometric pipe: the 12-tap wavelet at up 2, and flipped at
    down 2, and their transposed calls."""
    from next3d_tpu_torch.cli.train import PIPE_KWARGS
    from next3d_tpu_torch.train.augment import AugmentPipe
    f = torch.from_numpy(AugmentPipe(**PIPE_KWARGS).Hz_geom).double()
    fw = f.shape[0]
    if which == 'up':
        p = resampling(2, 1, [(fw + 1) // 2, (fw - 2) // 2] * 2, False, 4)
    else:
        p = resampling(1, 2, [(fw - 1) // 2, (fw - 2) // 2] * 2, True)
    g = torch.Generator().manual_seed(3)
    x = torch.randn(1, 2, 19, 22, dtype=torch.float64, generator=g)
    if transpose:
        y = _plain(x, f, p)
        p = transposed(p, f, x.shape[2:], y.shape[2:])
        x = torch.randn(y.shape, dtype=torch.float64, generator=g)
    want = _plain(x, f, p)
    for groups in (None, (1, 1)):
        got = any_model(x, f, p, groups)
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


# (up, filter taps, separable): 32 x phases, the most a warp's lanes hold,
# and 33 y phases, more row jobs than a block's warps
MOST_PHASES = [((32, 33), [1, 2, 3, 4, 3, 2, 1, 1], True),
               ((32, 33), [1, 3, 3, 1], False)]


@pytest.mark.parametrize('up, taps, separable', MOST_PHASES,
                         ids=('1-D', '2-D'))
def test_any_model_at_the_most_x_phases(up, taps, separable):
    """Instance 0's NCHW arithmetic at 32 x phases and 33 y phases; at 33
    x phases ``any_geometry`` refuses, as ``any_nchw::launch`` does."""
    f = torch.from_numpy(setup_filter(taps, separable=separable)).double()
    p = resampling(up, 1, [3, 2, 5, 1], False, 2.0)
    x = torch.randn(1, 2, 5, 4, dtype=torch.float64,
                    generator=torch.Generator().manual_seed(4))
    torch.testing.assert_close(any_model(x, f, p), _plain(x, f, p),
                               rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match='33 x phases'):
        any_model(x, f, resampling((33, 2), 1, 1))


@pytest.mark.parametrize('separable', (True, False), ids=('1-D', '2-D'))
def test_past_32_x_phases_the_nchw_call_takes_the_nhwc_route(
        monkeypatch, separable):
    """At 33 x phases the wrapper runs an NCHW call's planes as one-channel
    NHWC images (the launch refuses the NCHW kernel there); at 32 the call
    stays on the NCHW kernel. Each pass is the plain version here, so the
    result must be the whole call's."""
    seen = []

    def plain_pass(x, f, fh, fw, fsx, fsy, p, channels_last,
                   separable=False):
        seen.append((tuple(x.shape), channels_last, separable))
        if separable:
            g = f
        else:
            g = f.flatten()[torch.arange(fh)[:, None] * fsy
                            + torch.arange(fw)[None] * fsx]
        y = _plain(x, g, p)
        return y.contiguous(memory_format=torch.channels_last
                            if channels_last else torch.contiguous_format)

    monkeypatch.setattr(U, '_pass', plain_pass)
    f = torch.from_numpy(setup_filter([1, 3, 2, 1], separable=separable))
    x = torch.randn(2, 3, 5, 4, generator=torch.Generator().manual_seed(5))
    for upx, planes in ((33, (6, 1)), (32, (2, 3))):
        seen.clear()
        p = resampling((upx, 2), 1, [3, 2, 1, 1], False, 2.0)
        got = upfirdn2d_cuda(x, f, p, False)
        want = _plain(x, f, p)
        assert got.shape == want.shape and got.is_contiguous()
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
        nhwc = upx == 33
        assert [s[0][:2] for s in seen] == [planes] * (
            2 if separable and nhwc else 1)
        assert all(s[1] == nhwc and s[2] == (separable and not nhwc)
                   for s in seen), seen


def test_the_models_calls_take_the_fixed_instances():
    f = setup_filter([1, 3, 3, 1])
    assert f.shape == (4, 4)
    for kw, name in ((dict(padding=1, gain=4), 'up1'),
                     (dict(padding=2), 'up1'),
                     (dict(up=2, padding=[2, 1, 2, 1], gain=4), 'up2'),
                     (dict(down=2, padding=1), 'down2'),
                     (dict(up=2, down=2, padding=1), 'any'),
                     (dict(up=(2, 1), padding=1), 'any')):
        assert instance(4, 4, resampling(**kw))[1] == name
    assert instance(1, 12, resampling(up=2))[1] == 'any'


def test_cpu_tensors_take_the_plain_route(monkeypatch):
    """On the CPU the wrapper is the plain version, bit for bit, and
    neither launches nor reaches the kernel's function."""
    def refuse(*args, **kwargs):
        raise AssertionError('the kernel route was taken on the CPU')
    monkeypatch.setattr(U, 'upfirdn2d_cuda', refuse)
    monkeypatch.setattr(U, 'resample', refuse)
    before = (upfirdn2d.launches, dict(upfirdn2d.launches_by_instance))
    f = torch.from_numpy(setup_filter([1, 3, 3, 1]))
    x = torch.randn(2, 3, 8, 8, requires_grad=True)
    for kw in (dict(up=2, padding=[2, 1, 2, 1], gain=4), dict(down=2,
               padding=1), dict(padding=1, flip_filter=True)):
        got = upfirdn2d(x, f, **kw)
        assert torch.equal(got, upfirdn2d_plain(x, f, **kw))
        got.sum().backward()
    assert (upfirdn2d.launches, upfirdn2d.launches_by_instance) == before


# ------------------------------------------------------------------ card

def _device():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    return torch.device('cuda', 0)


def _config(name):
    with open(ROOT / 'benchmark' / 'configs' / f'{name}.json') as fh:
        return json.load(fh)


def _generator(name, device, force_fp32=True):
    """One of the benchmark's generators at its full configuration on the
    synthetic head, and a batch of 2 of its inputs."""
    from next3d_tpu_torch.render.camera_utils import (fov_to_intrinsics,
                                                      lookat_pose)
    from next3d_tpu_torch.utils.synthetic_head import synthetic_head
    cfg = _config(name)
    module, _, cls = cfg['program_class']['G_kwargs'].partition(':')
    mesh, lms = synthetic_head()
    G = getattr(importlib.import_module(module), cls)(
        **cfg['G_kwargs'], topology_path=mesh, force_fp32=force_fp32,
        generator=torch.Generator().manual_seed(0))
    G = G.to(device).eval().requires_grad_(False)
    n = 2
    cam = lookat_pose(math.pi / 2, math.pi / 2, [0, 0, 0.2], radius=2.7,
                      batch_size=n, device=device)
    K = torch.from_numpy(fov_to_intrinsics(18.837)).to(device)
    c = torch.cat([cam.reshape(n, 16), K.reshape(1, 9).expand(n, 9)], 1)
    v = torch.from_numpy(np.concatenate([mesh.verts, lms]).astype(
        np.float32))[None].expand(n, -1, -1).to(device)
    if 'texture' in name:
        v = v[:, :5023]
    z = torch.randn(n, 512, device=device,
                    generator=torch.Generator(device).manual_seed(0))
    return G, (z, c, v)


def _synthesize(G, inputs):
    z, c, v = inputs
    ws = G.mapping(z, c, truncation_psi=0.7, truncation_cutoff=14)
    return G.synthesis(ws, c, v, noise_mode='const')


MODELS = ('next3d_ffhq512', 'next3d_texture_ffhq512')


@contextlib.contextmanager
def _recording(seen):
    """Record each distinct kernel call into ``seen`` ({signature: (x, f,
    p)}, the input cut to a batch of 2) while the calls run on."""
    original = U.upfirdn2d_cuda

    def record(x, f, p, channels_last):
        key = (tuple(x.shape[1:]), x.dtype, is_channels_last(x),
               tuple(f.shape), p)
        seen.setdefault(key, (x[:2].detach().clone(
            memory_format=torch.preserve_format), f, p))
        return original(x, f, p, channels_last)

    U.upfirdn2d_cuda = record
    try:
        yield seen
    finally:
        U.upfirdn2d_cuda = original


@pytest.fixture(scope='module')
def model_calls():
    """Every distinct FIR call of the benchmark's models on the card: a
    synthesis of each generator, fp32 and bf16, and D's forward at its
    full configuration."""
    device = _device()
    from next3d_tpu_torch.nn.discriminator import DualDiscriminator
    seen = {}
    with _recording(seen), torch.no_grad():
        for name in MODELS:
            for fp32 in (True, False):
                G, inputs = _generator(name, device, fp32)
                out = _synthesize(G, inputs)
                del G
        D = DualDiscriminator(**_config(MODELS[0])['D_kwargs']).to(device)
        D({'image': out['image'].float(),
           'image_raw': out['image_raw'].float()}, inputs[1])
        del D
    torch.cuda.empty_cache()
    return seen


@pytest.fixture(scope='module')
def other_calls():
    """Every distinct FIR call of the other paths on the card: StyleGAN3-T
    and -R synthesis at 256^2 (``filtered_lrelu``'s 1-D filters, and -R's
    radial 2-D ones; narrow channels, since the filters and strides follow
    the resolution and the layers, not the width), fp32 and bf16; ADA's
    augment pipe at the train command's settings with every op drawn (the
    12-tap wavelet up and down); the equivariance metrics' translation
    and rotations."""
    device = _device()
    from next3d_tpu_torch.cli.train import PIPE_KWARGS
    from next3d_tpu_torch.metrics import equivariance as eq
    from next3d_tpu_torch.nn.stylegan3 import SG3Generator
    from next3d_tpu_torch.train.augment import AugmentPipe
    seen = {}
    g = torch.Generator(device=device).manual_seed(0)
    with _recording(seen), torch.no_grad():
        for kw in (dict(), dict(conv_kernel=1, use_radial_filters=True)):
            S = SG3Generator(z_dim=64, c_dim=0, w_dim=64, img_resolution=256,
                             img_channels=3, channel_base=1024,
                             channel_max=16, **kw,
                             generator=torch.Generator().manual_seed(0))
            S = S.to(device).eval()
            z = torch.randn(2, 64, generator=g, device=device)
            for fp32 in (True, False):
                S(z, force_fp32=fp32)
            del S
        pipe = AugmentPipe(**PIPE_KWARGS)
        x = torch.randn(2, 6, 64, 64, generator=g, device=device)
        draws = pipe.draw(x.shape, 1.0, torch.Generator().manual_seed(0),
                          'cpu')
        pipe.apply(x, {k: v.to(device) for k, v in draws.items()})
        img = torch.randn(2, 3, 64, 64, generator=g, device=device)
        eq.apply_fractional_translation(img, 0.13, -0.07)
        eq.apply_fractional_rotation(img, 0.3)
        eq.apply_fractional_pseudo_rotation(img, 0.3)
    torch.cuda.empty_cache()
    return seen


def _scale(t):
    return float(t.detach().abs().max()) or 1.0


def _gap(got, want):
    return float((got.detach().double() - want.detach()).abs().max()) \
        / _scale(want)


# float32: the kernel and the plain version sum at most fh * fw products in
# float32 in different orders, each sum within a few 2^-24 of the largest
# output; bf16: one rounding of the output to bf16 (2^-8 relative) on top
# of that, against the plain version on the same bf16 values in float64
TOLERANCE = {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -8 + 1e-5}


def _tolerance(dtype, u, f, q):
    """The gap ``_check`` allows the kernel's call ``q`` on ``u`` (float64)
    against the plain version in float64: TOLERANCE, and in bf16 with a
    1-D filter also the rounding of the x pass's output to bf16 (the
    kernel writes it in the input's dtype, as the plain route's first
    convolution does), carried through the y pass: 2^-8 of the largest
    intermediate times the y taps' L1 norm, as a share of the largest
    output."""
    tol = TOLERANCE[dtype]
    if dtype == torch.bfloat16 and f.ndim == 1:
        f = f.double()
        mid = _plain(u, f[None], q._replace(
            upy=1, downy=1, pady0=0, pady1=0, gain=1.0))
        out = _plain(mid, f[:, None], q._replace(
            upx=1, downx=1, padx0=0, padx1=0))
        tol += 2.0 ** -8 * float(f.abs().sum()) * q.gain * _scale(mid) \
            / _scale(out)
    return tol


def _check(shape, f, p, g, key):
    """The kernel against the plain version in float64 on an input of
    ``shape``, in both layouts and both dtypes: forward, backward and
    double backward (each the call on the transposed parameters of the
    one before), and the plain route's layout for the output and the
    gradient."""
    for dtype in TOLERANCE:
        for channels_last in (False, True):
            xs = torch.randn(shape, generator=g, device='cuda')
            xs = xs.to(dtype).contiguous(
                memory_format=torch.channels_last if channels_last
                else torch.contiguous_format)
            xs.requires_grad_(True)
            x64 = xs.detach().double().requires_grad_(True)
            got = resample(xs, f, p, upfirdn2d_cuda)
            want = resample(x64, f.double(), p, _plain)
            # the plain route's layout: the input's at up 1, else NCHW
            assert is_channels_last(got) == (
                channels_last and p.upx == p.upy == 1), key
            assert got.dtype == dtype
            where = (key, dtype, channels_last)
            assert _gap(got, want) <= _tolerance(dtype, x64.detach(), f, p), \
                where
            dy = torch.randn(got.shape, generator=g, device='cuda').to(dtype)
            gx, = torch.autograd.grad(got, xs, dy)
            wx, = torch.autograd.grad(want, x64, dy.double())
            assert gx.dtype == dtype
            assert is_channels_last(gx) == plain_layout(xs, p), key
            q = transposed(p, f, xs.shape[2:], got.shape[2:])
            assert _gap(gx, wx) <= _tolerance(dtype, dy.double(), f, q), \
                ('backward',) + where
            v = torch.randn(gx.shape, generator=g, device='cuda').to(dtype)
            gdy = _double_backward(xs, f, p, upfirdn2d_cuda, dy, v)
            wdy = _double_backward(x64, f.double(), p, _plain, dy.double(),
                                   v.double())
            q = transposed(q, f, got.shape[2:], xs.shape[2:])
            assert _gap(gdy, wdy) <= _tolerance(dtype, v.double(), f, q), \
                ('double backward',) + where


def _check_calls(calls):
    """``_check`` once for each input shape, filter shape and parameters
    among ``calls``, whatever dtype and layout each was recorded in."""
    g = torch.Generator(device='cuda').manual_seed(0)
    done = set()
    for key, (x, f, p) in calls.items():
        sig = (tuple(x.shape), tuple(f.shape), p)
        if sig not in done:
            done.add(sig)
            _check(x.shape, f, p, g, key)


@pytest.mark.cuda
def test_kernel_matches_plain_at_the_models_calls(model_calls):
    assert model_calls, 'no FIR call recorded'
    layouts = {key[2] for key in model_calls}
    dtypes = {key[1] for key in model_calls}
    assert layouts == {False, True} and dtypes == set(TOLERANCE), \
        (layouts, dtypes)
    _check_calls(model_calls)


@pytest.mark.cuda
def test_kernel_matches_plain_at_the_other_paths(other_calls):
    """SG3's, ADA's and the equivariance metrics' calls: the ``any``
    instance, 1-D filters as two passes, up 4, negative padding, flips."""
    assert other_calls, 'no FIR call recorded'
    assert {len(key[3]) for key in other_calls} == {1, 2}
    assert any(key[4].upx == 4 for key in other_calls)
    _check_calls(other_calls)


# input shapes for the cases on the card: channels that take and that do
# not take 16-byte vectors, and planes larger than one tile at up 4
CARD_SHAPES = [(2, 3, 13, 17), (1, 16, 37, 41)]


@pytest.mark.cuda
@pytest.mark.parametrize('case', CASES, ids=IDS)
def test_kernel_matches_plain_over_the_cases(case):
    _device()
    f, p = _call(case, torch.float32)
    f = f.cuda().contiguous()
    g = torch.Generator(device='cuda').manual_seed(0)
    for shape in CARD_SHAPES:
        _check(shape, f, p, g, (case, shape))


@pytest.mark.cuda
@pytest.mark.parametrize('separable', (True, False), ids=('1-D', '2-D'))
def test_kernel_matches_plain_past_32_x_phases(separable):
    """33 x phases (the NHWC route on one-channel planes for an NCHW
    input), their transposed call at down 33 and back."""
    _device()
    f = torch.from_numpy(setup_filter([1, 3, 2, 1],
                                      separable=separable)).cuda()
    p = resampling((33, 2), 1, [3, 2, 1, 1], False, 2.0)
    g = torch.Generator(device='cuda').manual_seed(0)
    for shape in CARD_SHAPES:
        _check(shape, f, p, g, ('33 x phases', separable, shape))


def _double_backward(x, f, p, run, dy, v):
    """d<grad_x, v>/d(dy): the backward of the backward."""
    dy = dy.detach().requires_grad_(True)
    y = resample(x, f, p, run)
    gx, = torch.autograd.grad(y, x, dy, create_graph=True)
    out, = torch.autograd.grad(gx, dy, v)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize('name', MODELS)
def test_one_launch_a_call_and_no_library_depthwise(name):
    """A synthesis launches the kernel once per FIR call (every call of
    the models has a 2-D filter) and runs no depthwise convolution of
    ATen or cuDNN."""
    device = _device()
    G, inputs = _generator(name, device)
    calls = []
    original = U.resample

    def counting(*args):
        calls.append(args[2])
        return original(*args)

    U.resample = counting
    try:
        before = upfirdn2d.launches
        with torch.no_grad(), torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            _synthesize(G, inputs)
            torch.cuda.synchronize()
    finally:
        U.resample = original
    assert calls and upfirdn2d.launches - before == len(calls)
    names = {e.name for e in prof.events()}
    assert any('upfirdn2d_' in n for n in names)
    assert not [n for n in names if 'conv_depthwise2d' in n
                or 'grouped_direct' in n]


@pytest.mark.cuda
def test_inputs_the_kernel_does_not_take_raise():
    device = _device()
    f = torch.from_numpy(setup_filter([1, 3, 3, 1])).to(device)
    x = torch.randn(1, 2, 8, 8, device=device)
    for bad in (x.double(), x.half(), x[0]):
        with pytest.raises(ValueError):
            upfirdn2d(bad, f, up=2, padding=1)
    with pytest.raises(ValueError):
        upfirdn2d(x, f.clone().requires_grad_(True), padding=1)
    with pytest.raises(ValueError):
        upfirdn2d(x, f, padding=-4)      # no output
    with pytest.raises(ValueError):
        upfirdn2d(x.to('meta'), f.to('meta'))
