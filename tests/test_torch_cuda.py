"""The port's CUDA kernels against their plain torch versions, and the
small slice on the card against the same slice on the CPU.

These tests need a CUDA device and skip without one. The machine with the
card has no JAX, so this file imports none and the conftest (which does)
is bypassed there:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

Tolerances: K1, K2, K3 and K5 are bit-equal to their plain versions (the
same rounding and an exact cull, see csrc/raster_binned_uv.cu and
csrc/raster_zbuffer.cu), K1-K3 also on the adversarial meshes of
utils/raster_cases.py, where K3 equals K1 and K2's pix_to_face K1's, and K5
also on its slivers and its own case set there; K6 is a copy and exact;
the binned kernels' CUDA prep gives the torch prep's segment starts exactly
and, once each segment is sorted by face id, its slab bit for bit
(csrc/raster_binned_prep.cu), and K5's CUDA prep its face rows and stripe
starts on the kept faces (csrc/raster_zbuffer.cu); K4 within 1e-5 (its
unnormalization rounds in another order than F.grid_sample), its bf16-plane
instance too (it sums in float32, as the plain version on the upcast
planes does), its bf16 backward (the binned kernels) within one bf16 ulp
of the plain float32 gradient's cast, its tile counts equal to the model's,
and K4's
backward within 1e-5 of the largest gradient of its plain version and of
grid_sampler_2d_backward, both adding in float64 (its atomics add in no
fixed order); the slices within the fp32 parity gate of ROADMAP.md (max-abs
2e-3, mean-abs 1e-4), with TF32 off on the card; the Inception-2015
detector (metrics/inception.py) within 1e-4 of its features' scale and
1e-5 on its IS probabilities of the CPU's, converted and attested on the
card.
"""

import json
import math

import numpy as np
import pytest
import torch

from next3d_tpu_torch.models.osg_decoder import OSGDecoder
from next3d_tpu_torch.models.triplane_next3d import TriPlaneGenerator
from next3d_tpu_torch.models.triplane_texture import TriPlaneTextureGenerator
from next3d_tpu_torch.ops.dma_gather import (gather_row_blocks,
                                             gather_row_blocks_plain)
from next3d_tpu_torch.ops.raster import (binned_prep, binned_prep_cuda,
                                         face_corners,
                                         rasterize_binned,
                                         rasterize_binned_plain,
                                         rasterize_binned_uv,
                                         rasterize_binned_uv16,
                                         rasterize_binned_uv16_plain,
                                         rasterize_binned_uv_plain,
                                         segments_in_face_order)
from next3d_tpu_torch.ops.raster_zbuffer import (rasterize_zbuffer,
                                                 rasterize_zbuffer_plain,
                                                 zbuffer_prep,
                                                 zbuffer_prep_cuda)
from next3d_tpu_torch.ops.triplane import (_backward_bf16_cuda, bin_counts,
                                           channels_last, kernel_positions,
                                           triplane_sample,
                                           triplane_sample_backward,
                                           triplane_sample_backward_bf16,
                                           triplane_sample_backward_plain,
                                           triplane_sample_plain)
from next3d_tpu_torch.render.camera_utils import (fov_to_intrinsics,
                                                  lookat_pose)
from next3d_tpu_torch.render.ray_sampler import sample_rays
from next3d_tpu_torch.render.renderer import (ImportanceRenderer,
                                              sample_stratified)
from next3d_tpu_torch.render.shape_utils import create_samples
from next3d_tpu_torch.utils.raster_cases import (adversarial_mesh,
                                                 four_views, sliver_sweep,
                                                 zbuffer_mesh)
from next3d_tpu_torch.utils.synthetic_head import synthetic_head

pytestmark = pytest.mark.cuda


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    return torch.device('cuda', 0)


def _camera(n, device, yaw=0.0):
    cam = lookat_pose(math.pi / 2 + yaw, math.pi / 2, [0, 0, 0.2],
                      radius=2.7, batch_size=n, device=device)
    K = torch.from_numpy(fov_to_intrinsics(18.837)).to(device)
    return torch.cat([cam.reshape(n, 16), K.reshape(1, 9).expand(n, 9)], 1)


def _head(device, seed=4):
    """2 images of the synthetic head in [-1, 1] (the second jittered), the
    generator's face order, random per-corner (u, v)."""
    mesh, _ = synthetic_head()
    rng = np.random.RandomState(seed)
    v = mesh.verts
    v = (v - v.mean(0)) / np.abs(v - v.mean(0)).max() * 0.9
    verts = np.stack([v, v + rng.randn(*v.shape) * 0.002]).astype(np.float32)
    verts = np.concatenate([verts[..., :2], 10.0 - verts[..., 2:] * 2], -1)
    faces = mesh.faces[:, [0, 2, 1]].astype(np.int32)
    attrs = rng.rand(1, len(faces), 3, 2).astype(np.float32) * 2 - 1
    return [torch.from_numpy(a).to(device) for a in (verts, faces, attrs)]


@pytest.mark.parametrize('kernel,plain,with_attrs', [
    (rasterize_binned_uv, rasterize_binned_uv_plain, True),
    (rasterize_binned_uv16, rasterize_binned_uv16_plain, True),
    (rasterize_binned, rasterize_binned_plain, False)],
    ids=['K1', 'K3', 'K2'])
def test_binned_kernel_matches_plain(device, kernel, plain, with_attrs):
    args = _head(device) if with_attrs else _head(device)[:2]
    before = kernel.launches
    got = kernel(*args, 256)
    want = plain(*args, 256)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def _all_dropped(verts, faces, attrs, H):
    """An adversarial mesh (each face its own 3 vertices) with corners 1 and
    2 of every face the prep keeps swapped, so that it drops them all."""
    _, _, _, area = face_corners(torch.from_numpy(verts),
                                 torch.from_numpy(faces), H)
    verts = verts.copy()
    for b, f in zip(*np.nonzero(area.numpy() > 0)):
        verts[b, 3 * f + 1:3 * f + 3] = verts[b, [3 * f + 2, 3 * f + 1]]
    return verts, faces, attrs


# (verts, faces, attrs, image size) makers: the inputs of
# tests/test_torch_raster_cull.py, then batch 1, image sizes 64 and 512, and
# an input whose tiles are all empty
HARD_INPUTS = {
    'four-views': lambda: (*four_views(synthetic_head()[0], 6), 256),
    'adversarial-64': lambda: (*adversarial_mesh(2, 64, 400, 0), 64),
    'adversarial-128': lambda: (*adversarial_mesh(2, 128, 1500, 1), 128),
    'adversarial-batch1-64': lambda: (*adversarial_mesh(1, 64, 300, 3), 64),
    'adversarial-512': lambda: (*adversarial_mesh(2, 512, 20000, 4), 512),
    'four-views-512': lambda: (*four_views(synthetic_head()[0], 7), 512),
    'all-tiles-empty': lambda: (*_all_dropped(*adversarial_mesh(
        2, 128, 1500, 5), 128), 128),
}


@pytest.mark.parametrize('case', list(HARD_INPUTS))
def test_binned_kernels_on_hard_inputs(device, case):
    """K1, K2 and K3 each bit-equal to its plain version; K3 equal to K1
    and K2's pix_to_face to K1's."""
    *arrays, H = HARD_INPUTS[case]()
    verts, faces, attrs = (torch.from_numpy(a).to(device) for a in arrays)
    outs = {}
    for name, kernel, plain, args in (
            ('K1', rasterize_binned_uv, rasterize_binned_uv_plain,
             (verts, faces, attrs)),
            ('K2', rasterize_binned, rasterize_binned_plain, (verts, faces)),
            ('K3', rasterize_binned_uv16, rasterize_binned_uv16_plain,
             (verts, faces, attrs))):
        before = kernel.launches
        got = kernel(*args, H)
        want = plain(*args, H)
        torch.cuda.synchronize()
        assert kernel.launches == before + 1, name
        for a, b in zip(got, want):
            assert torch.equal(a, b), name
        outs[name] = got
    assert all(torch.equal(a, b) for a, b in zip(outs['K3'], outs['K1']))
    assert torch.equal(outs['K2'][0], outs['K1'][0])
    covered = float((outs['K1'][0] >= 0).float().mean())
    if case == 'all-tiles-empty':
        assert covered == 0 and bool((outs['K2'][1] == 1e10).all())
    else:
        assert covered > 0.05


@pytest.mark.parametrize('with_attrs,attrs_batch,tile', [
    (True, 1, 32), (True, 2, 32), (False, 1, 32), (True, 1, 16)],
    ids=['K1', 'K1-attrs-per-image', 'K2', 'K3'])
def test_binned_prep_cuda_matches_torch_prep(device, with_attrs, attrs_batch,
                                             tile):
    verts, faces, attrs = _head(device)
    if attrs_batch == 2:
        attrs = torch.cat([attrs, attrs.flip(1)])
    args = (verts, faces, attrs if with_attrs else None, 256, tile)
    slab, starts = binned_prep_cuda(*args)
    want_slab, want_starts = binned_prep(*args)
    torch.cuda.synchronize()
    assert slab.shape == want_slab.shape and starts.dtype == torch.int32
    assert torch.equal(starts, want_starts)
    for b, rows in enumerate(segments_in_face_order(slab, starts)):
        assert rows.shape[1] > 0
        assert torch.equal(rows, want_slab[b, :, :rows.shape[1]])


@pytest.mark.parametrize('patch', [32, 16])
def test_k5_kernel_matches_plain(device, patch):
    verts, faces, _ = _head(device)
    before = rasterize_zbuffer.launches
    got = rasterize_zbuffer(verts, faces, 256, patch)
    want = rasterize_zbuffer_plain(verts, faces, 256, patch)
    torch.cuda.synchronize()
    assert rasterize_zbuffer.launches == before + 1
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert float((got[0] >= 0).float().mean()) > 0.05


def _k5_all_culled(verts, faces, H):
    """Each face of a mesh of independent faces wound the other way, and
    a face that K5's prep keeps either way collapsed to a point, so that
    the prep culls every face."""
    verts = verts.copy()
    faces_t = torch.from_numpy(faces)
    data, _, _ = zbuffer_prep(torch.from_numpy(verts), faces_t, H)
    for b, f in zip(*np.nonzero(data[:, 9].numpy() > 0)):
        verts[b, 3 * f + 1:3 * f + 3] = verts[b, [3 * f + 2, 3 * f + 1]]
    data, _, _ = zbuffer_prep(torch.from_numpy(verts), faces_t, H)
    for b, f in zip(*np.nonzero(data[:, 9].numpy() > 0)):
        verts[b, 3 * f + 1:3 * f + 3] = verts[b, 3 * f]
    return verts, faces


# (verts, faces, image size, patch) makers for K5: the head, the inputs of
# tests/test_torch_zbuffer_cull.py, then batch 1, image sizes 64, 256 and
# 512, and an input whose faces are all culled
K5_INPUTS = {
    'four-views': lambda: (*four_views(synthetic_head()[0], 6)[:2], 256, 32),
    'sliver-sweep-64': lambda: (*sliver_sweep(8, 64, 40, 0), 64, 32),
    'zbuffer-mesh-64': lambda: (*zbuffer_mesh(2, 64, 300, 0), 64, 32),
    'zbuffer-mesh-256': lambda: (*zbuffer_mesh(4, 256, 3000, 1), 256, 32),
    'zbuffer-mesh-512-patch64': lambda: (*zbuffer_mesh(2, 512, 6000, 2),
                                         512, 64),
    'zbuffer-mesh-batch1-256-patch16': lambda: (*zbuffer_mesh(1, 256, 2000,
                                                              3), 256, 16),
    'adversarial-128': lambda: (*adversarial_mesh(2, 128, 1500, 1)[:2], 128,
                                32),
    'all-culled': lambda: (*_k5_all_culled(*zbuffer_mesh(2, 128, 600, 4),
                                           128), 128, 32),
}


@pytest.mark.parametrize('case', list(K5_INPUTS))
def test_k5_kernel_on_hard_inputs(device, case):
    """K5 bit-equal to its plain version, one launch a call."""
    *arrays, H, patch = K5_INPUTS[case]()
    verts, faces = (torch.from_numpy(a).to(device) for a in arrays)
    before = rasterize_zbuffer.launches
    got = rasterize_zbuffer(verts, faces, H, patch)
    want = rasterize_zbuffer_plain(verts, faces, H, patch)
    torch.cuda.synchronize()
    assert rasterize_zbuffer.launches == before + 1
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    covered = float((got[0] >= 0).float().mean())
    if case == 'all-culled':
        assert covered == 0 and bool((got[1] == 1e10).all())
    else:
        assert covered > 0


@pytest.mark.parametrize('case', ['four-views', 'zbuffer-mesh-512-patch64',
                                  'all-culled'])
def test_zbuffer_prep_cuda_matches_torch_prep(device, case):
    """The CUDA prep keeps and culls the same faces as the torch prep, and
    its face rows and stripe starts are bit-equal on the kept faces."""
    *arrays, H, patch = K5_INPUTS[case]()
    verts, faces = (torch.from_numpy(a).to(device) for a in arrays)
    data, y0, stripe_h = zbuffer_prep_cuda(verts, faces, H, patch)
    want_data, want_y0, want_stripe = zbuffer_prep(verts, faces, H, patch)
    torch.cuda.synchronize()
    assert stripe_h == want_stripe and y0.dtype == torch.int32
    kept = want_data[:, 9] > 0
    assert torch.equal(data[:, 9] > 0, kept)
    assert torch.equal(data.permute(0, 2, 1)[kept],
                       want_data.permute(0, 2, 1)[kept])
    assert torch.equal(y0[kept], want_y0[kept])


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_k6_kernel_matches_plain(device, dtype):
    g = torch.Generator(device=device).manual_seed(0)
    table = torch.randn(4096, 128, generator=g, device=device).to(dtype)
    idx = torch.randint(0, 4096, (3000,), generator=g, device=device,
                        dtype=torch.int32)
    before = gather_row_blocks.launches
    got = gather_row_blocks(table, idx)
    want = gather_row_blocks_plain(table, idx)
    torch.cuda.synchronize()
    assert gather_row_blocks.launches == before + 1
    assert got.shape == (3000, 8, 128) and torch.equal(got, want)


@pytest.mark.parametrize("yaw", [0.0, 0.6])
def test_k4_kernel_matches_plain(device, yaw):
    g = torch.Generator(device=device).manual_seed(0)
    planes = channels_last(torch.randn(2, 3, 32, 256, 256, generator=g,
                                       device=device))
    c = _camera(2, device, yaw)
    ro, rd = sample_rays(c[:, :16].reshape(-1, 4, 4),
                         c[:, 16:25].reshape(-1, 3, 3), 32)
    depths = sample_stratified(None, ro, 2.25, 3.3, 48)
    coords = (ro[:, :, None] + depths * rd[:, :, None]).reshape(2, -1, 3)
    before = triplane_sample.launches
    got = triplane_sample(planes, coords, 1.0)
    want = triplane_sample_plain(planes, coords, 1.0)
    torch.cuda.synchronize()
    assert triplane_sample.launches == before + 1
    assert (got - want).abs().max().item() <= 1e-5


@pytest.mark.parametrize('n,m,box_warp', [(1, 4099, 1.0), (3, 1000, 2.0)])
def test_k4_kernel_ragged_and_far_out_points(device, n, m, box_warp):
    """N = 1, M not a multiple of the 32 points a block takes, and points
    in and far out of the box (up to 1e4 box widths; zeros there)."""
    g = torch.Generator(device=device).manual_seed(1)
    planes = channels_last(torch.randn(n, 3, 32, 64, 48, generator=g,
                                       device=device))
    coords = (torch.rand(n, m, 3, generator=g, device=device) * 2 - 1) \
        * box_warp * 0.6
    coords[:, ::7] *= 1e4
    coords[:, 1::7] *= 1.05 / 0.6
    before = triplane_sample.launches
    got = triplane_sample(planes, coords, box_warp)
    want = triplane_sample_plain(planes, coords, box_warp)
    torch.cuda.synchronize()
    assert triplane_sample.launches == before + 1
    assert got.shape == (n, 3, m, 32)
    assert torch.all(got[:, :, ::7] == 0)
    assert (got - want).abs().max().item() <= 1e-5


def test_k4_kernel_at_the_shape_chunk(device):
    """The shape path's launch: N = 1 and the first chunk of gen-samples'
    256^3 sigma grid (1,000,000 points, cli/gen_samples.py)."""
    g = torch.Generator(device=device).manual_seed(2)
    planes = channels_last(torch.randn(1, 3, 32, 256, 256, generator=g,
                                       device=device))
    coords = torch.from_numpy(create_samples(256)[0][:1000000]).to(
        device)[None]
    before = triplane_sample.launches
    got = triplane_sample(planes, coords, 1.0)
    want = triplane_sample_plain(planes, coords, 1.0)
    torch.cuda.synchronize()
    assert triplane_sample.launches == before + 1
    assert got.shape == (1, 3, 1000000, 32)
    assert (got - want).abs().max().item() <= 1e-5


def test_k4_kernel_raises_under_grad_mode(device):
    """K4's backward gives the planes' gradient only: under grad mode,
    coordinates that require grad raise, and planes that require grad get
    an output that carries their gradient; under no_grad both run."""
    planes = channels_last(torch.randn(1, 3, 32, 16, 16, device=device))
    coords = torch.rand(1, 100, 3, device=device) - 0.5
    with pytest.raises(RuntimeError, match='planes only'):
        triplane_sample(planes, coords.clone().requires_grad_(), 1.0)
    p = planes.clone().requires_grad_()
    out = triplane_sample(p, coords, 1.0)
    assert out.requires_grad
    out.sum().backward()
    assert p.grad is not None and p.grad.shape == planes.shape
    for p, c in ((planes.clone().requires_grad_(), coords),
                 (planes, coords.clone().requires_grad_())):
        with torch.no_grad():
            out = triplane_sample(p, c, 1.0)
        assert out.shape == (1, 3, 100, 32) and not out.requires_grad
    assert triplane_sample(planes, coords, 1.0).shape == (1, 3, 100, 32)


def _k4_backward_points(case, device):
    """(coordinates, box_warp, (H, W)) of a K4-backward case, seeded."""
    g = torch.Generator(device=device).manual_seed(3)
    if case in ('render', 'jittered', 'fine_like'):
        c = _camera(2, device, 0.3)
        ro, rd = sample_rays(c[:, :16].reshape(-1, 4, 4),
                             c[:, 16:25].reshape(-1, 3, 3), 32)
        depths = sample_stratified(g if case == 'jittered' else None, ro,
                                   2.25, 3.3, 48)
        if case == 'fine_like':
            # importance draws: most samples within 0.02 of a surface depth
            surface = 2.6 + 0.2 * torch.rand(2, ro.shape[1], 1, 1,
                                             generator=g, device=device)
            depths = (surface + 0.02 * torch.randn(
                depths.shape, generator=g, device=device)).sort(2).values
        coords = (ro[:, :, None] + depths * rd[:, :, None]).reshape(2, -1, 3)
        return coords, 1.0, (256, 256)
    if case == 'one_cell':
        # every point of 2 images inside one texel: the worst pile-up,
        # 73,728 points on each texel of each image's planes
        coords = 0.1 + 1e-3 * torch.rand(2, 73728, 3, generator=g,
                                         device=device)
        return coords, 1.0, (256, 256)
    n, m, box_warp, size = dict(ragged=(1, 4099, 1.0, (64, 48)),
                                nonsquare=(3, 1000, 2.0, (33, 70)))[case]
    coords = (torch.rand(n, m, 3, generator=g, device=device) * 2 - 1) \
        * box_warp * 0.6
    coords[:, ::7] *= 1e4
    return coords, box_warp, size


@pytest.mark.parametrize('case', ['render', 'ragged', 'nonsquare',
                                  'one_cell', 'jittered', 'fine_like'])
def test_k4_backward_kernel_matches_plain(device, case):
    """K4's backward against its plain version (index_add_ of the 4 taps)
    and against the library's grid_sampler_2d backward, both adding in
    float64 at the kernel's float32 sample positions, within 1e-5 of the
    largest gradient: the render pass's points, a ragged count that the run
    length does not divide, points far out of the box (no taps), planes
    that are not square, every point in one texel, jittered depths and
    depths clustered as the fine pass draws them. The references add in
    float64 so that the bound holds the kernel's own sums alone: at the
    one-texel pile-up a float32 reference's sums round by about as much as
    the kernel's."""
    coords, box_warp, (H, W) = _k4_backward_points(case, device)
    n, m, _ = coords.shape
    g = torch.Generator(device=device).manual_seed(4)
    grad_out = torch.randn(n, 3, m, 32, generator=g, device=device)
    before = triplane_sample_backward.launches
    got = triplane_sample_backward(grad_out, coords, box_warp, H, W)
    want = triplane_sample_backward_plain(grad_out.double(), coords,
                                          box_warp, H, W)
    torch.cuda.synchronize()
    assert triplane_sample_backward.launches == before + 1
    assert got.shape == (n, 3, H, W, 32)
    scale = want.abs().max().item()
    assert scale > 0 and (got - want).abs().max().item() <= 1e-5 * scale
    # the kernel's positions as a float64 grid, which grid_sampler_2d
    # unnormalizes back to them
    ix, iy = kernel_positions(coords, box_warp, H, W)
    grid = torch.stack([(2 * ix.double() + 1) / W - 1,
                        (2 * iy.double() + 1) / H - 1], -1)
    library = torch.ops.aten.grid_sampler_2d_backward(
        grad_out.double().reshape(n * 3, m, 32).permute(0, 2, 1)[:, :, None],
        torch.zeros(n * 3, 32, H, W, dtype=torch.float64, device=device),
        grid.reshape(n * 3, 1, m, 2), 0, 0, False, [True, False])[0]
    library = library.reshape(n, 3, 32, H, W).permute(0, 1, 3, 4, 2)
    assert (got - library).abs().max().item() <= 1e-5 * scale


@pytest.mark.parametrize('case', ['render', 'ragged', 'nonsquare',
                                  'one_cell', 'jittered', 'fine_like'])
def test_k4_bf16_backward_binned_matches_plain(device, case):
    """K4's bf16 backward, the binned kernels, against its plain version
    (the float32 plain backward cast to bf16) within one bf16 ulp (2^-7 of
    each value) plus 1e-5 of the largest gradient (the two add in float32
    in other orders before the rounding), on the float32 backward's point
    sets: the one-texel set splits its tiles into chunks. Its tile counts
    equal the model's (ops/triplane.py bin_counts) and it counts one
    launch."""
    coords, box_warp, (H, W) = _k4_backward_points(case, device)
    n, m, _ = coords.shape
    g = torch.Generator(device=device).manual_seed(4)
    grad_out = torch.randn(n, 3, m, 32, generator=g, device=device)
    before = triplane_sample_backward_bf16.launches
    got, workspace = _backward_bf16_cuda(grad_out, coords, box_warp, H, W)
    want = triplane_sample_backward_plain(grad_out, coords, box_warp, H,
                                          W).to(torch.bfloat16).float()
    torch.cuda.synchronize()
    assert triplane_sample_backward_bf16.launches == before + 1
    assert got.dtype == torch.bfloat16 and got.shape == (n, 3, H, W, 32)
    scale = want.abs().max().item()
    assert scale > 0 and bool(((got.float() - want).abs()
                               <= 2 ** -7 * want.abs() + 1e-5 * scale).all())
    counts = bin_counts(coords, box_warp, H, W)
    starts = workspace[2:counts.numel() + 3].long()
    assert torch.equal(starts[1:] - starts[:-1], counts)
    if case == 'one_cell':
        assert workspace[1].item() > 0    # split tiles


def test_k4_bf16_backward_binned_without_points(device):
    """No points: the binned kernels write every texel's zero."""
    grad = triplane_sample_backward_bf16(
        torch.zeros(2, 3, 0, 32, device=device),
        torch.zeros(2, 0, 3, device=device), 1.0, 40, 24)
    torch.cuda.synchronize()
    assert grad.dtype == torch.bfloat16 and grad.shape == (2, 3, 40, 24, 32)
    assert not grad.any()


def test_k4_backward_through_both_render_passes(device):
    """Training's use of K4's backward: the planes' gradient of a small
    renderer's rgb (coarse and fine pass, midpoint depths and linspace
    importance draws), by torch.autograd.grad through _SampleWithBackward on
    the card, against the same on the CPU, where F.grid_sample's autograd
    gives it; within 1e-4 of the largest gradient (the decoder's float32
    sums and the importance draw round differently on the two devices)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    opts = dict(ray_start=2.25, ray_end=3.3, box_warp=1.0,
                depth_resolution=24, depth_resolution_importance=24,
                disparity_space_sampling=False, clamp_mode='softplus')
    decoder = OSGDecoder(32, {'decoder_lr_mul': 1, 'decoder_output_dim': 32},
                         generator=torch.Generator().manual_seed(5))
    rs = np.random.RandomState(6)
    planes = torch.from_numpy(rs.randn(1, 3, 32, 64, 64).astype(np.float32))
    c = _camera(1, 'cpu', 0.2)
    ro, rd = sample_rays(c[:, :16].reshape(-1, 4, 4),
                         c[:, 16:25].reshape(-1, 3, 3), 24)
    weight = torch.from_numpy(rs.randn(1, ro.shape[1], 32).astype(
        np.float32))
    grads = []
    for dev in ('cpu', device):
        p = planes.to(dev).requires_grad_()
        before = triplane_sample_backward.launches
        rgb, _, _ = ImportanceRenderer()(p, decoder.to(dev), ro.to(dev),
                                         rd.to(dev), opts)
        grad, = torch.autograd.grad((rgb * weight.to(dev)).sum(), p)
        grads.append(grad.cpu())
        assert triplane_sample_backward.launches == before + (
            0 if dev == 'cpu' else 2)
    want, got = grads
    scale = want.abs().max().item()
    assert scale > 0 and (got - want).abs().max().item() <= 1e-4 * scale


def test_k4_kernel_rejects_other_channel_counts(device):
    planes = channels_last(torch.zeros(1, 3, 16, 8, 8, device=device))
    with pytest.raises(ValueError, match='32 channels'):
        triplane_sample(planes, torch.zeros(1, 5, 3, device=device), 1.0)


@pytest.mark.parametrize('case', ['render', 'ragged'])
def test_k4_bf16_instance_matches_plain(device, case):
    """K4's bf16-plane instance (the gather_bf16 path) against its plain
    version, F.grid_sample on the same planes upcast, within 1e-5 (both sum
    in float32), at the render's coarse points and at a ragged count with
    points far out of the box; it counts its launches apart."""
    g = torch.Generator(device=device).manual_seed(5)
    if case == 'render':
        raw = torch.randn(2, 3, 32, 256, 256, generator=g, device=device)
        c = _camera(2, device, 0.3)
        ro, rd = sample_rays(c[:, :16].reshape(-1, 4, 4),
                             c[:, 16:25].reshape(-1, 3, 3), 32)
        depths = sample_stratified(None, ro, 2.25, 3.3, 48)
        coords = (ro[:, :, None] + depths * rd[:, :, None]).reshape(2, -1, 3)
    else:
        raw = torch.randn(1, 3, 32, 64, 48, generator=g, device=device)
        coords = torch.rand(1, 4099, 3, generator=g, device=device) - 0.5
        coords[:, ::7] *= 1e4
    planes = channels_last(raw, torch.bfloat16)
    assert planes.dtype == torch.bfloat16 and planes.is_contiguous()
    assert torch.equal(planes, raw.permute(0, 1, 3, 4, 2).to(torch.bfloat16))
    before = (triplane_sample.launches, triplane_sample.launches_bf16)
    got = triplane_sample(planes, coords, 1.0)
    want = triplane_sample_plain(planes, coords, 1.0)
    torch.cuda.synchronize()
    assert (triplane_sample.launches, triplane_sample.launches_bf16) == \
        (before[0], before[1] + 1)
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert (got - want).abs().max().item() <= 1e-5


def test_k4_bf16_instance_raises_under_grad_mode(device):
    """Under grad mode the bf16 instance raises only for coordinates that
    require grad, as the float32 one does. bf16 planes that require grad
    get their gradient from the binned bf16 backward, counted in its own
    launches and not the float32 backward's, each value rounded to bf16
    once: within bf16's rounding (2^-8 of each value) plus 1e-5 of the
    largest gradient (the kernels' float32 sums against the plain
    version's float64 sums) of the plain float32 gradient. Under no_grad
    they run; other storage types raise."""
    g = torch.Generator(device=device).manual_seed(7)
    planes = channels_last(torch.randn(1, 3, 32, 64, 48, generator=g,
                                       device=device), torch.bfloat16)
    coords = torch.rand(1, 4099, 3, generator=g, device=device) - 0.5
    with pytest.raises(RuntimeError, match='planes only'):
        triplane_sample(planes, coords.clone().requires_grad_(), 1.0)
    p = planes.clone().requires_grad_()
    before = (triplane_sample.launches_bf16,
              triplane_sample_backward.launches,
              triplane_sample_backward_bf16.launches)
    out = triplane_sample(p, coords, 1.0)
    assert out.dtype == torch.float32 and out.requires_grad
    grad_out = torch.randn(out.shape, generator=g, device=device)
    out.backward(grad_out)
    torch.cuda.synchronize()
    assert (triplane_sample.launches_bf16, triplane_sample_backward.launches,
            triplane_sample_backward_bf16.launches) == \
        (before[0] + 1, before[1], before[2] + 1)
    want = triplane_sample_backward_plain(grad_out.double(), coords, 1.0,
                                          64, 48)
    assert p.grad.dtype == torch.bfloat16 and p.grad.shape == planes.shape
    err = (p.grad.double() - want).abs()
    scale = want.abs().max().item()
    assert scale > 0 and bool(
        (err <= 2 ** -8 * want.abs() + 1e-5 * scale).all())
    with torch.no_grad():
        out = triplane_sample(planes.clone().requires_grad_(), coords, 1.0)
    assert out.dtype == torch.float32 and not out.requires_grad
    with pytest.raises(ValueError, match='float32 or bfloat16'):
        triplane_sample(planes.half(), coords, 1.0)


@pytest.mark.parametrize('model', ['flagship', 'texture'])
def test_small_slice_on_card_matches_cpu(device, model):
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh, lms = synthetic_head()
    rk = dict(ray_start=2.25, ray_end=3.3, box_warp=1.0, depth_resolution=8,
              depth_resolution_importance=8, disparity_space_sampling=False,
              clamp_mode='softplus', c_gen_conditioning_zero=False,
              c_scale=1.0, superresolution_module='SuperresolutionHybrid2X',
              superresolution_noise_mode='none', sr_antialias=True)
    cls = TriPlaneGenerator if model == 'flagship' \
        else TriPlaneTextureGenerator
    G = cls(z_dim=64, c_dim=25, w_dim=512, img_resolution=128,
            img_channels=3, topology_path=mesh, rendering_kwargs=rk,
            channel_base=2048, channel_max=64,
            generator=torch.Generator().manual_seed(0)).eval()
    v = mesh.verts if model == 'texture' \
        else np.concatenate([mesh.verts, lms])
    v = torch.from_numpy(v[None].astype(np.float32))
    z = torch.randn(1, 64, generator=torch.Generator().manual_seed(1))
    c = _camera(1, 'cpu', 0.2)
    kw = dict(truncation_psi=0.7, truncation_cutoff=14, noise_mode='const')
    with torch.no_grad():
        want = G(z, c, v, **kw)
        G.to(device)
        got = G(z.to(device), c.to(device), v.to(device), **kw)
    for key in ('image', 'image_raw', 'image_depth'):
        err = (got[key].cpu() - want[key]).abs()
        assert err.max().item() <= 2e-3 and err.mean().item() <= 1e-4, key


@pytest.mark.parametrize('size', [128, 512])
def test_inception_on_card_matches_cpu(device, size, tmp_path):
    """The Inception-2015 graph of seeded weights on the card against the
    CPU, TF32 off: features within 1e-4 of their scale, IS probabilities
    within 1e-5; a scripted copy converts and attests on the card."""
    from next3d_tpu_torch.metrics import inception
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    params = inception.init_params(0)
    cpu = inception.inception_of_params(params)
    card = inception.inception_of_params(params, device)
    x = torch.from_numpy(np.random.RandomState(1).randint(
        0, 256, (4, 3, size, size)).astype(np.uint8))
    with torch.no_grad():
        want = cpu(x, return_features=True)
        got = card(x.to(device), return_features=True).cpu()
        probs = (card(x.to(device), no_output_bias=True).cpu()
                 - cpu(x, no_output_bias=True)).abs().max().item()
    assert (got - want).abs().max().item() <= 1e-4 * want.abs().max().item()
    assert probs <= 1e-5
    path = str(tmp_path / 'inception.pt')
    torch.jit.script(cpu).save(path)
    model = inception.converted_inception(path, str(device))
    assert next(model.parameters()).device.type == 'cuda'
    with open(path + '.torch_parity.json') as f:
        assert json.load(f)['device'] == 'cuda'
