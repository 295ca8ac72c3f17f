"""The port's CUDA kernels against their plain torch versions, and the
small slice on the card against the same slice on the CPU.

These tests need a CUDA device and skip without one. The machine with the
card has no JAX, so this file imports none and the conftest (which does)
is bypassed there:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

Tolerances: K1, K2, K3 and K5 are bit-equal to their plain versions (the
same rounding, see csrc/raster_binned_uv.cu and csrc/raster_zbuffer.cu), K6
is a copy and exact; the binned kernels' CUDA prep gives the torch prep's
segment starts exactly and, once each segment is sorted by face id, its
slab bit for bit (csrc/raster_binned_prep.cu); K4 within 1e-5 (its
unnormalization rounds in another order than F.grid_sample); the slices
within the fp32 parity gate of ROADMAP.md (max-abs 2e-3, mean-abs 1e-4),
with TF32 off on the card.
"""

import math

import numpy as np
import pytest
import torch

from next3d_tpu_torch.models.triplane_next3d import TriPlaneGenerator
from next3d_tpu_torch.models.triplane_texture import TriPlaneTextureGenerator
from next3d_tpu_torch.ops.dma_gather import (gather_row_blocks,
                                             gather_row_blocks_plain)
from next3d_tpu_torch.ops.raster import (binned_prep, binned_prep_cuda,
                                         rasterize_binned,
                                         rasterize_binned_plain,
                                         rasterize_binned_uv,
                                         rasterize_binned_uv16,
                                         rasterize_binned_uv16_plain,
                                         rasterize_binned_uv_plain,
                                         segments_in_face_order)
from next3d_tpu_torch.ops.raster_zbuffer import (rasterize_zbuffer,
                                                 rasterize_zbuffer_plain)
from next3d_tpu_torch.ops.triplane import (channels_last, triplane_sample,
                                           triplane_sample_plain)
from next3d_tpu_torch.render.camera_utils import (fov_to_intrinsics,
                                                  lookat_pose)
from next3d_tpu_torch.render.ray_sampler import sample_rays
from next3d_tpu_torch.render.renderer import sample_stratified
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


def test_k4_kernel_rejects_other_channel_counts(device):
    planes = channels_last(torch.zeros(1, 3, 16, 8, 8, device=device))
    with pytest.raises(ValueError, match='32 channels'):
        triplane_sample(planes, torch.zeros(1, 5, 3, device=device), 1.0)


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
