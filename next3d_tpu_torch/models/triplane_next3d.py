"""The flagship Next3D generator: generative texture-rasterized tri-planes.

Counterpart of next3d_tpu/models/triplane_next3d.py (reference:
training_avatar_texture/triplane_next3d.py). The module tree uses the JAX
parameter tree's names (texture_backbone, mouth_backbone, backbone,
superresolution, decoder, neural_blending, orth_scale, orth_shift), so
``utils.weights.load_jax_params`` loads a JAX tree with ``strict=True``.

The 4 orthographic views are folded into the batch axis and rasterized in
one call: by default to kernel K1, or, as ``rasterizer_impl`` names it, to
K3 ('pallas_binned16'), K5 ('pallas') or the plain torch 'tiled' (with
``rasterizer_tile_capacity``) and 'scatter' (with ``rasterizer_patch`` and
``rasterizer_face_chunk``) rasterizers. The constructor checks the choice
against the neutral mesh as the JAX package does, and 'auto' falls back to
'tiled' where JAX's does (``_validate_rasterizer_capacity``). The 3 planes
are sampled by kernel K4 inside the volume renderer. The mouth crop and
paste are per-sample slices plus antialiased ``F.interpolate``, which reads
the landmark boxes on the host.

Spans (``utils/profiling.py``): ``G.mapping``; ``G.synthesis`` and
``G.synthesis_from_identity`` around those calls, whose stages
``G.backbones``, ``G.raster``, ``G.mouth_blend``, ``G.plane_mix``,
``G.render`` and ``G.sr`` tile them, each with its parts
(``G.raster.project``, ``.kernel``, ``.sample``, ``.flood``;
``G.mouth_blend.crop``, ``.mouth``, ``.paste``, ``.blend``;
``G.render.rays``, ``.coarse``, ``.importance``, ``.fine``,
``.composite``); and a ``sync.<site>`` span around each host sync.

``force_fp32=True`` (the default, as in JAX) runs everything float32.
``force_fp32=False`` is the JAX package's serving fast path, by explicit
casts where JAX casts (not autocast): the ``use_fp16`` blocks of every
backbone, StyleUNet and super-resolution head run bf16 (the top
``num_fp16_res`` resolutions, default 4; the SR blocks when
``sr_num_fp16_res > 0``), and so do the StyleUNets' encoders and fusions,
the mouth crop and paste and the decoder's MLP (``decoder_bf16``); the
texture table and the eye mask are rounded to bf16 before the texture
sample, and K4 samples planes stored in bf16 (``gather_bf16``). Parameters
stay float32; the rasterizers, the mapping network, the ray marcher and
the alpha mix run float32. ``generator`` in the constructor seeds the
parameters; ``generator`` in the forward methods drives
``noise_mode='random'`` and the renderer's jitter (None gives the
deterministic midpoints).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..nn import superresolution as sr_modules
from ..nn.styleunet import CondGenerator
from ..nn.stylegan2 import Generator as StyleGAN2Backbone
from ..ops.grid_sample import grid_sample_2d
from ..ops.interpolate import (interpolate_nearest, paste_resized_region,
                               resample_region)
from ..render.fill_mouth import fill_mouth
from ..render.mesh import angle2matrix, batch_orth_proj, face_vertices
from ..render.rasterizer import (rasterize_uv_with_alpha,
                                 required_patch_size, required_tile_capacity,
                                 select_impl)
from ..render.ray_sampler import sample_rays
from ..render.renderer import ImportanceRenderer, layout_for
from ..utils.obj_io import ObjMesh, load_obj
from ..utils.profiling import span
from ..utils.registry import register
from .osg_decoder import OSGDecoder

RENDERING_VIEWS = ((0, 0, 0), (0, 90, 0), (0, -90, 0), (90, 0, 0))
N_FLAME_VERTS = 5023
# The JAX package's binned kernels read at most MAX_SEG entries of a 32-px
# tile (MAX_SEG16 of a 16-px one; next3d_tpu/ops/pallas_raster.py:185,559),
# and its constructor selects the rasterizer by them. The port's kernels
# have no such window, but select by the same thresholds, so that a config
# selects the same rasterizer, and renders the same pixels, in both.
MAX_SEG = 4096
MAX_SEG16 = 1024


def _load_eye_mask(path, size):
    if path is None:
        return torch.ones((size, size))
    from PIL import Image
    img = torch.from_numpy(np.asarray(Image.open(path)).astype(np.float32)
                           / 255.0)
    if img.ndim == 3:
        img = img[..., 0]
    return interpolate_nearest(img[None, None], (size, size))[0, 0]


class TriPlaneGenerator(nn.Module):
    """Flagship --model_version=next3d generator."""

    # the mouth StyleUNet and the neural blending StyleUNet
    blends_mouth = True

    def __init__(self, z_dim, c_dim, w_dim, img_resolution, img_channels,
                 topology_path, uv_face_eye_mask_path=None, sr_num_fp16_res=0,
                 mapping_kwargs=None, rendering_kwargs=None, sr_kwargs=None,
                 rasterizer_impl='auto', rasterizer_patch=32,
                 rasterizer_face_chunk=2048, rasterizer_tile_capacity=448,
                 plane_resolution=256, force_fp32=True, generator=None,
                 **synthesis_kwargs):
        super().__init__()
        self.z_dim = z_dim
        self.c_dim = c_dim
        self.w_dim = w_dim
        self.img_resolution = img_resolution
        self.img_channels = img_channels
        self.force_fp32 = force_fp32
        self.rendering_kwargs = dict(rendering_kwargs or {})
        self.rendering_kwargs.setdefault('gather_bf16', not force_fp32)
        self.neural_rendering_resolution = 64
        self.uv_resolution = R = plane_resolution
        select_impl(rasterizer_impl, R)            # an unknown name raises
        self.rasterizer_impl = rasterizer_impl
        self.rasterizer_patch = rasterizer_patch
        self.rasterizer_face_chunk = rasterizer_face_chunk
        self.rasterizer_tile_capacity = rasterizer_tile_capacity
        mapping_kwargs = mapping_kwargs or {}
        kw = dict(mapping_kwargs=mapping_kwargs, generator=generator,
                  **synthesis_kwargs)

        self.renderer = ImportanceRenderer()
        self.texture_backbone = StyleGAN2Backbone(
            z_dim, c_dim, w_dim, img_resolution=R, img_channels=32, **kw)
        if self.blends_mouth:
            self.mouth_backbone = CondGenerator(
                z_dim, c_dim, w_dim, img_resolution=R, img_channels=32,
                in_size=64, final_size=4, cond_channels=32, num_cond_res=64,
                **kw)
        self.backbone = StyleGAN2Backbone(
            z_dim, c_dim, w_dim, img_resolution=R, img_channels=32 * 3,
            mapping_ws=self.texture_backbone.num_ws * 2, **kw)
        if self.blends_mouth:
            self.neural_blending = CondGenerator(
                z_dim, c_dim, w_dim, cond_channels=32, img_resolution=R,
                img_channels=32, in_size=min(R, 256), final_size=32,
                num_cond_res=R, **kw)
        sr_name = self.rendering_kwargs.get(
            'superresolution_module', 'SuperresolutionHybrid8XDC')
        self.superresolution = getattr(sr_modules, sr_name.rsplit('.', 1)[-1])(
            channels=32, img_resolution=img_resolution,
            sr_num_fp16_res=sr_num_fp16_res,
            sr_antialias=self.rendering_kwargs.get('sr_antialias', True),
            generator=generator, **(sr_kwargs or {}))
        self.decoder = OSGDecoder(
            32, {'decoder_lr_mul': self.rendering_kwargs.get(
                'decoder_lr_mul', 1), 'decoder_output_dim': 32,
                'decoder_bf16': self.rendering_kwargs.get('decoder_bf16',
                                                          not force_fp32)},
            generator=generator)
        self.orth_scale = nn.Parameter(torch.tensor([[5.0]]))
        self.orth_shift = nn.Parameter(torch.tensor([[0.0, -0.01, -0.01]]))

        # static mesh buffers (reference :79-106), with the per-call face
        # reorders (reference :207-208) applied once
        mesh = topology_path if isinstance(topology_path, ObjMesh) \
            else load_obj(topology_path)
        if mesh.verts_uvs is None or mesh.faces_uvs is None:
            raise ValueError('topology obj must carry UVs')
        if mesh.verts.shape[0] != N_FLAME_VERTS:
            raise ValueError(f'topology has {mesh.verts.shape[0]} verts, '
                             f'expected the FLAME {N_FLAME_VERTS}')
        uvcoords = np.concatenate(
            [mesh.verts_uvs, np.ones_like(mesh.verts_uvs[:, :1])], axis=-1)
        uvcoords = uvcoords * 2 - 1
        uvcoords[:, 1] = -uvcoords[:, 1]
        face_uv = face_vertices(torch.from_numpy(uvcoords[None]).float(),
                                torch.from_numpy(mesh.faces_uvs[None]))[0]
        faces = torch.from_numpy(mesh.faces[:, [0, 2, 1]].astype(np.int64))
        self.register_buffer('faces', faces, persistent=False)
        self.register_buffer('face_uv', face_uv[:, [0, 2, 1], :2]
                             .contiguous(), persistent=False)
        self.register_buffer('uv_face_mask', _load_eye_mask(
            uv_face_eye_mask_path, R), persistent=False)
        self.register_buffer('view_tforms', torch.cat(
            [angle2matrix([v]) for v in RENDERING_VIEWS]), persistent=False)
        self._validate_rasterizer_capacity(mesh.verts)

    def _validate_rasterizer_capacity(self, neutral_verts):
        """Check the configured rasterizer against the topology's neutral
        mesh through all views at the init orth_scale (JAX :165-236), so
        that a mis-sized one fails at construction: 'pallas_binned16' needs
        its 16-px segments within MAX_SEG16 and spans below 80% of 32 px;
        'auto' and 'pallas_binned' need their 32-px segments within MAX_SEG
        and the same spans, with 25% slack for expressions, and where they
        are not, 'auto' becomes 'tiled' with ``rasterizer_tile_capacity``
        raised to a quarter of the 8-px occupancy and 'pallas_binned'
        raises; 'tiled' needs 4x its capacity to cover that occupancy;
        'scatter' and 'pallas' (K5, which cuts a face taller than its
        stripe: the port's own check) need ``rasterizer_patch`` above the
        span."""
        v = np.asarray(neutral_verts, np.float32) * np.asarray([1., -1., 1.])
        tv = v @ self.view_tforms.numpy().transpose(0, 2, 1)
        tv = (tv + np.asarray([0.0, -0.01, -0.01])) * 5.0
        tv = tv * np.asarray([1., -1., -1.]) + np.asarray([0., 0., 10.])
        faces = self.faces.numpy()
        res = self.uv_resolution
        patch_need = required_patch_size(tv, faces, res)
        if self.rasterizer_impl == 'pallas_binned16':
            seg_need = required_tile_capacity(tv, faces, res, tile=16)
            if seg_need * 1.25 + 128 > MAX_SEG16 or patch_need >= 32 * 0.8:
                raise ValueError(
                    f'pallas_binned16: tile=16 segments need {seg_need} '
                    f'entries (max_seg={MAX_SEG16}) / span {patch_need:.0f}px '
                    f'at {res}px; use pallas_binned or tiled')
        if self.rasterizer_impl in ('auto', 'pallas_binned'):
            seg_need = required_tile_capacity(tv, faces, res, tile=32)
            over_seg = seg_need * 1.25 + 128 > MAX_SEG
            if over_seg or patch_need >= 32 * 0.8:
                why = (f'tile segments need {seg_need} entries '
                       f'(max_seg={MAX_SEG})' if over_seg else
                       f'face bbox span {patch_need:.0f}px approaches the '
                       f'TILE=32 limit')
                if self.rasterizer_impl != 'auto':
                    raise ValueError(
                        f'binned rasterizer: {why} at {res}px; use '
                        f"rasterizer_impl='tiled' or a lower "
                        f'plane_resolution')
                self.rasterizer_impl = 'tiled'
                need = required_tile_capacity(tv, faces, res, tile=8)
                self.rasterizer_tile_capacity = max(
                    self.rasterizer_tile_capacity, -(-need // 4))
        if self.rasterizer_impl == 'tiled':
            need = required_tile_capacity(tv, faces, res, tile=8)
            if self.rasterizer_tile_capacity * 4 < need:
                raise ValueError(
                    f'rasterizer_tile_capacity={self.rasterizer_tile_capacity}'
                    f' too small: neutral mesh already stacks {need} faces'
                    f' per 8px tile at {res}px')
        if self.rasterizer_impl in ('scatter', 'pallas') \
                and patch_need >= self.rasterizer_patch:
            raise ValueError(
                f'rasterizer_patch={self.rasterizer_patch} < required '
                f'{patch_need:.0f}px at {res}px')

    # --------------------------------------------------------------- mapping
    def mapping(self, z, c, truncation_psi=1, truncation_cutoff=None,
                return_w_mean=False):
        """Camera-only conditioning, optionally zeroed (reference :111-115);
        ``return_w_mean`` as in ``nn.stylegan2.MappingNetwork``."""
        with span('G.mapping'):
            if self.rendering_kwargs.get('c_gen_conditioning_zero', True):
                c = torch.zeros_like(c)
            c = c[:, :25] * self.rendering_kwargs.get('c_scale', 0)
            return self.backbone.mapping(
                z, c, truncation_psi=truncation_psi,
                truncation_cutoff=truncation_cutoff,
                return_w_mean=return_w_mean)

    # ------------------------------------------------------------- rasterize
    def project_views(self, v, lms):
        """Orthographic projection of verts (N, 5023, 3) and landmarks
        (N, 68, 3) through the 4 views, view-major: the rasterizer input
        (V*N, 5023, 3) and the 2D landmarks (V*N, 68, 2)."""
        V = len(RENDERING_VIEWS)
        with span('sync.project_flip'):
            flip = torch.tensor([1., -1., 1.], device=v.device)

        def project(points):
            p = torch.einsum('vnpc,vcd->vnpd',
                             (points * flip)[None].expand(V, -1, -1, -1),
                             self.view_tforms)
            p = (p + self.orth_shift) * self.orth_scale
            with span('sync.orth_camera'):
                camera = torch.tensor([1., 0., 0.], dtype=p.dtype,
                                      device=p.device)
            return batch_orth_proj(p.reshape(V * points.shape[0], -1, 3),
                                   camera)

        tv = project(v)
        tv = torch.cat([tv[..., :1], -tv[..., 1:2], 10.0 - tv[..., 2:]], -1)
        tl = project(lms)[..., :2]
        return tv, torch.cat([tl[..., :1], -tl[..., 1:]], -1)

    def rasterize(self, v, lms, textures):
        """4 orthographic views folded into the batch axis (reference
        :190-230). Returns ([front, side, top] feature images, [alphas],
        front-view 2D landmarks). No gradient flows through the (u, v) grid
        or the alpha (JAX :307-308)."""
        N = v.shape[0]
        V = len(RENDERING_VIEWS)
        with span('G.raster.project'):
            tv, tl = self.project_views(v, lms)
        res = self.uv_resolution
        with span('G.raster.kernel'):
            rendering = rasterize_uv_with_alpha(
                tv, self.faces, self.face_uv[None], res,
                patch=self.rasterizer_patch,
                face_chunk=self.rasterizer_face_chunk,
                impl=self.rasterizer_impl,
                tile_capacity=self.rasterizer_tile_capacity
            ).detach()                                    # (V*N, 3, H, W)
        with span('G.raster.sample'):
            alpha = rendering[:, -1:]
            grid = rendering.permute(0, 2, 3, 1)[..., :2]
            # the views fold into the grid, not the texture batch: the
            # texture and the eye mask are shared by all views of a sample
            grid_vn = grid.reshape(V, N, res, res, 2).transpose(0, 1).reshape(
                N, V * res, res, 2)
            table = torch.cat([textures, self.uv_face_mask.expand(
                N, 1, res, res)], dim=1)
            if not self.force_fp32:
                # the texture and the eye mask are stored in bf16 (JAX
                # :316-317,338-341); the rounded table is sampled in
                # float32, since F.grid_sample takes one dtype for table
                # and grid, and a bf16 grid would move positions by up to
                # a texel
                table = table.to(torch.bfloat16).float()
            sampled = grid_sample_2d(table, grid_vn)    # (N, 33, V*res, res)
            sampled = sampled.reshape(N, -1, V, res, res).permute(
                2, 0, 1, 3, 4)
            sampled = sampled.reshape(V * N, -1, res, res)
            rendering_image = sampled[:, :-1]
        with span('G.raster.flood'):
            alpha = fill_mouth(sampled[:, -1:] * alpha)

        rendering_image = rendering_image.reshape(V, N, -1, res, res)
        alpha = alpha.reshape(V, N, 1, res, res)
        # side views summed; alpha_side keeps the reference's left-view-only
        # OR (triplane_next3d.py:226)
        rendering_side = rendering_image[1] + rendering_image[2]
        alpha_side = ((alpha[1] > 0) | (alpha[1] > 0)).to(alpha.dtype)
        images = [rendering_image[0], rendering_side, rendering_image[3]]
        alphas = [alpha[0], alpha_side, alpha[3]]
        return images, alphas, tl.reshape(V, N, -1, 2)[0]

    # ---------------------------------------------------------- mouth helpers
    def gen_mouth_mask(self, lms2d):
        """Square mouth boxes from landmarks 48..59 (reference :330-344).

        lms2d: (N, 68, 2) in [-1, 1]. Returns int64 (N, 4): y0, y1, x0, x1
        with y1 - y0 == x1 - x0 == 2 * (mask_res // 2).
        """
        half_res = self.uv_resolution / 2
        lm = lms2d * half_res + half_res
        outer = lm[:, 48:60]
        mouth_avg = (outer[:, 0] + outer[:, 6]) * 0.5
        ups = outer[..., 0].max(dim=1).values
        bottoms = outer[..., 0].min(dim=1).values
        lefts = outer[..., 1].min(dim=1).values
        rights = outer[..., 1].max(dim=1).values
        mask_res = torch.floor(torch.maximum(ups - bottoms,
                                             rights - lefts) * 1.2)
        half = torch.floor(mask_res / 2).long()
        cy = torch.floor(mouth_avg[:, 1]).long()
        cx = torch.floor(mouth_avg[:, 0]).long()
        size = 2 * half
        hi = self.uv_resolution - size
        y0 = torch.minimum(torch.clamp(cy - half, min=0), hi)
        x0 = torch.minimum(torch.clamp(cx - half, min=0), hi)
        return torch.stack([y0, y0 + size, x0, x0 + size], dim=1)

    def _mouth_pipeline(self, rendering_front, lm2d_front, eg3d_ws,
                        noise_mode, generator):
        with span('G.mouth_blend.crop'):
            boxes = self.gen_mouth_mask(lm2d_front)
            with span('sync.mouth_boxes'):
                boxes = boxes.tolist()
            # under force_fp32=False the crop and the paste run bf16 (JAX
            # :393-409)
            front = rendering_front if self.force_fp32 \
                else rendering_front.to(torch.bfloat16)
            crop = torch.stack([
                resample_region(img, y0, x0, y1 - y0, x1 - x0, 64, 64)
                for img, (y0, y1, x0, x1) in zip(front, boxes)])
        with span('G.mouth_blend.mouth'):
            mouths_plane = self.mouth_backbone.synthesis(
                crop, eg3d_ws, noise_mode=noise_mode, generator=generator,
                force_fp32=self.force_fp32)
        with span('G.mouth_blend.paste'):
            stitched = torch.stack([
                paste_resized_region(img, patch.to(front.dtype), y0, x0,
                                     y1 - y0, x1 - x0)
                for img, patch, (y0, y1, x0, x1)
                in zip(front, mouths_plane, boxes)])
        with span('G.mouth_blend.blend'):
            return self.neural_blending.synthesis(
                stitched, eg3d_ws, noise_mode=noise_mode,
                generator=generator, force_fp32=self.force_fp32)

    # ----------------------------------------------------------- plane build
    def _split_v(self, v):
        if v.shape[1] <= N_FLAME_VERTS:
            raise ValueError(
                f'v must be FLAME verts (+) landmarks: got {v.shape[1]} rows, '
                f'expected {N_FLAME_VERTS} verts followed by the landmarks')
        return v[:, :N_FLAME_VERTS], v[:, N_FLAME_VERTS:]

    @span('G.backbones')
    def build_identity(self, ws, noise_mode='random', generator=None):
        """The ws-only identity work: (neural texture (N, 32, R, R), static
        tri-plane (N, 3, 32, R, R)), cacheable per subject."""
        n_tex = self.texture_backbone.num_ws
        kw = dict(noise_mode=noise_mode, generator=generator,
                  force_fp32=self.force_fp32)
        textures = self.texture_backbone.synthesis(ws[:, n_tex:], **kw)
        static_plane = self.backbone.synthesis(ws[:, :n_tex], **kw)
        N = static_plane.shape[0]
        return textures, static_plane.reshape(N, 3, 32,
                                              *static_plane.shape[-2:])

    def build_planes(self, ws, v, noise_mode='random', generator=None):
        """texture -> rasterize -> mouth -> blend -> static mix."""
        textures, static_plane = self.build_identity(ws, noise_mode,
                                                     generator)
        v, lms = self._split_v(v)
        eg3d_ws = ws[:, :self.texture_backbone.num_ws]
        planes = self.mix_planes_from_identity(
            eg3d_ws, textures, static_plane, v, lms, noise_mode=noise_mode,
            generator=generator)
        return planes, eg3d_ws

    def mix_planes_from_identity(self, eg3d_ws, textures, static_plane, v,
                                 lms, noise_mode='random', generator=None):
        """Expression-dependent tail: rasterize -> mouth -> blend -> alpha
        mix, from cached identity inputs."""
        with span('G.raster'):
            images, alphas, lm2d_front = self.rasterize(v, lms, textures)
        with span('G.mouth_blend'):
            blended_front = self._mouth_pipeline(
                images[0], lm2d_front, eg3d_ws, noise_mode, generator)
        with span('G.plane_mix'):
            alpha_image = torch.stack(alphas, dim=1)   # (N, 3, 1, H, W)
            stitch = torch.cat([blended_front, images[1], images[2]], dim=1)
            stitch = stitch.reshape(static_plane.shape)
            return stitch * alpha_image + static_plane * (1 - alpha_image)

    @span('G.synthesis_from_identity')
    def synthesis_from_identity(self, ws, textures, static_plane, c, v,
                                neural_rendering_resolution=None,
                                noise_mode='random', generator=None):
        """Full synthesis with precomputed identity (textures/static plane)."""
        v, lms = self._split_v(v)
        eg3d_ws = ws[:, :self.texture_backbone.num_ws]
        planes = self.mix_planes_from_identity(
            eg3d_ws, textures, static_plane, v, lms, noise_mode=noise_mode,
            generator=generator)
        return self._render_from_planes(planes, eg3d_ws, c,
                                        neural_rendering_resolution,
                                        noise_mode, generator)

    # -------------------------------------------------------------- synthesis
    @span('G.synthesis')
    def synthesis(self, ws, c, v, neural_rendering_resolution=None,
                  noise_mode='random', generator=None):
        planes, eg3d_ws = self.build_planes(ws, v, noise_mode=noise_mode,
                                            generator=generator)
        return self._render_from_planes(planes, eg3d_ws, c,
                                        neural_rendering_resolution,
                                        noise_mode, generator)

    def _render_from_planes(self, planes, eg3d_ws, c,
                            neural_rendering_resolution, noise_mode,
                            generator):
        with span('G.render'):
            nrr = neural_rendering_resolution or \
                self.neural_rendering_resolution
            with span('G.render.rays'):
                ray_origins, ray_directions = sample_rays(
                    c[:, :16].reshape(-1, 4, 4),
                    c[:, 16:25].reshape(-1, 3, 3), nrr)
            N = ray_origins.shape[0]
            feature_samples, depth_samples, _ = self.renderer(
                planes, self.decoder, ray_origins, ray_directions,
                self.rendering_kwargs, generator=generator)
            feature_image = feature_samples.permute(0, 2, 1).reshape(
                N, feature_samples.shape[-1], nrr, nrr)
            depth_image = depth_samples.permute(0, 2, 1).reshape(
                N, 1, nrr, nrr)
            rgb_image = feature_image[:, :3]
        with span('G.sr'):
            sr_image = self.superresolution(
                rgb_image, feature_image, eg3d_ws,
                noise_mode=self.rendering_kwargs.get(
                    'superresolution_noise_mode', noise_mode),
                generator=generator, force_fp32=self.force_fp32)
        return {'image': sr_image, 'image_raw': rgb_image,
                'image_depth': depth_image}

    # ------------------------------------------------------------------ sample
    def sample_mixed(self, coordinates, directions, ws, v,
                     noise_mode='random', generator=None):
        """Density and colour at arbitrary 3D points (N, M, 3) (JAX :524):
        the planes of ``ws`` and the expression ``v``, then the decoder."""
        planes, _ = self.build_planes(ws, v, noise_mode=noise_mode,
                                      generator=generator)
        return self.sample_with_planes(planes, coordinates, directions,
                                       generator)

    def sample(self, coordinates, directions, z, c, v, truncation_psi=1,
               truncation_cutoff=None, **kwargs):
        ws = self.mapping(z, c, truncation_psi=truncation_psi,
                          truncation_cutoff=truncation_cutoff)
        return self.sample_mixed(coordinates, directions, ws, v, **kwargs)

    def sample_with_planes(self, planes, coordinates, directions,
                           generator=None):
        """Decode sigma and rgb from prebuilt planes (N, 3, 32, H, W), as
        ``build_planes`` returns them: shape extraction builds them once and
        decodes its chunks from them. ``generator`` draws the renderer's
        ``density_noise``, where that option is set."""
        return self.renderer.run_model(
            layout_for(planes, self.rendering_kwargs), self.decoder,
            coordinates, directions, self.rendering_kwargs, generator)

    # ------------------------------------------------------------------ forward
    def forward(self, z, c, v, truncation_psi=1, truncation_cutoff=None,
                neural_rendering_resolution=None, **synthesis_kwargs):
        ws = self.mapping(z, c, truncation_psi=truncation_psi,
                          truncation_cutoff=truncation_cutoff)
        return self.synthesis(
            ws, c, v, neural_rendering_resolution=neural_rendering_resolution,
            **synthesis_kwargs)


@register('TriPlaneGenerator')
@register('next3d')
def build_generator(device='cuda', **kwargs):
    """The registry's constructor: a TriPlaneGenerator on ``device``."""
    return TriPlaneGenerator(**kwargs).to(device)
