"""The texture variant: texture and static backbones, no mouth, no landmarks.

Counterpart of next3d_tpu/models/triplane_texture.py (reference:
training_avatar_texture/triplane.py, the generator when --model_version is
unset). ``rasterize_orth`` projects the textured FLAME mesh into 4 fixed
orthographic views with a z-180 roll and no y-flip, rasterizes them through
``rasterize_with_attributes`` (K2 and the barycentric interpolation by
default), samples the eye mask and the neural texture at the interpolated
(u, v), and sums the two side views. As in the reference's 'debug' block,
only the front view's alpha is kept, so only the front view's texture
reaches the planes. There is no ``fill_mouth``, no mouth StyleUNet and no
neural blending, so ``load_jax_params(strict=True)`` takes the JAX
variant's parameter tree as it is.
"""

from __future__ import annotations

import torch

from ..ops.grid_sample import grid_sample_2d
from ..render.mesh import angle2matrix, batch_orth_proj
from ..render.rasterizer import rasterize_with_attributes
from ..utils.registry import register
from .triplane_next3d import N_FLAME_VERTS, TriPlaneGenerator

ORTH_VIEWS = ((0, 0, 180), (90, 0, 180), (0, 90, 180), (0, -90, 180))


class TriPlaneTextureGenerator(TriPlaneGenerator):
    """The flagship's construction and rendering with the texture variant's
    plane build. ``v`` is the FLAME vertices, (N, 5023, 3), or the
    vertices followed by rows that no face indexes, such as the 68
    landmarks of a training dataset's items (N, 5091, 3): the variant uses
    the first 5023 rows, as the reference's rasterizer does. (The JAX
    variant reshapes ``v`` to 5023 rows and so raises on a dataset's
    items: ROADMAP.md Queue 3.)"""

    blends_mouth = False

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.register_buffer('view_tforms_orth', torch.cat(
            [angle2matrix([v]) for v in ORTH_VIEWS]), persistent=False)
        uvcoords = self.face_uv.new_ones(self.face_uv.shape[:-1] + (1,))
        self.register_buffer('face_uvcoords', torch.cat(
            [self.face_uv, uvcoords], dim=-1), persistent=False)

    def _split_v(self, v):
        if v.shape[1] < N_FLAME_VERTS:
            raise ValueError(f'v must hold the {N_FLAME_VERTS} FLAME verts, '
                             f'got {v.shape[1]} rows')
        return v[:, :N_FLAME_VERTS], None

    def project_orth(self, v):
        """Orthographic projection of verts (N, 5023, 3) through the 4
        views, view-major: the rasterizer input (V*N, 5023, 3)."""
        V = len(ORTH_VIEWS)
        tv = torch.einsum('vnpc,vcd->vnpd', v[None].expand(V, -1, -1, -1),
                          self.view_tforms_orth)
        tv = (tv + self.orth_shift) * self.orth_scale
        tv = batch_orth_proj(tv.reshape(V * v.shape[0], N_FLAME_VERTS, 3),
                             torch.tensor([1., 0., 0.]))
        return torch.cat([tv[..., :1], -tv[..., 1:2], 10.0 - tv[..., 2:]], -1)

    def rasterize_orth(self, v, textures):
        """reference triplane.py:154-180 (JAX :44-88). Returns the
        [front, top, side-sum] feature images (N, 96, R, R) and their alphas
        (N, 3, R, R), the top and side alphas zero."""
        N = v.shape[0]
        V = len(ORTH_VIEWS)
        res = self.uv_resolution
        rendering = rasterize_with_attributes(
            self.project_orth(v), self.faces, self.face_uvcoords[None], res,
            patch=self.rasterizer_patch,
            impl=self.rasterizer_impl)                  # (V*N, 4, R, R)
        alpha = rendering[:, -1:].detach()
        # the texture grid keeps its gradient (reference triplane.py:168);
        # the eye mask is sampled at the same grid without one. The views
        # fold into the grid, so the texture and the mask are shared by all
        # views of a sample.
        grid = rendering[:, :2].permute(0, 2, 3, 1)
        grid_vn = grid.reshape(V, N, res, res, 2).transpose(0, 1).reshape(
            N, V * res, res, 2)
        table = torch.cat([textures, self.uv_face_mask.expand(
            N, 1, res, res)], dim=1)
        sampled = grid_sample_2d(table, grid_vn)        # (N, C + 1, V*R, R)
        sampled = sampled.reshape(N, -1, V, res, res).permute(2, 0, 1, 3, 4)
        rendering_image = sampled[:, :, :-1]            # (V, N, C, R, R)
        alpha = sampled[:, :, -1:].detach() * alpha.reshape(V, N, 1, res, res)

        renderings = torch.cat([rendering_image[0], rendering_image[1],
                                rendering_image[2] + rendering_image[3]],
                               dim=1)
        # the reference's 'debug' block: only the front view's alpha
        alphas = torch.cat([alpha[0], torch.zeros_like(alpha[1]),
                            torch.zeros_like(alpha[1])], dim=1)
        return renderings, alphas

    def mix_planes_from_identity(self, eg3d_ws, textures, static_plane, v,
                                 lms=None, noise_mode='random',
                                 generator=None):
        """rasterize_orth -> alpha mix with the static tri-plane (JAX
        build_planes :90-106); ``lms``, ``noise_mode`` and ``generator`` are
        unused."""
        renderings, alphas = self.rasterize_orth(v, textures)
        renderings = renderings.reshape(static_plane.shape)
        alphas = alphas[:, :, None]                     # (N, 3, 1, R, R)
        return renderings * alphas + static_plane * (1 - alphas)


@register('TriPlaneTextureGenerator')
@register('avatar_texture')
def build_texture_generator(device='cuda', **kwargs):
    """The registry's constructor: a TriPlaneTextureGenerator on
    ``device``."""
    return TriPlaneTextureGenerator(**kwargs).to(device)
