"""The vanilla EG3D tri-plane generator: no mesh, no texture.

Counterpart of next3d_tpu/models/triplane_eg3d.py (reference:
training/triplane.py): one StyleGAN2 backbone at 256^2 whose 96 channels
are reshaped to 3 planes of 32 (:70-75), the two-pass volume render and a
super-resolution head named by ``rendering_kwargs['superresolution_module']``.
The module tree uses the JAX parameter tree's names (backbone,
superresolution, decoder), so ``utils.weights.load_jax_params`` loads a
JAX tree with ``strict=True``.

Both render passes sample the planes through kernel K4
(``render/renderer.py ImportanceRenderer``), and K4's bf16 instance under
the ``gather_bf16`` rendering option, as the JAX renderer reads it.
``**synthesis_kwargs`` of ``synthesis`` (``force_fp32``,
``fused_modconv``) go to the backbone only, as in the JAX package: the SR
head runs float32. ``generator`` in the constructor seeds the parameters;
in the forward methods it drives ``noise_mode='random'`` and the
renderer's jitter (None gives the deterministic midpoints).
"""

from __future__ import annotations

import torch
from torch import nn

from ..nn import superresolution as sr_modules
from ..nn.stylegan2 import Generator as StyleGAN2Backbone
from ..render.ray_sampler import sample_rays
from ..render.renderer import ImportanceRenderer, layout_for
from ..utils.registry import register
from .osg_decoder import OSGDecoder


class EG3DTriPlaneGenerator(nn.Module):
    def __init__(self, z_dim, c_dim, w_dim, img_resolution, img_channels,
                 sr_num_fp16_res=0, mapping_kwargs=None, rendering_kwargs=None,
                 sr_kwargs=None, generator=None, **synthesis_kwargs):
        super().__init__()
        self.z_dim = z_dim
        self.c_dim = c_dim
        self.w_dim = w_dim
        self.img_resolution = img_resolution
        self.img_channels = img_channels
        self.rendering_kwargs = dict(rendering_kwargs or {})
        self.neural_rendering_resolution = 64

        self.renderer = ImportanceRenderer()
        self.backbone = StyleGAN2Backbone(
            z_dim, c_dim, w_dim, img_resolution=256, img_channels=32 * 3,
            mapping_kwargs=mapping_kwargs or {}, generator=generator,
            **synthesis_kwargs)
        sr_name = self.rendering_kwargs.get(
            'superresolution_module', 'SuperresolutionHybrid8XDC')
        self.superresolution = getattr(sr_modules, sr_name.rsplit('.', 1)[-1])(
            channels=32, img_resolution=img_resolution,
            sr_num_fp16_res=sr_num_fp16_res,
            sr_antialias=self.rendering_kwargs.get('sr_antialias', True),
            generator=generator, **(sr_kwargs or {}))
        self.decoder = OSGDecoder(
            32, {'decoder_lr_mul': self.rendering_kwargs.get(
                'decoder_lr_mul', 1), 'decoder_output_dim': 32},
            generator=generator)

    def mapping(self, z, c, truncation_psi=1, truncation_cutoff=None,
                return_w_mean=False):
        """Camera conditioning scaled by ``c_scale``, optionally zeroed
        (JAX :55-63)."""
        if self.rendering_kwargs.get('c_gen_conditioning_zero', False):
            c = torch.zeros_like(c)
        return self.backbone.mapping(
            z, c * self.rendering_kwargs.get('c_scale', 0),
            truncation_psi=truncation_psi,
            truncation_cutoff=truncation_cutoff, return_w_mean=return_w_mean)

    def build_planes(self, ws, noise_mode='random', generator=None,
                     **synthesis_kwargs):
        """The backbone's 96 channels as planes (N, 3, 32, 256, 256)."""
        planes = self.backbone.synthesis(ws, noise_mode=noise_mode,
                                         generator=generator,
                                         **synthesis_kwargs)
        return planes.reshape(planes.shape[0], 3, 32, *planes.shape[-2:])

    def synthesis(self, ws, c, neural_rendering_resolution=None,
                  noise_mode='random', generator=None, **synthesis_kwargs):
        cam2world = c[:, :16].reshape(-1, 4, 4)
        intrinsics = c[:, 16:25].reshape(-1, 3, 3)
        nrr = neural_rendering_resolution or self.neural_rendering_resolution
        ray_origins, ray_directions = sample_rays(cam2world, intrinsics, nrr)
        N = ray_origins.shape[0]

        planes = self.build_planes(ws, noise_mode=noise_mode,
                                   generator=generator, **synthesis_kwargs)
        feature_samples, depth_samples, _ = self.renderer(
            planes, self.decoder, ray_origins, ray_directions,
            self.rendering_kwargs, generator=generator)
        feature_image = feature_samples.permute(0, 2, 1).reshape(
            N, feature_samples.shape[-1], nrr, nrr)
        depth_image = depth_samples.permute(0, 2, 1).reshape(N, 1, nrr, nrr)
        rgb_image = feature_image[:, :3]
        sr_image = self.superresolution(
            rgb_image, feature_image, ws,
            noise_mode=self.rendering_kwargs.get('superresolution_noise_mode',
                                                 noise_mode),
            generator=generator)
        return {'image': sr_image, 'image_raw': rgb_image,
                'image_depth': depth_image}

    def sample_mixed(self, coordinates, directions, ws, noise_mode='random',
                     generator=None, **synthesis_kwargs):
        """Density and colour at 3D points (N, M, 3) from the planes of
        ``ws`` (JAX :97-103)."""
        planes = self.build_planes(ws, noise_mode=noise_mode,
                                   generator=generator, **synthesis_kwargs)
        return self.renderer.run_model(
            layout_for(planes, self.rendering_kwargs), self.decoder,
            coordinates, directions, self.rendering_kwargs, generator)

    def forward(self, z, c, truncation_psi=1, truncation_cutoff=None,
                **synthesis_kwargs):
        ws = self.mapping(z, c, truncation_psi=truncation_psi,
                          truncation_cutoff=truncation_cutoff)
        return self.synthesis(ws, c, **synthesis_kwargs)


@register('EG3DTriPlaneGenerator')
@register('eg3d')
def build_eg3d_generator(device='cuda', **kwargs):
    """The registry's constructor: an EG3DTriPlaneGenerator on ``device``."""
    return EG3DTriPlaneGenerator(**kwargs).to(device)
