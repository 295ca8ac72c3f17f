"""Helpers shared by the CLIs: the generator from a snapshot's kwargs, the
camera label, the demo mesh, image grids and seed ranges.

Counterpart of next3d_tpu/cli/common.py. Images are written by
``utils/png.py``; the CLIs import neither click nor an imaging library.
"""

from __future__ import annotations

import contextlib
import math
import os
import re

import numpy as np
import torch

from ..utils.png import write_png

# the JAX commands' defaults: the demo FLAME mesh and landmarks in the
# data/demo directory of the reference checkout
_DEMO = os.path.join(os.sep, 'root', 'reference', 'data', 'demo')
DEMO_OBJ = os.path.join(_DEMO, 'demo.obj')
DEMO_LMS = os.path.join(_DEMO, 'demo_kpt2d.txt')

# default ffhq rendering config (reference train_next3d.py:330-339)
FFHQ_RENDERING_KWARGS = dict(
    image_resolution=512,
    disparity_space_sampling=False,
    clamp_mode='softplus',
    superresolution_module='SuperresolutionHybrid8XDC',
    c_gen_conditioning_zero=False,
    gpc_reg_prob=0.5,
    c_scale=1.0,
    superresolution_noise_mode='none',
    density_reg=0.25,
    density_reg_p_dist=0.004,
    reg_type='l1',
    decoder_lr_mul=1.0,
    sr_antialias=True,
    depth_resolution=48,
    depth_resolution_importance=48,
    ray_start=2.25,
    ray_end=3.3,
    box_warp=1.0,
    avg_camera_radius=2.7,
    avg_camera_pivot=[0, 0, 0.2],
)


# per-dataset rendering blocks (reference train_next3d.py:330-360); ffhq's
# values live in FFHQ_RENDERING_KWARGS above
CFG_RENDERING_BLOCKS = {
    'ffhq': dict(
        depth_resolution=48, depth_resolution_importance=48,
        ray_start=2.25, ray_end=3.3, box_warp=1.0,
        avg_camera_radius=2.7, avg_camera_pivot=[0, 0, 0.2]),
    'afhq': dict(
        depth_resolution=36, depth_resolution_importance=36,
        ray_start=2.25, ray_end=3.3, box_warp=1.0,
        avg_camera_radius=2.7, avg_camera_pivot=[0, 0, -0.06]),
    'shapenet': dict(
        depth_resolution=64, depth_resolution_importance=64,
        ray_start=0.1, ray_end=2.6, box_warp=1.6, white_back=True,
        avg_camera_radius=1.7, avg_camera_pivot=[0, 0, 0]),
}

# sr_kwargs that the JAX package's super-resolution heads take and ignore
# (next3d_tpu/nn/superresolution.py) or that change nothing in the port
# (fused_modconv_default: the port's modulation is unfused, equal in
# float32); the port's heads pass every other key to their blocks
_SR_IGNORED = ('num_fp16_res', 'conv_clamp', 'channel_base', 'channel_max',
               'fused_modconv_default')


def build_generator_from_kwargs(init_kwargs, topology_path,
                                uv_face_eye_mask_path=None, device='cuda'):
    """The port's TriPlaneGenerator, in eval mode on ``device``, from the
    construction kwargs a snapshot stores (the reference's init_kwargs or
    the JAX package's G_kwargs). Its weights are a random init: load a
    snapshot's params into it with ``utils.weights.load_jax_params``."""
    from ..models.triplane_next3d import TriPlaneGenerator

    kw = dict(init_kwargs or {})
    kw.pop('class_name', None)
    kw.setdefault('z_dim', 512)
    kw.setdefault('c_dim', 25)
    kw.setdefault('w_dim', 512)
    kw.setdefault('img_resolution', 512)
    kw.setdefault('img_channels', 3)
    rendering = dict(FFHQ_RENDERING_KWARGS)
    rendering.update(kw.pop('rendering_kwargs', {}) or {})
    # strip torch-only knobs
    for k in ('channel_base', 'channel_max', 'fused_modconv_default',
              'num_fp16_res', 'conv_clamp'):
        kw.setdefault(k, None)
        if kw[k] is None:
            kw.pop(k)
    kw.pop('topology_path', None)
    allowed = ('z_dim', 'c_dim', 'w_dim', 'img_resolution', 'img_channels',
               'sr_num_fp16_res', 'mapping_kwargs', 'sr_kwargs',
               'channel_base', 'channel_max', 'plane_resolution',
               'rasterizer_patch', 'rasterizer_face_chunk')
    kw = {k: v for k, v in kw.items() if k in allowed}
    if kw.get('sr_kwargs'):
        kw['sr_kwargs'] = {k: v for k, v in kw['sr_kwargs'].items()
                           if k not in _SR_IGNORED}
    G = TriPlaneGenerator(topology_path=topology_path,
                          uv_face_eye_mask_path=uv_face_eye_mask_path,
                          rendering_kwargs=rendering, **kw)
    return G.to(device).eval()


@contextlib.contextmanager
def float32_math():
    """float32 matmuls and convolutions without TF32 (the JAX package runs
    float32 at HIGHEST precision), for the duration of a CLI call."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


@contextlib.contextmanager
def inference():
    """``float32_math`` without autograd, for an inference command."""
    with float32_math(), torch.no_grad():
        yield


def camera_label(yaw, pitch, lookat=(0, 0, 0.2), radius=2.7, fov=18.837):
    """25-dim camera label (16 cam2world + 9 intrinsics), (1, 25) float32."""
    from ..render import camera_utils
    cam = camera_utils.lookat_pose(math.pi / 2 + yaw, math.pi / 2 + pitch,
                                   lookat, radius=radius, device='cpu')
    K = camera_utils.fov_to_intrinsics(fov)
    return np.concatenate([cam.numpy().reshape(1, 16),
                           K.reshape(1, 9)], axis=1).astype(np.float32)


def load_demo_verts(obj_path, lms_path):
    """(1, V + 68, 3) float32: a mesh's vertices, then its landmarks."""
    from ..utils.obj_io import load_lms, load_obj_verts
    verts = load_obj_verts(obj_path)
    lms = load_lms(lms_path)
    return np.concatenate([verts, lms], axis=0)[None].astype(np.float32)


def save_image_grid(img, path, drange=(-1, 1), grid_size=None):
    """uint8 PNG from (N, C, H, W) float images (reference training_loop
    save_image_grid behavior)."""
    lo, hi = drange
    img = np.asarray(img, dtype=np.float32)
    img = (img - lo) * (255 / (hi - lo))
    img = np.rint(img).clip(0, 255).astype(np.uint8)
    N, C, H, W = img.shape
    if grid_size is None:
        gw = int(np.ceil(np.sqrt(N)))
        gh = int(np.ceil(N / gw))
    else:
        gw, gh = grid_size
    canvas = np.zeros((C, gh * H, gw * W), np.uint8)
    for i in range(N):
        y, x = divmod(i, gw)
        canvas[:, y * H:(y + 1) * H, x * W:(x + 1) * W] = img[i]
    canvas = canvas.transpose(1, 2, 0)
    if C == 1:
        canvas = canvas[:, :, 0]
    write_png(path, canvas)


def parse_range(s) -> list:
    """'1,2,5-7' -> [1, 2, 5, 6, 7] (reference gen_samples_next3d.py)."""
    if isinstance(s, (list, tuple)):
        return list(s)
    out = []
    for p in str(s).split(','):
        m = re.match(r'^(\d+)-(\d+)$', p)
        if m:
            out.extend(range(int(m.group(1)), int(m.group(2)) + 1))
        else:
            out.append(int(p))
    return out


def load_generator(network_path, topology_path, device):
    """The generator of a checkpoint (a format-1 snapshot or a reference
    .pkl, ``utils/checkpoint.py read_generator``), its weights loaded, on
    ``device``. A reference .pkl's entries that the port's generator does
    not have are dropped and named; a missing one raises."""
    from ..utils.checkpoint import read_generator
    from ..utils.weights import load_jax_params
    params, init_kwargs, source = read_generator(network_path)
    G = build_generator_from_kwargs(init_kwargs, topology_path,
                                    device=device)
    return load_jax_params(G, params,
                           drop_unexpected=source == 'reference')


def frame_uint8(img):
    """(3, H, W) images in [-1, 1] on any device -> (H, W, 3) uint8 numpy,
    clipped and truncated as the JAX CLIs do."""
    return ((img.permute(1, 2, 0) + 1) * 127.5).clamp(0, 255).to(
        torch.uint8).cpu().numpy()


def synchronize(device):
    if torch.device(device).type == 'cuda':
        torch.cuda.synchronize(device)
