"""The one generator of every traffic mix: a cell's inputs from its seed.

A mix is a JSON file under ``benchmark/traffic/``; this module reads its
parameters and makes the inputs of each unit of work (a batch, a frame, a
training step) on the device, each unit from its own generator seeded by
(seed, unit), so that the same seed gives the same inputs in every run
and the reference can make unit i again without making the units before
it. The sizes never depend on the seed: only the values do.

Parameters (all optional but ``kind`` and ``batch``):

  kind                 the module under ``benchmark/kinds/`` that runs it
  batch                images a unit
  truncation_psi, truncation_cutoff, noise_mode
  camera               {"radius", "lookat", "fov_deg"}: the FFHQ camera
  orbit                {"yaw", "pitch"}: half-ranges in radians about the
                       frontal pose; "walk": "uniform" draws each image's
                       pose, "loop" moves it along a closed orbit
  expression           {"amplitude", "walk"}: each vertex and landmark of
                       the head moved by amplitude times a normal draw
                       ("iid" a unit), or along a closed smooth loop
                       ("loop": two harmonics a vertex, their amplitudes
                       and phases drawn once, the same for every seed)
  loop                 the loop's length in units; a seed starts at its own
                       point of the loop, so that every seed's run goes
                       through the same poses and expressions, and so the
                       same work, in another order
  real                 training's real images: "uniform" in [-1, 1]
"""

from __future__ import annotations

import hashlib
import math

import numpy as np
import torch

from .head import synthetic_head

FRONTAL = (math.pi / 2, math.pi / 2)


def subseed(seed, *tags):
    """A 63-bit seed for (seed, tags): the same for the same arguments,
    unrelated for different ones; ``seed`` may be any integer."""
    key = repr((int(seed),) + tuple(tags)).encode()
    return int.from_bytes(hashlib.blake2b(key, digest_size=8).digest(),
                          'little') >> 1


def generator(seed, *tags, device):
    return torch.Generator(device=device).manual_seed(subseed(seed, *tags))


def _normalize(v):
    return v / torch.linalg.norm(v, dim=-1, keepdim=True)


def cam2world(yaw, pitch, radius, lookat):
    """(n, 4, 4) cam2world on a y-up sphere of ``radius`` looking at
    ``lookat``, for yaw and pitch (n,) in radians (the LookAtPoseSampler
    of the Next3D and EG3D repositories, camera_utils.py:58-86, 118-137)."""
    h = yaw[:, None]
    v = pitch[:, None].clamp(1e-5, math.pi - 1e-5)
    phi = torch.arccos(1 - 2 * (v / math.pi))
    origin = torch.cat([radius * torch.sin(phi) * torch.cos(math.pi - h),
                        radius * torch.cos(phi),
                        radius * torch.sin(phi) * torch.sin(math.pi - h)],
                       dim=1)
    target = torch.as_tensor(lookat, dtype=torch.float32,
                             device=yaw.device).expand_as(origin)
    forward = _normalize(target - origin)
    up = torch.tensor([0., 1., 0.], device=yaw.device).expand_as(forward)
    right = -_normalize(torch.cross(up, forward, dim=-1))
    up = _normalize(torch.cross(forward, right, dim=-1))
    n = yaw.shape[0]
    eye = torch.eye(4, device=yaw.device)
    rotation = eye.repeat(n, 1, 1)
    rotation[:, :3, :3] = torch.stack([right, up, forward], dim=-1)
    translation = eye.repeat(n, 1, 1)
    translation[:, :3, 3] = origin
    return translation @ rotation


def intrinsics(fov_deg):
    """Normalized 3 x 3 intrinsics of the FOV (camera_utils.py:140-149)."""
    f = float(1 / (math.tan(fov_deg * 3.14159 / 360) * 1.414))
    return [[f, 0, 0.5], [0, f, 0.5], [0, 0, 1]]


class Traffic:
    """The inputs of one cell and seed, on ``device``."""

    def __init__(self, params, seed, device):
        self.p = params
        self.seed = seed
        self.device = device
        self.batch = params['batch']
        mesh, lms = synthetic_head()
        self.mesh = mesh
        # (verts + landmarks, 3): the rows that the generators take as v
        self.head = torch.from_numpy(np.concatenate(
            [mesh.verts, lms])).to(device)
        cam = params.get('camera', {})
        self.radius = cam.get('radius', 2.7)
        self.lookat = cam.get('lookat', [0.0, 0.0, 0.2])
        self.K = torch.tensor(intrinsics(cam.get('fov_deg', 18.837)),
                              device=device).reshape(1, 9)
        if 'loop' in params:
            g = generator(0, 'loop', device=device)
            shape = (2,) + tuple(self.head.shape)
            self.expr_amp = torch.randn(shape, generator=g, device=device)
            self.expr_phase = torch.rand(shape, generator=g,
                                         device=device) * 2 * math.pi
            self.start = subseed(seed, 'start') % params['loop']

    def camera(self, yaw, pitch):
        """(n, 25): cam2world (16) then intrinsics (9), float32."""
        pose = cam2world(FRONTAL[0] + yaw, FRONTAL[1] + pitch, self.radius,
                         self.lookat)
        return torch.cat([pose.reshape(-1, 16),
                          self.K.expand(pose.shape[0], 9)], dim=1)

    def frontal(self, n):
        zero = torch.zeros(n, device=self.device)
        return self.camera(zero, zero)

    def _poses(self, i, n, g):
        orbit = self.p.get('orbit', {})
        yaw, pitch = orbit.get('yaw', 0.0), orbit.get('pitch', 0.0)
        if orbit.get('walk') == 'loop':
            t = self._angle(i)
            return self.camera(torch.full((n,), yaw * math.sin(t),
                                          device=self.device),
                               torch.full((n,), pitch * math.cos(t),
                                          device=self.device))
        u = torch.rand((2, n), generator=g, device=self.device) * 2 - 1
        return self.camera(u[0] * yaw, u[1] * pitch)

    def _expressions(self, i, n, g):
        expr = self.p.get('expression', {})
        amp = expr.get('amplitude', 0.0)
        if expr.get('walk') == 'loop':
            t = self._angle(i)
            w = torch.tensor([t, 2 * t], device=self.device).reshape(2, 1, 1)
            e = (self.expr_amp * torch.sin(w + self.expr_phase)).sum(0)
            return (self.head + amp / math.sqrt(2) * e).expand(n, -1, -1)
        return self.head + amp * torch.randn(
            (n,) + tuple(self.head.shape), generator=g, device=self.device)

    def _angle(self, i):
        """Unit i's angle on the loop, from the seed's starting point."""
        return 2 * math.pi * ((self.start + i) % self.p['loop']) \
            / self.p['loop']

    def unit(self, i):
        """Unit i's inputs: z (n, 512), c_cond (the frontal camera), c (the
        render or label camera), v (n, verts + landmarks, 3); with
        ``real``, real images (n, 3, R, R) too."""
        n = self.batch
        g = generator(self.seed, 'unit', i, device=self.device)
        z = torch.randn((n, self.p.get('z_dim', 512)), generator=g,
                        device=self.device)
        out = dict(z=z, c_cond=self.frontal(n), c=self._poses(i, n, g),
                   v=self._expressions(i, n, g))
        if self.p.get('real') == 'uniform':
            R = self.p['resolution']
            out['real'] = torch.rand((n, 3, R, R), generator=g,
                                     device=self.device) * 2 - 1
        return out

    def identity(self):
        """The one identity of a reenactment: z (n, 512) and the frontal
        conditioning camera."""
        g = generator(self.seed, 'identity', device=self.device)
        n = self.batch
        return (torch.randn((n, self.p.get('z_dim', 512)), generator=g,
                            device=self.device), self.frontal(n))
