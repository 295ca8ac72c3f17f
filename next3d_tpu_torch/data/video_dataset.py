"""The video-clip dataset: a directory of clips, each a directory of frames.

The port's own copy of next3d_tpu/data/video_dataset.py (reference:
training_avatar_texture/dataset.py:378-584 and the temporal sampler of
dataset_tool.py:458-516). An item is a clip of ``num_frames`` frames drawn
by ``sample_frames``: their images (T, C, H, W) uint8, labels (T, L) from
``dataset.json`` (keyed ``'<clip>/<frame>'``) and FLAME verts with
landmarks (T, 5091, 3), each frame's mesh found by the images -> meshes
path swap and its landmarks by the meshes -> lms swap. The train loop's
batches stack items, so a batch carries a T axis after the batch axis
(``data/dataset.py make_data_iterator``); the loss flattens it into frames.

Images are read by the port's PNG reader (``utils/png.py``), as the image
dataset's are; the frame draws of ``__getitem__`` come from the dataset's
own RandomState, in the order items are read.
"""

from __future__ import annotations

import json
import os

import numpy as np

from ..utils.obj_io import load_lms, load_obj_verts
from ..utils.png import read_png


def sample_frames(num_available, num_frames=1, sampling='random',
                  max_frame_dist=30, rng=None):
    """Frame indices of a clip of ``num_available`` frames (JAX :21-41):
    'random', sorted distinct frames of a random window of up to
    ``max_frame_dist``; 'uniform', evenly spaced over such a window;
    'consecutive', adjacent frames."""
    rng = rng or np.random
    if num_frames == 1:
        return np.array([rng.randint(num_available)])
    if sampling == 'consecutive':
        start = rng.randint(max(num_available - num_frames + 1, 1))
        return np.arange(start, start + num_frames) % num_available
    window = min(max_frame_dist, num_available)
    start = rng.randint(max(num_available - window + 1, 1))
    if sampling == 'uniform':
        offs = np.linspace(0, window - 1, num_frames).astype(np.int64)
    else:
        offs = np.sort(rng.choice(window, size=num_frames, replace=False)) \
            if window >= num_frames else np.arange(num_frames) % window
    return start + offs


class VideoFramesFolderDataset:
    """``root/<clip>/<frame>.png`` with labels in ``root/dataset.json``
    (JAX :44-163)."""

    def __init__(self, path, resolution=None, num_frames=1, sampling='random',
                 max_frame_dist=30, max_num_frames=None, use_labels=True,
                 load_verts=True, labels_file='dataset.json', seed=0):
        self._path = path
        self.num_frames = num_frames
        self.sampling = sampling
        self.max_frame_dist = max_frame_dist
        # the frames of a clip that are used (reference training_loop.py
        # :323, min(get_video_len(i), max_num_frames))
        self.max_num_frames = max_num_frames
        self.load_verts = load_verts
        self._rng = np.random.RandomState(seed)

        labels = {}
        jpath = os.path.join(path, labels_file)
        if use_labels and os.path.exists(jpath):
            with open(jpath) as f:
                labels = dict(json.load(f)['labels'])
        self._labels = labels

        self._clips = []
        for clip in sorted(os.listdir(path)):
            cdir = os.path.join(path, clip)
            if not os.path.isdir(cdir) or clip.startswith(('meshes', 'lms')):
                continue
            frames = sorted(f for f in os.listdir(cdir)
                            if f.lower().endswith(('.png', '.jpg', '.jpeg')))
            if frames:
                self._clips.append((clip, frames))
        if not self._clips:
            raise IOError(f'no clips under {path}')
        if resolution is None:
            clip0, frames0 = self._clips[0]
            resolution = self._read_image(os.path.join(path, clip0,
                                                       frames0[0])).shape[1]
        self.resolution = resolution

    def __len__(self):
        return len(self._clips)

    def _clip_len(self, idx):
        n = len(self._clips[idx][1])
        return min(n, self.max_num_frames) if self.max_num_frames else n

    @property
    def label_dim(self):
        if not self._labels:
            return 0
        return len(next(iter(self._labels.values())))

    @staticmethod
    def _read_image(path):
        if not path.lower().endswith('.png'):
            raise ValueError(f'{path}: the port reads PNG frames only '
                             f'(utils/png.py); convert the frames to PNG')
        with open(path, 'rb') as f:
            img = read_png(f)
        return img[:, :, None] if img.ndim == 2 else img

    def _frame_paths(self, clip, frame):
        img = os.path.join(self._path, clip, frame)
        stem = os.path.splitext(frame)[0]
        mesh = os.path.join(self._path, clip.replace('images', 'meshes'),
                            stem + '.obj')
        if not os.path.exists(mesh):
            mesh = os.path.join(self._path, 'meshes', clip, stem + '.obj')
        lms = mesh.replace('meshes', 'lms').replace('.obj', '.txt')
        return img, mesh, lms

    def get_label_std(self):
        if not self._labels:
            return np.zeros((0,), np.float32)
        return np.asarray(list(self._labels.values()), np.float32).std(0)

    def _load_frames(self, idx, sel, load_images=True):
        """(T, C, H, W) uint8 images (None without ``load_images``), (T, L)
        labels and (T, 5091, 3) verts with landmarks of the frames ``sel``
        of clip ``idx``."""
        clip, frames = self._clips[idx]
        imgs, labels, verts = [], [], []
        for fi in sel:
            frame = frames[int(fi)]
            ipath, mpath, lpath = self._frame_paths(clip, frame)
            if load_images:
                imgs.append(self._read_image(ipath).transpose(2, 0, 1))
            labels.append(np.asarray(self._labels.get(f'{clip}/{frame}', []),
                                     np.float32))
            if self.load_verts:
                verts.append(np.concatenate([load_obj_verts(mpath),
                                             load_lms(lpath)], 0))
        out_v = np.stack(verts) if verts else np.zeros((len(sel), 0, 3),
                                                       np.float32)
        out_i = np.stack(imgs) if imgs else None
        return out_i, np.stack(labels), out_v

    def sample_conditioning(self, rnd, n):
        """``n`` draws of the generator's conditioning with the host
        RandomState ``rnd``, each a random clip and its frames (reference
        training_loop.py:323-333): c (n, T, L), v (n, T, 5091, 3)."""
        cs, vs = [], []
        for _ in range(n):
            idx = rnd.randint(len(self))
            sel = sample_frames(self._clip_len(idx), self.num_frames,
                                self.sampling, self.max_frame_dist, rng=rnd)
            _, c, v = self._load_frames(idx, sel, load_images=False)
            cs.append(c)
            vs.append(v)
        return (np.stack(cs).astype(np.float32),
                np.stack(vs).astype(np.float32))

    def __getitem__(self, idx):
        sel = sample_frames(self._clip_len(idx), self.num_frames,
                            self.sampling, self.max_frame_dist,
                            rng=self._rng)
        return self._load_frames(idx, sel)
