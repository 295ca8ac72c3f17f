"""The training dataset: images, camera labels, FLAME verts and landmarks.

The port's own copy of next3d_tpu/data/dataset.py (reference:
training_avatar_texture/dataset.py:41-376): a directory or zip of images,
labels from ``dataset.json``, and per image a FLAME mesh (``.obj``, the
``images`` -> ``meshes`` path swap) and its 68 landmarks (``.txt``, the
``meshes`` -> ``lms`` swap). ``prebake()`` parses every mesh once into a
pair of memory-mapped ``.npy`` files beside the dataset; the sampler and
the batch iterator are the JAX package's.

Images are read by the port's own PNG reader (``utils/png.py``): the
machine that trains on the card has no imaging library, so a JPEG dataset
raises. The prebaked files of a ``.zip`` dataset drop its ``.zip`` suffix
(the JAX package strips the characters ``.zip`` off the name's end, which
also cuts a name ending in one of them).
"""

from __future__ import annotations

import io
import json
import os
import queue
import threading
import zipfile

import numpy as np

from ..utils.obj_io import load_lms, load_obj_verts
from ..utils.png import read_png

N_FLAME_VERTS = 5023
N_LMS = 68


class ImageFolderDataset:
    """JAX :35-206."""

    def __init__(self, path, resolution=None, use_labels=True, xflip=False,
                 max_size=None, labels_file='dataset.json', load_verts=True,
                 random_seed=0):
        self._path = path
        self._zipfile = None
        self.load_verts = load_verts
        self.labels_file = labels_file
        if os.path.isdir(path):
            self._type = 'dir'
            self._all_fnames = {
                os.path.relpath(os.path.join(root, f),
                                start=path).replace('\\', '/')
                for root, _dirs, files in os.walk(path) for f in files}
        elif path.endswith('.zip'):
            self._type = 'zip'
            self._all_fnames = set(self._get_zipfile().namelist())
        else:
            raise IOError('path must be a directory or zip')

        ext = lambda f: os.path.splitext(f)[1].lower()  # noqa: E731
        self._image_fnames = sorted(
            f for f in self._all_fnames if ext(f) in ('.png', '.jpg', '.jpeg'))
        if not self._image_fnames:
            raise IOError('no image files found')
        self._raw_labels = None
        self._use_labels = use_labels
        raw_shape = [len(self._image_fnames)] + list(
            self._load_image(0).shape)
        if resolution is not None and (raw_shape[2] != resolution or
                                       raw_shape[3] != resolution):
            raise IOError('image resolution does not match')
        self._raw_shape = raw_shape
        self._verts_cache = None
        self._lms_cache = None
        self._raw_idx = np.arange(raw_shape[0], dtype=np.int64)
        if max_size is not None and self._raw_idx.size > max_size:
            rnd = np.random.RandomState(random_seed)
            self._raw_idx = np.sort(rnd.choice(self._raw_idx, size=max_size,
                                               replace=False))
        # the xflip doubling table (reference dataset.py:64-68)
        self._xflip = np.zeros(self._raw_idx.size, dtype=np.uint8)
        if xflip:
            self._raw_idx = np.tile(self._raw_idx, 2)
            self._xflip = np.concatenate([self._xflip,
                                          np.ones_like(self._xflip)])

    # ------------------------------------------------------------------ io
    def _get_zipfile(self):
        if self._zipfile is None:
            self._zipfile = zipfile.ZipFile(self._path)
        return self._zipfile

    def _open_file(self, fname):
        if self._type == 'dir':
            return open(os.path.join(self._path, fname), 'rb')
        return self._get_zipfile().open(fname, 'r')

    def _load_image(self, raw_idx):
        fname = self._image_fnames[raw_idx]
        if not fname.lower().endswith('.png'):
            raise ValueError(f'{fname}: the port reads PNG datasets only '
                             f'(utils/png.py); convert the images to PNG')
        with self._open_file(fname) as f:
            img = read_png(f)
        if img.ndim == 2:
            img = img[:, :, np.newaxis]
        return img.transpose(2, 0, 1)  # CHW uint8

    def _load_labels(self):
        if self._raw_labels is None:
            labels = None
            if self._use_labels and self.labels_file in self._all_fnames:
                with self._open_file(self.labels_file) as f:
                    labels = json.load(f)['labels']
            if labels is None:
                self._raw_labels = np.zeros((self._raw_shape[0], 0),
                                            np.float32)
            else:
                labels = dict(labels)
                self._raw_labels = np.asarray(
                    [labels[fname.replace('\\', '/')]
                     for fname in self._image_fnames], np.float32)
        return self._raw_labels

    # ------------------------------------------------------- mesh prebaking
    def _mesh_paths(self, raw_idx):
        img = self._image_fnames[raw_idx]
        mesh = img.replace('images', 'meshes').rsplit('.', 1)[0] + '.obj'
        lms = mesh.replace('meshes', 'lms').rsplit('.', 1)[0] + '.txt'
        return mesh, lms

    def prebake_path(self):
        base = self._path.rstrip('/')
        if base.endswith('.zip'):
            base = base[:-4]
        return base + '_verts.npy', base + '_lms.npy'

    def prebake(self, force=False):
        """Parse every .obj / .txt once into memory-mapped arrays."""
        vp, lp = self.prebake_path()
        if not force and os.path.exists(vp) and os.path.exists(lp):
            return vp, lp
        n = self._raw_shape[0]
        verts = np.zeros((n, N_FLAME_VERTS, 3), np.float32)
        lms = np.zeros((n, N_LMS, 3), np.float32)
        for i in range(n):
            mp, lmp = self._mesh_paths(i)
            if self._type == 'dir':
                verts[i] = load_obj_verts(os.path.join(self._path, mp))
                lms[i] = load_lms(os.path.join(self._path, lmp))
            else:
                with self._open_file(mp) as f:
                    txt = io.TextIOWrapper(f)
                    vs = [ln.split()[1:4] for ln in txt
                          if ln.startswith('v ')]
                    verts[i] = np.asarray(vs, np.float32)
                with self._open_file(lmp) as f:
                    lms[i] = np.loadtxt(f, dtype=np.float32)
        np.save(vp, verts)
        np.save(lp, lms)
        return vp, lp

    def _get_verts(self, raw_idx):
        if not self.load_verts:
            return np.zeros((0, 3), np.float32)
        if self._verts_cache is None:
            vp, lp = self.prebake()
            self._verts_cache = np.load(vp, mmap_mode='r')
            self._lms_cache = np.load(lp, mmap_mode='r')
        return np.concatenate([np.asarray(self._verts_cache[raw_idx]),
                               np.asarray(self._lms_cache[raw_idx])], axis=0)

    # ----------------------------------------------------------------- api
    def __len__(self):
        return self._raw_idx.size

    @property
    def label_dim(self):
        return self._load_labels().shape[1]

    @property
    def resolution(self):
        return self._raw_shape[2]

    def get_label(self, idx):
        return self._load_labels()[self._raw_idx[idx]].copy()

    def get_label_std(self):
        return self._load_labels().std(0)

    def sample_conditioning(self, rnd, n):
        """n (label, verts) pairs drawn uniformly from the whole dataset
        with the host RandomState ``rnd`` (reference training_loop.py
        :324-333)."""
        idx = rnd.randint(len(self), size=n)
        c = np.stack([self.get_label(int(i)) for i in idx])
        v = np.stack([self._get_verts(self._raw_idx[int(i)]) for i in idx])
        return c.astype(np.float32), v.astype(np.float32)

    def __getitem__(self, idx):
        raw_idx = self._raw_idx[idx]
        img = self._load_image(raw_idx)
        label = self.get_label(idx)
        verts = self._get_verts(raw_idx)
        if self._xflip[idx]:
            # the reference flips only the image (dataset.py:127-130)
            img = img[:, :, ::-1].copy()
        return img, label, verts


class InfiniteSampler:
    """Strided infinite shuffled index stream (JAX :209-238)."""

    def __init__(self, dataset_size, rank=0, num_replicas=1, shuffle=True,
                 seed=0, window_size=0.5):
        self.dataset_size = dataset_size
        self.rank = rank
        self.num_replicas = num_replicas
        self.shuffle = shuffle
        self.seed = seed
        self.window_size = window_size

    def __iter__(self):
        order = np.arange(self.dataset_size)
        rnd = None
        window = 0
        if self.shuffle:
            rnd = np.random.RandomState(self.seed)
            rnd.shuffle(order)
            window = int(np.rint(order.size * self.window_size))
        idx = 0
        while True:
            i = idx % order.size
            if idx % self.num_replicas == self.rank:
                yield order[i]
            if window >= 2:
                j = (i - rnd.randint(window)) % order.size
                order[i], order[j] = order[j], order[i]
            idx += 1


def _batch_iterator(dataset, batch_size_per_host, rank, num_replicas, seed,
                    to_float, start):
    sampler = iter(InfiniteSampler(len(dataset), rank=rank,
                                   num_replicas=num_replicas, seed=seed))
    for _ in range(start):
        next(sampler)
    while True:
        imgs, labels, verts = [], [], []
        for _ in range(batch_size_per_host):
            img, label, v = dataset[int(next(sampler))]
            imgs.append(img)
            labels.append(label)
            verts.append(v)
        img = np.stack(imgs).astype(np.float32)
        if to_float:
            img = img / 127.5 - 1.0
        yield {'image': img,
               'c': np.stack(labels).astype(np.float32),
               'v': np.stack(verts).astype(np.float32)}


class PrefetchIterator:
    """Batches assembled ahead on a background thread (JAX :261-299);
    ``depth`` is the queue's capacity, ``close()`` stops the thread."""

    def __init__(self, it, depth=3):
        self._q = queue.Queue(maxsize=depth)
        self._stop = threading.Event()

        def run():
            for item in it:
                while not self._stop.is_set():
                    try:
                        self._q.put(item, timeout=0.5)
                        break
                    except queue.Full:
                        continue
                if self._stop.is_set():
                    return

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def __iter__(self):
        return self

    def __next__(self):
        return self._q.get()

    def close(self):
        self._stop.set()

    def __del__(self):
        self.close()


def make_data_iterator(dataset, batch_size_per_host, rank=0, num_replicas=1,
                       seed=0, to_float=True, prefetch=3, start=0):
    """Host batches: dict(image (B, C, H, W) float in [-1, 1], c (B, 25),
    v (B, 5091, 3)) (JAX :302-310). ``start`` skips that many indices of
    the sampler first (their images are not read), so that a resumed run
    continues the stream where its snapshot left it."""
    it = _batch_iterator(dataset, batch_size_per_host, rank, num_replicas,
                         seed, to_float, start)
    if prefetch and prefetch > 0:
        return PrefetchIterator(it, depth=prefetch)
    return it
