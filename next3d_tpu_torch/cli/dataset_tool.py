"""Dataset packer (reference: dataset_tool.py:218-521).

Counterpart of next3d_tpu/cli/dataset_tool.py: the same conversion, a
host-only tool (numpy, PIL, zipfile; no tensor). ``cli/main.py``
registers it as ``dataset-tool`` with the JAX command's options; PIL is
imported where an image is read or written.

Converts input datasets into the training layout and pre-bakes the
mesh/landmark arrays (the TPU input pipeline never parses text at train
time — SURVEY section 7.3 step 8).

Sources: an images(+meshes/lms) folder tree, a .zip of the same, a
CIFAR-10 `cifar-10-python.tar.gz`/batch folder, an MNIST idx pair
(reference :255-327), or an LSUN LMDB environment (reference :270-292)
read by the vendored pure-Python parser in `data/lmdb_reader.py` (no
`lmdb` wheel in this environment).
Transforms: scale (default), center-crop, center-crop-wide
(reference make_transform :218-259). Output: a folder or .zip.
"""

from __future__ import annotations

import io
import json
import os
import shutil
import zipfile

import numpy as np


def make_transform(transform, output_width, output_height):
    """reference dataset_tool.py:218-259."""
    from PIL import Image

    def scale(img):
        h, w = img.shape[:2]
        ww = output_width or w
        hh = output_height or h
        if (ww, hh) == (w, h):
            return img
        return np.array(Image.fromarray(img).resize((ww, hh), Image.LANCZOS))

    def center_crop(img):
        crop = np.min(img.shape[:2])
        img = img[(img.shape[0] - crop) // 2:(img.shape[0] + crop) // 2,
                  (img.shape[1] - crop) // 2:(img.shape[1] + crop) // 2]
        return np.array(Image.fromarray(img, 'RGB').resize(
            (output_width, output_height), Image.LANCZOS))

    def center_crop_wide(img):
        ch = int(np.round(output_width * img.shape[0] / img.shape[1]))
        if img.shape[1] < output_width or ch < output_height:
            return None
        img = img[(img.shape[0] - ch) // 2:(img.shape[0] + ch) // 2]
        img = np.array(Image.fromarray(img, 'RGB').resize(
            (output_width, output_height), Image.LANCZOS))
        canvas = np.zeros([output_width, output_width, 3], np.uint8)
        canvas[(output_width - output_height) // 2:
               (output_width + output_height) // 2, :] = img
        return canvas

    if transform is None:
        return scale
    if transform == 'center-crop':
        assert output_width and output_height, \
            'must specify --resolution=N for center-crop'
        return center_crop
    if transform == 'center-crop-wide':
        assert output_width and output_height
        return center_crop_wide
    raise ValueError(f'unknown transform {transform}')


class _Writer:
    """Folder or zip destination."""

    def __init__(self, dest):
        self.is_zip = dest.endswith('.zip')
        self.dest = dest
        if self.is_zip:
            os.makedirs(os.path.dirname(dest) or '.', exist_ok=True)
            self.zf = zipfile.ZipFile(dest, 'w', zipfile.ZIP_STORED)
        else:
            os.makedirs(dest, exist_ok=True)

    def write_bytes(self, rel, data):
        if self.is_zip:
            self.zf.writestr(rel, data)
        else:
            path = os.path.join(self.dest, rel)
            os.makedirs(os.path.dirname(path) or self.dest, exist_ok=True)
            with open(path, 'wb') as f:
                f.write(data)

    def write_image(self, rel, img_array):
        from PIL import Image
        buf = io.BytesIO()
        Image.fromarray(img_array).save(buf, format='png')
        self.write_bytes(rel, buf.getvalue())

    def close(self):
        if self.is_zip:
            self.zf.close()


def _iter_cifar10(source):
    """CIFAR-10 python batches -> (img array, label) (reference :300-315)."""
    import pickle
    import tarfile
    batches = []
    if source.endswith('.tar.gz'):
        with tarfile.open(source) as tf:
            for m in sorted(tf.getnames()):
                if 'data_batch' in m:
                    batches.append(pickle.load(tf.extractfile(m),
                                               encoding='latin1'))
    else:
        for name in sorted(os.listdir(source)):
            if name.startswith('data_batch'):
                with open(os.path.join(source, name), 'rb') as f:
                    batches.append(pickle.load(f, encoding='latin1'))
    assert batches, f'no data_batch files under {source}'
    for b in batches:
        imgs = np.asarray(b['data'], np.uint8).reshape(-1, 3, 32, 32)
        for img, lab in zip(imgs, b['labels']):
            yield img.transpose(1, 2, 0), int(lab)


def _iter_mnist(source):
    """MNIST idx images+labels (reference :318-327). source: images idx
    file; labels file alongside with 'labels' in the name or t10k/train
    naming convention."""
    import gzip
    lab_path = source.replace('images-idx3', 'labels-idx1')
    opener = gzip.open if source.endswith('.gz') else open
    with opener(source, 'rb') as f:
        data = f.read()
    n = int.from_bytes(data[4:8], 'big')
    imgs = np.frombuffer(data[16:], np.uint8).reshape(n, 28, 28)
    with (gzip.open if lab_path.endswith('.gz') else open)(lab_path,
                                                           'rb') as f:
        ldata = f.read()
    labels = np.frombuffer(ldata[8:], np.uint8)
    for img, lab in zip(imgs, labels):
        yield np.repeat(img[:, :, None], 3, axis=2), int(lab)


def convert_dataset(source, dest, resolution=None, transform=None,
                    max_images=None):
    """Pack ``source`` (an images, meshes and lms folder or zip, a CIFAR-10
    batch folder or tar.gz, an MNIST idx file or an LMDB environment) into
    the folder or .zip ``dest``, scaled to ``resolution`` or cropped by
    ``transform``; a folder's meshes and landmarks are then prebaked."""
    from PIL import Image

    tfm = make_transform(transform, resolution, resolution)
    writer = _Writer(dest)
    out_labels = []
    count = 0

    def emit_class_image(img, label):
        nonlocal count
        out = tfm(img)
        if out is None:
            return
        rel = f'img{count // 1000:05d}/img{count:08d}.png'
        writer.write_image(rel, out)
        onehot = None
        if label is not None:
            onehot = [1 if i == label else 0 for i in range(10)]
        out_labels.append([rel, onehot])
        count += 1

    if source.endswith('.mdb') or (os.path.isdir(source) and
                                   os.path.exists(os.path.join(source,
                                                               'data.mdb'))):
        # LSUN LMDB export (reference dataset_tool.py:255-292 open_lmdb):
        # values are encoded images (webp/jpg), keys are ignored, no labels.
        # Read via the vendored pure-Python parser — no lmdb wheel needed.
        import io

        from ..data.lmdb_reader import LMDBReader
        with LMDBReader(source) as reader:
            for _key, val in reader.items():
                if max_images is not None and count >= max_images:
                    break
                try:
                    img = np.array(Image.open(io.BytesIO(val)).convert('RGB'))
                except Exception:
                    continue  # reference skips undecodable entries too
                out = tfm(img)
                if out is None:
                    continue
                rel = f'img{count // 1000:05d}/img{count:08d}.png'
                writer.write_image(rel, out)
                count += 1
        writer.write_bytes('dataset.json', json.dumps(
            {'labels': []}).encode())
        writer.close()
        print(f'packed {count} lmdb items -> {dest}')
        return

    if source.endswith('.tar.gz') or (os.path.isdir(source) and any(
            n.startswith('data_batch') for n in os.listdir(source))):
        for img, lab in _iter_cifar10(source):
            if max_images is not None and count >= max_images:
                break
            emit_class_image(img, lab)
        writer.write_bytes('dataset.json', json.dumps(
            {'labels': out_labels}).encode())
        writer.close()
        print(f'packed {count} cifar items -> {dest}')
        return

    if 'idx3' in os.path.basename(source):
        for img, lab in _iter_mnist(source):
            if max_images is not None and count >= max_images:
                break
            emit_class_image(img, lab)
        writer.write_bytes('dataset.json', json.dumps(
            {'labels': out_labels}).encode())
        writer.close()
        print(f'packed {count} mnist items -> {dest}')
        return

    # image(+meshes/lms) folder or zip of one
    tmp_extract = None
    if source.endswith('.zip'):
        import tempfile
        tmp_extract = tempfile.mkdtemp(prefix='next3d_dtool_')
        with zipfile.ZipFile(source) as zf:
            zf.extractall(tmp_extract)
        source = tmp_extract

    labels = {}
    src_json = os.path.join(source, 'dataset.json')
    if os.path.exists(src_json):
        with open(src_json) as f:
            labels = dict(json.load(f)['labels'])

    for root, _dirs, files in os.walk(source):
        for fname in sorted(files):
            rel = os.path.relpath(os.path.join(root, fname), source)
            rel = rel.replace('\\', '/')
            ext = os.path.splitext(fname)[1].lower()
            src = os.path.join(root, fname)
            if ext in ('.png', '.jpg', '.jpeg'):
                if max_images is not None and count >= max_images:
                    continue
                if ext == '.png' and transform is None and resolution is None:
                    # fast path: no re-encode needed
                    with open(src, 'rb') as f:
                        writer.write_bytes(rel, f.read())
                    if rel in labels:
                        out_labels.append([rel, labels[rel]])
                    count += 1
                    continue
                img = np.array(Image.open(src).convert('RGB'))
                out = tfm(img)
                if out is None:
                    continue
                writer.write_image(os.path.splitext(rel)[0] + '.png', out)
                if rel in labels:
                    out_labels.append(
                        [os.path.splitext(rel)[0] + '.png', labels[rel]])
                count += 1
            elif ext in ('.obj', '.txt', '.npy'):
                with open(src, 'rb') as f:
                    writer.write_bytes(rel, f.read())
    writer.write_bytes('dataset.json',
                       json.dumps({'labels': out_labels}).encode())
    writer.close()
    if tmp_extract is not None:
        shutil.rmtree(tmp_extract, ignore_errors=True)

    if not dest.endswith('.zip'):
        from ..data.dataset import ImageFolderDataset
        ds = ImageFolderDataset(dest)
        vp, lp = ds.prebake(force=True)
        print(f'packed {count} items -> {dest}; prebaked {vp}, {lp}')
    else:
        print(f'packed {count} items -> {dest}')
