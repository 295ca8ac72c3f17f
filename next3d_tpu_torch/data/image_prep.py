"""Pure-image dataset preparation stages (no GPU networks).

Implements the three image-only steps of the reference's FFHQ pipeline
(`dataset_preprocessing/ffhq/runme.py:21-77`):

  * ``align_face`` — the FFHQ landmark-quad recreate-aligned recipe
    (`align_multiprocess.py process_image`): oriented crop rectangle from
    the 68 landmarks, shrink / crop / reflect-pad with blurred border
    blending, projective QUAD transform to ``transform_size``, downsample
    to ``output_size``.
  * ``align_crop_resize`` — the final 512² crop (`crop_images.py`). The
    reference's own ``preprocess.align_img`` file is EMPTY (it resolves
    through the Deep3DFaceRecon git submodule, not vendored), so the
    5-point POS similarity alignment is re-derived here from the published
    Deep3DFaceRecon semantics: estimate scale/translation from 5 facial
    points against a canonical 3D template, rescale so the face spans
    ``target_size``, center-crop, LANCZOS-resize to ``output_size``.
  * ``mirror_dataset`` — x-flip every image and append yaw-flipped camera
    labels (`dataset_preprocessing/mirror_dataset.py`; pose flip =
    ``preprocess.flip_yaw``).

A copy of next3d_tpu/data/image_prep.py, so that the port imports nothing
of the JAX package; tests/test_torch_data_tools.py holds it to the
original. PIL is imported where a stage runs, so that importing the module
needs no imaging library.

All stages are host-side numpy/PIL (the training framework never runs
them on-device); they exist so a reference user can run the documented
wilds → aligned → cropped → mirrored → packed flow end-to-end with this
framework alone (everything except the 3DMM/FLAME fitting networks, which
stay external per SURVEY 7.2).
"""

from __future__ import annotations

import json
import os

import numpy as np

from .preprocess import flip_yaw

PNG_COMPRESS_LEVEL = 0  # the reference writes uncompressed PNGs


# --------------------------------------------------------------------- align

def face_quad_from_landmarks(lm):
    """Oriented crop rectangle from 68 landmarks
    (align_multiprocess.py:62-95 with the repo's q_scale=1.8 enlargement).

    Returns (quad (4, 2) float64 [NW, SW, SE, NE] in source pixels, qsize).
    """
    lm = np.asarray(lm, np.float64)
    assert lm.shape == (68, 2), lm.shape
    eye_left = lm[36:42].mean(axis=0)
    eye_right = lm[42:48].mean(axis=0)
    eye_avg = (eye_left + eye_right) * 0.5
    eye_to_eye = eye_right - eye_left
    mouth_avg = (lm[48] + lm[54]) * 0.5
    eye_to_mouth = mouth_avg - eye_avg

    x = eye_to_eye - np.flipud(eye_to_mouth) * [-1, 1]
    x /= np.hypot(*x)
    x *= max(np.hypot(*eye_to_eye) * 2.0, np.hypot(*eye_to_mouth) * 1.8)
    y = np.flipud(x) * [-1, 1]
    x = 1.8 * x  # q_scale: the Next3D fork crops wider than vanilla FFHQ
    y = 1.8 * y
    c = eye_avg + eye_to_mouth * 0.1
    quad = np.stack([c - x - y, c - x + y, c + x + y, c + x - y])
    return quad, np.hypot(*x) * 2


def align_face(img, lm, output_size=1500, transform_size=4096,
               enable_padding=True):
    """FFHQ recreate-aligned-images for one image.

    img: PIL.Image (or array); lm: (68, 2) landmark pixels. Returns a PIL
    image of (output_size, output_size). Matches
    align_multiprocess.py process_image (shrink -> crop -> reflect-pad with
    blurred/median border blend -> QUAD transform -> resize).
    """
    import PIL.Image
    import scipy.ndimage
    if not isinstance(img, PIL.Image.Image):
        img = PIL.Image.fromarray(np.asarray(img))
    quad, qsize = face_quad_from_landmarks(lm)

    # shrink: pre-downscale very large sources before transforming
    shrink = int(np.floor(qsize / output_size * 0.5))
    if shrink > 1:
        rsize = (int(np.rint(img.size[0] / shrink)),
                 int(np.rint(img.size[1] / shrink)))
        img = img.resize(rsize, PIL.Image.LANCZOS)
        quad /= shrink
        qsize /= shrink

    # crop to the quad bbox plus a border
    border = max(int(np.rint(qsize * 0.1)), 3)
    crop = (int(np.floor(quad[:, 0].min())), int(np.floor(quad[:, 1].min())),
            int(np.ceil(quad[:, 0].max())), int(np.ceil(quad[:, 1].max())))
    crop = (max(crop[0] - border, 0), max(crop[1] - border, 0),
            min(crop[2] + border, img.size[0]),
            min(crop[3] + border, img.size[1]))
    if crop[2] - crop[0] < img.size[0] or crop[3] - crop[1] < img.size[1]:
        img = img.crop(crop)
        quad -= crop[0:2]

    # reflect-pad where the quad leaves the image, blending the padding into
    # a blurred+median background so the transform has no hard edge
    pad = (int(np.floor(quad[:, 0].min())), int(np.floor(quad[:, 1].min())),
           int(np.ceil(quad[:, 0].max())), int(np.ceil(quad[:, 1].max())))
    pad = (max(-pad[0] + border, 0), max(-pad[1] + border, 0),
           max(pad[2] - img.size[0] + border, 0),
           max(pad[3] - img.size[1] + border, 0))
    if enable_padding and max(pad) > border - 4:
        pad = np.maximum(pad, int(np.rint(qsize * 0.3)))
        arr = np.pad(np.float32(img),
                     ((pad[1], pad[3]), (pad[0], pad[2]), (0, 0)), 'reflect')
        h, w, _ = arr.shape
        yy, xx = np.ogrid[:h, :w]
        with np.errstate(divide='ignore', invalid='ignore'):
            mask = np.maximum(
                1.0 - np.minimum(np.float32(xx) / pad[0],
                                 np.float32(w - 1 - xx) / pad[2]),
                1.0 - np.minimum(np.float32(yy) / pad[1],
                                 np.float32(h - 1 - yy) / pad[3]))[..., None]
        mask = np.nan_to_num(mask, posinf=0.0, neginf=0.0)
        try:
            # exact reference background model (align_multiprocess.py:130-140):
            # blur a 0.1x INTER_AREA pyramid level, LANCZOS4 it back up, blend;
            # then blend toward the 0.1x median. Pixel-parity-tested against
            # process_image in tests/test_image_prep.py.
            import cv2
            low_res = cv2.resize(arr, (0, 0), fx=0.1, fy=0.1,
                                 interpolation=cv2.INTER_AREA)
            blur = qsize * 0.02 * 0.1
            low_res = scipy.ndimage.gaussian_filter(low_res, [blur, blur, 0])
            low_res = cv2.resize(low_res, (arr.shape[1], arr.shape[0]),
                                 interpolation=cv2.INTER_LANCZOS4)
            arr += (low_res - arr) * np.clip(mask * 3.0 + 1.0, 0.0, 1.0)
            median = cv2.resize(arr, (0, 0), fx=0.1, fy=0.1,
                                interpolation=cv2.INTER_AREA)
            median = np.median(median, axis=(0, 1))
            arr += (median - arr) * np.clip(mask, 0.0, 1.0)
        except ImportError:
            # cv2-free approximation: full-res gaussian + full-res median
            # (visually equivalent synthetic background, not bit-exact)
            blur = qsize * 0.02
            blurred = scipy.ndimage.gaussian_filter(arr, [blur, blur, 0])
            arr += (blurred - arr) * np.clip(mask * 3.0 + 1.0, 0.0, 1.0)
            arr += (np.median(arr, axis=(0, 1)) - arr) * np.clip(mask, 0.0,
                                                                 1.0)
        img = PIL.Image.fromarray(
            np.uint8(np.clip(np.rint(arr), 0, 255)), 'RGB')
        quad += pad[:2]

    img = img.transform((transform_size, transform_size), PIL.Image.QUAD,
                        (quad + 0.5).flatten(), PIL.Image.BILINEAR)
    if output_size < transform_size:
        img = img.resize((output_size, output_size), PIL.Image.LANCZOS)
    return img


# ---------------------------------------------------------------------- crop

# canonical 5-point 3D template (Deep3DFaceRecon's lm3D after rescaling; the
# reference ships per-image copies of this in cropping_params.json['lm3d_std'])
LM3D_STD = np.array([
    [-0.31148657, 0.09036078, 0.13377953],
    [0.30979887, 0.08972035, 0.13179526],
    [0.0032535, -0.24617933, 0.55244243],
    [-0.25216928, -0.5813392, 0.22405732],
    [0.2484662, -0.5812824, 0.22235769]], np.float64)


def extract_5p(lm):
    """68 -> 5 landmark points (eyes = corner means, nose tip, mouth corners)."""
    lm = np.asarray(lm, np.float64)
    lm5 = np.stack([
        lm[[37, 40]].mean(0) / 2 + lm[[38, 41]].mean(0) / 2,
        lm[[43, 46]].mean(0) / 2 + lm[[44, 47]].mean(0) / 2,
        lm[30], lm[48], lm[54]], axis=0)
    return lm5


def pos_similarity(xp, x):
    """Least-squares similarity (scale s, translation t) mapping the 3D
    template's x/y onto image points: the POS step of align_img.

    xp: (5, 2) image landmarks; x: (5, 3) canonical template.
    Returns (t (2,), s float).
    """
    npts = xp.shape[0]
    A = np.zeros((2 * npts, 8), np.float64)
    A[0:2 * npts - 1:2, 0:3] = x
    A[0:2 * npts - 1:2, 3] = 1
    A[1:2 * npts:2, 4:7] = x
    A[1:2 * npts:2, 7] = 1
    b = xp.reshape(-1, 1)
    k, _, _, _ = np.linalg.lstsq(A, b, rcond=None)
    R1, R2 = k[0:3], k[4:7]
    sTx, sTy = k[3], k[7]
    s = (np.linalg.norm(R1) + np.linalg.norm(R2)) / 2
    t = np.stack([sTx, sTy], axis=0).reshape(2)
    return t, float(s)


def align_crop_resize(img, lm, lm3d_std=None, rescale_factor=300.0,
                      target_size=1024.0, center_crop_size=700,
                      output_size=512):
    """The reference's final-crop stage (crop_images.py): POS-align the face
    to a canonical scale, resize, center-crop, resize to output.

    img: PIL.Image; lm: (68, 2) landmarks in TOP-LEFT-origin pixels (the
    CLI flips from the bottom-left convention like crop_images.py:38-40).
    Returns (cropped PIL image, transformed (68, 2) landmarks).
    """
    import PIL.Image
    if lm3d_std is None:
        lm3d_std = LM3D_STD
    if not isinstance(img, PIL.Image.Image):
        img = PIL.Image.fromarray(np.asarray(img))
    lm = np.asarray(lm, np.float64)
    w0, h0 = img.size

    lm5 = extract_5p(lm) if lm.shape[0] != 5 else lm
    # POS works in bottom-left-origin coords (align_img flips y first)
    lm5_bl = lm5.copy()
    lm5_bl[:, 1] = h0 - 1 - lm5_bl[:, 1]
    t, s = pos_similarity(lm5_bl, np.asarray(lm3d_std, np.float64))
    s = rescale_factor / s

    # resize_n_crop_img: scale the image by s, then crop a target_size
    # window centered on the aligned face center
    w = int(w0 * s)
    h = int(h0 * s)
    left = int(w / 2 - target_size / 2 + (t[0] - w0 / 2) * s)
    up = int(h / 2 - target_size / 2 + (h0 / 2 - t[1]) * s)
    img = img.resize((w, h), resample=PIL.Image.BICUBIC)
    img = img.crop((left, up, int(left + target_size), int(up + target_size)))

    lm_t = lm * s - np.array([left, up], np.float64)

    # center-crop + final resize (crop_images.py:42-48)
    cleft = int(img.size[0] / 2 - center_crop_size / 2)
    cupper = int(img.size[1] / 2 - center_crop_size / 2)
    img = img.crop((cleft, cupper, cleft + center_crop_size,
                    cupper + center_crop_size))
    lm_t = lm_t - np.array([cleft, cupper], np.float64)
    img = img.resize((output_size, output_size), resample=PIL.Image.LANCZOS)
    lm_t = lm_t * (output_size / center_crop_size)
    return img, lm_t


# -------------------------------------------------------------------- mirror

def mirror_dataset(source, dest=None, max_images=None):
    """x-flip every image; with a dataset.json present, append yaw-flipped
    camera labels for the mirrored copies (mirror_dataset.py; pose flip =
    flip_yaw). Returns the number of mirrored images written."""
    import PIL.Image
    dest = source if dest is None else dest
    os.makedirs(dest, exist_ok=True)
    dataset_file = os.path.join(source, 'dataset.json')
    count = 0
    if os.path.isfile(dataset_file):
        with open(dataset_file) as f:
            dataset = json.load(f)
        labels = list(dataset['labels'])
        for i, (filename, label) in enumerate(labels):
            if max_images is not None and i >= max_images:
                break
            if '_mirror' in filename:
                continue
            img = PIL.Image.open(os.path.join(source, filename))
            if dest != source:
                out = os.path.join(dest, filename)
                os.makedirs(os.path.dirname(out) or dest, exist_ok=True)
                img.save(out, compress_level=PNG_COMPRESS_LEVEL)
            pose = np.array(label[:16], np.float64).reshape(4, 4)
            intr = np.array(label[16:25], np.float64)
            flipped_label = np.concatenate(
                [flip_yaw(pose).reshape(-1), intr] +
                ([np.array(label[25:], np.float64)] if len(label) > 25
                 else [])).tolist()
            base, ext = os.path.splitext(filename)
            flipped_name = base + '_mirror' + ext
            PIL.Image.Image.transpose(
                img, PIL.Image.FLIP_LEFT_RIGHT).save(
                os.path.join(dest, flipped_name),
                compress_level=PNG_COMPRESS_LEVEL)
            dataset['labels'].append([flipped_name, flipped_label])
            count += 1
        with open(os.path.join(dest, 'dataset.json'), 'w') as f:
            json.dump(dataset, f)
    else:
        for filename in sorted(os.listdir(source)):
            if not filename.lower().endswith(('.png', '.jpg', '.jpeg')):
                continue
            if '_mirror' in filename:
                continue
            if max_images is not None and count >= max_images:
                break
            img = PIL.Image.open(os.path.join(source, filename))
            if dest != source:
                img.save(os.path.join(dest, filename),
                         compress_level=PNG_COMPRESS_LEVEL)
            base, ext = os.path.splitext(filename)
            img.transpose(PIL.Image.FLIP_LEFT_RIGHT).save(
                os.path.join(dest, base + '_mirror' + ext),
                compress_level=PNG_COMPRESS_LEVEL)
            count += 1
    return count


def align_dataset(source, dest, landmarks_json, output_size=1500,
                  transform_size=4096, enable_padding=True, max_images=None):
    """Batch align_face over a directory (align_multiprocess.py's batch
    loop, single-process; the reference's multiprocessing pool is an IO
    detail).

    landmarks_json: {filename: [[x, y] * 68]} (the in-the-wild landmark
    format; the reference reads the FFHQ metadata JSON's
    in_the_wild.face_landmarks field).
    """
    import PIL.Image
    with open(landmarks_json) as f:
        lms = json.load(f)
    os.makedirs(dest, exist_ok=True)
    count = 0
    for filename, lm in sorted(lms.items()):
        if max_images is not None and count >= max_images:
            break
        src = os.path.join(source, filename)
        if not os.path.isfile(src):
            continue
        img = PIL.Image.open(src).convert('RGB')
        aligned = align_face(img, np.asarray(lm, np.float64),
                             output_size=output_size,
                             transform_size=transform_size,
                             enable_padding=enable_padding)
        aligned.save(os.path.join(dest, os.path.basename(filename)),
                     compress_level=PNG_COMPRESS_LEVEL)
        count += 1
    return count


def crop_dataset(source, dest, cropping_params=None, max_images=None):
    """Batch align_crop_resize (crop_images.py's loop). cropping_params:
    path to the reference's cropping_params.json ({im_path: {lm, lm3d_std,
    rescale_factor, center_crop_size, output_size}}); defaults to
    <source>/cropping_params.json."""
    import PIL.Image
    params_path = cropping_params or os.path.join(source,
                                                  'cropping_params.json')
    with open(params_path) as f:
        params = json.load(f)
    os.makedirs(dest, exist_ok=True)
    count = 0
    for im_path, p in sorted(params.items()):
        if max_images is not None and count >= max_images:
            break
        src = os.path.join(source, im_path)
        if not os.path.isfile(src):
            continue
        img = PIL.Image.open(src).convert('RGB')
        # cropping_params 'lm' is stored TOP-LEFT-origin, exactly what
        # align_crop_resize takes: it performs the bottom-left conversion
        # for the POS fit internally (the reference splits this across
        # crop_images.py:38-40 + align_img; doing both here would mirror
        # the vertical crop for any off-center face)
        lm = np.array(p['lm'], np.float64).reshape(-1, 2)
        cropped, _ = align_crop_resize(
            img, lm, lm3d_std=np.array(p['lm3d_std'], np.float64),
            rescale_factor=p['rescale_factor'],
            center_crop_size=p['center_crop_size'],
            output_size=p['output_size'])
        cropped.save(os.path.join(dest, os.path.basename(im_path)),
                     compress_level=PNG_COMPRESS_LEVEL)
        count += 1
    return count
