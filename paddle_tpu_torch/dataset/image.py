"""Image preprocessing utilities (reference: python/paddle/dataset/image.py).

The reference shells out to cv2; these are pure-numpy implementations of
the same contracts (HWC uint8/float arrays, CHW conversion for model
feeds), so the data plane has no OpenCV dependency. PIL is used for
decode/resize when available (it is in this image); decode degrades to a
clear error otherwise.


A copy of ``paddle_tpu/dataset/image.py``: the same
samples, from the same seeds in the same order."""

from __future__ import annotations

import tarfile

import numpy as np

__all__ = [
    "load_image_bytes", "load_image", "resize_short", "to_chw",
    "center_crop", "random_crop", "left_right_flip", "simple_transform",
    "load_and_transform", "batch_images_from_tar",
]


def _decode(data_or_path, is_bytes, is_color):
    try:
        from PIL import Image
    except ImportError as e:  # pragma: no cover
        raise RuntimeError(
            "image decode needs PIL (reference used cv2); feed numpy "
            "arrays directly or install pillow") from e
    import io
    src = io.BytesIO(data_or_path) if is_bytes else data_or_path
    with Image.open(src) as im:
        rgb = np.asarray(im.convert("RGB"))
    if not is_color:
        # cv2's grayscale conversion (luminosity weights), reference parity
        g = (0.299 * rgb[..., 0] + 0.587 * rgb[..., 1] + 0.114 * rgb[..., 2])
        return np.clip(np.rint(g), 0, 255).astype(rgb.dtype)
    # the reference decodes with cv2.imread -> BGR channel order; ported
    # pipelines subtract BGR means / feed BGR-trained weights, so match it
    return rgb[..., ::-1]


def load_image_bytes(data, is_color=True):
    """Decode an encoded image byte string to an HWC array in the
    reference's cv2 BGR channel order (reference image.py
    load_image_bytes)."""
    return _decode(data, True, is_color)


def load_image(file, is_color=True):
    """Load an image file to an HWC array in the reference's cv2 BGR
    channel order (reference image.py load_image)."""
    return _decode(file, False, is_color)


def resize_short(im, size):
    """Resize so the SHORTER edge equals `size`, keeping aspect ratio
    (reference image.py resize_short). Nearest-neighbor via numpy."""
    h, w = im.shape[:2]
    if h < w:
        new_h, new_w = size, int(round(w * size / h))
    else:
        new_h, new_w = int(round(h * size / w)), size
    rows = (np.arange(new_h) * h / new_h).astype(np.int64).clip(0, h - 1)
    cols = (np.arange(new_w) * w / new_w).astype(np.int64).clip(0, w - 1)
    return im[rows][:, cols]


def to_chw(im, order=(2, 0, 1)):
    """HWC -> CHW (reference image.py to_chw)."""
    assert len(im.shape) == len(order)
    return im.transpose(order)


def center_crop(im, size, is_color=True):
    """Crop the center size x size patch (reference image.py center_crop)."""
    h, w = im.shape[:2]
    h0, w0 = (h - size) // 2, (w - size) // 2
    return im[h0:h0 + size, w0:w0 + size]


def random_crop(im, size, is_color=True):
    """Crop a random size x size patch (reference image.py random_crop)."""
    h, w = im.shape[:2]
    h0 = np.random.randint(0, h - size + 1)
    w0 = np.random.randint(0, w - size + 1)
    return im[h0:h0 + size, w0:w0 + size]


def left_right_flip(im, is_color=True):
    """Horizontal mirror (reference image.py left_right_flip)."""
    return im[:, ::-1]


def simple_transform(im, resize_size, crop_size, is_train, is_color=True,
                     mean=None):
    """resize_short -> crop (random+flip when training, center otherwise)
    -> CHW float32 -> optional mean subtraction (reference image.py
    simple_transform)."""
    im = resize_short(im, resize_size)
    if is_train:
        im = random_crop(im, crop_size)
        if np.random.randint(2) == 0:
            im = left_right_flip(im)
    else:
        im = center_crop(im, crop_size)
    if len(im.shape) == 3:
        im = to_chw(im)
    im = im.astype(np.float32)
    if mean is not None:
        mean = np.array(mean, dtype=np.float32)
        if mean.ndim == 1 and im.ndim == 3:
            mean = mean[:, None, None]
        im -= mean
    return im


def load_and_transform(filename, resize_size, crop_size, is_train,
                       is_color=True, mean=None):
    """load_image + simple_transform (reference image.py
    load_and_transform)."""
    return simple_transform(load_image(filename, is_color), resize_size,
                            crop_size, is_train, is_color, mean)


def batch_images_from_tar(data_file, dataset_name, img2label,
                          num_per_batch=1024):
    """Decode a tar of images into pickled (data, label) batch files
    (reference image.py batch_images_from_tar); returns the meta-file
    path listing the batches."""
    import os
    import pickle

    out_path = f"{data_file}_{dataset_name}_batch"
    os.makedirs(out_path, exist_ok=True)
    data, labels, file_id, names = [], [], 0, []
    with tarfile.open(data_file, mode="r") as f:
        for mem in f.getmembers():
            if mem.name not in img2label:
                continue
            data.append(f.extractfile(mem).read())
            labels.append(img2label[mem.name])
            if len(data) == num_per_batch:
                output = {"label": labels, "data": data}
                name = os.path.join(out_path, f"batch_{file_id:05d}")
                with open(name, "wb") as fo:
                    pickle.dump(output, fo, protocol=2)
                file_id += 1
                names.append(name)
                data, labels = [], []
    if data:
        output = {"label": labels, "data": data}
        name = os.path.join(out_path, f"batch_{file_id:05d}")
        with open(name, "wb") as fo:
            pickle.dump(output, fo, protocol=2)
        names.append(name)
    meta = os.path.join(out_path, "batches.meta")
    with open(meta, "w") as fo:
        fo.write("\n".join(names))
    return meta
