"""Dataset cache/download helpers (reference: python/paddle/dataset/common.py
DATA_HOME + download with md5).

A copy of ``paddle_tpu/dataset/common.py``: the same helpers, with the
port's own `DATA_HOME` (``~/.cache/paddle_tpu_torch/dataset``), so neither
package reads a file the other wrote."""

from __future__ import annotations

import hashlib
import os
import sys
import urllib.request

DATA_HOME = os.path.expanduser("~/.cache/paddle_tpu_torch/dataset")


def md5file(fname):
    h = hashlib.md5()
    with open(fname, "rb") as f:
        for chunk in iter(lambda: f.read(4096), b""):
            h.update(chunk)
    return h.hexdigest()


def download(url, module_name, md5sum, save_name=None):
    dirname = os.path.join(DATA_HOME, module_name)
    os.makedirs(dirname, exist_ok=True)
    filename = os.path.join(dirname,
                            save_name or url.split("/")[-1])
    if os.path.exists(filename) and (md5sum is None or md5file(filename) == md5sum):
        return filename
    try:
        urllib.request.urlretrieve(url, filename)
    except Exception as e:
        raise RuntimeError(
            f"cannot download {url} ({e}); this environment may have no "
            f"egress — dataset modules fall back to synthetic data") from e
    if md5sum is not None and md5file(filename) != md5sum:
        raise RuntimeError(f"md5 mismatch for {filename}")
    return filename


def can_download() -> bool:
    return os.environ.get("PADDLE_TPU_ALLOW_DOWNLOAD", "0") == "1"
