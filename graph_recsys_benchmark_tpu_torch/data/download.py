"""Dataset archives: fetch from a local ``file://`` URL and extract.

A copy of the JAX package's ``data/download.py`` (itself the reference's
``_download`` recipe, datasets/dataset.py:117-123, and movielens.py:627-629,
``download_url(url + zip_name)`` + ``extract_zip``) for local archives:
``download_url`` copies a ``file://`` URL and skips a file already there;
``ensure_raw_dataset`` extracts a zip in any of three layouts (a wrapper
folder named after ``raw_dir``, a wrapper of another name, or flat) or a
tar, which refuses members that would land outside its folder.

The JAX package also fetches http(s) URLs (the grouplens defaults of
``DATASET_URLS``).  The port does not: ``download_url`` raises
``NotImplementedError`` for any other scheme before it opens a connection,
naming the ROADMAP Queue 1 item that would port it.
"""

from __future__ import annotations

import os
import os.path as osp
import shutil
import tarfile
import zipfile

# Reference URL table: movielens.py:587 (grouplens); the Yelp raw JSONs are
# a manual download in the reference too (datasets/yelp.py has no url)
DATASET_URLS = {
    "ml-latest-small": "https://files.grouplens.org/datasets/movielens/ml-latest-small.zip",
    "ml-25m": "https://files.grouplens.org/datasets/movielens/ml-25m.zip",
}
# the ROADMAP Queue 1 item by title
DOWNLOAD_ITEM = 'ROADMAP Queue 1, "Dataset download over http(s)"'
FILE_SCHEME = "file://"


def download_url(url: str, folder: str) -> str:
    """Copy the ``file://`` URL `url` into `folder` and return the file's
    path; skip when the file already exists (PyG download_url semantics,
    which the reference inherits).  Any other scheme raises
    NotImplementedError before anything is opened."""
    if not url.startswith(FILE_SCHEME):
        raise NotImplementedError(
            f"{url}: the port reads local archives only (a {FILE_SCHEME} URL); "
            f"fetching over the network is {DOWNLOAD_ITEM}")
    filename = url.rpartition("/")[2].partition("?")[0]
    path = osp.join(folder, filename)
    if osp.exists(path):
        print(f"Using exist file {filename}")
        return path
    os.makedirs(folder, exist_ok=True)
    print(f"Downloading {url}")
    shutil.copyfile(url[len(FILE_SCHEME):], path)
    return path


def extract_zip(path: str, folder: str) -> None:
    """Extract a .zip archive into `folder` (torch_geometric extract_zip)."""
    with zipfile.ZipFile(path, "r") as zf:
        zf.extractall(folder)


def extract_tar(path: str, folder: str, mode: str = "r:gz") -> None:
    """Extract a tar archive into `folder`, refusing a member (a path or a
    link) that would land outside it."""
    with tarfile.open(path, mode) as tf:
        try:
            tf.extractall(folder, filter="data")
        except TypeError:  # Python < 3.12 without extraction filters
            base = osp.realpath(folder)
            for m in tf.getmembers():
                dest = osp.realpath(osp.join(folder, m.name))
                if not (dest == base or dest.startswith(base + os.sep)):
                    raise RuntimeError(f"archive member escapes target dir: {m.name!r}")
            tf.extractall(folder)


def ensure_raw_dataset(raw_dir: str, required_files, url: str | None) -> bool:
    """The reference `_download` recipe (dataset.py:117-123): if every
    required raw file already exists under `raw_dir`, do nothing; else
    fetch the archive from `url` and extract it so that the files land in
    raw_dir: a zip whose one top folder is named after raw_dir (the
    grouplens layout, ``ml-latest-small/...``) into raw_dir's parent, one
    whose single wrapper folder has another name through a scratch folder
    whose wrapper's contents move into raw_dir, a flat zip (or a tar)
    straight into raw_dir.

    Returns True when the files are present afterwards."""
    required = [osp.join(raw_dir, f) for f in required_files]
    if required and all(osp.exists(p) for p in required):
        return True
    if url is None:
        return False
    os.makedirs(raw_dir, exist_ok=True)
    path = download_url(url, raw_dir)
    if path.endswith(".zip"):
        with zipfile.ZipFile(path, "r") as zf:
            names = zf.namelist()
        base = osp.basename(raw_dir.rstrip("/"))
        tops = {n.split("/")[0] for n in names if n}
        if names and tops == {base}:
            extract_zip(path, osp.dirname(raw_dir.rstrip("/")) or ".")
        elif len(tops) == 1 and all("/" in n for n in names if n):
            scratch = osp.join(raw_dir, ".extract_tmp")
            os.makedirs(scratch, exist_ok=True)
            extract_zip(path, scratch)
            inner = osp.join(scratch, next(iter(tops)))
            for name in os.listdir(inner):
                dst = osp.join(raw_dir, name)
                if not osp.exists(dst):
                    shutil.move(osp.join(inner, name), dst)
            shutil.rmtree(scratch, ignore_errors=True)
        else:
            extract_zip(path, raw_dir)
    elif path.endswith((".tar.gz", ".tgz")):
        extract_tar(path, raw_dir)
    elif path.endswith(".tar"):
        extract_tar(path, raw_dir, mode="r:")
    return all(osp.exists(p) for p in required)
