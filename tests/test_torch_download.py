"""The port's dataset archives (data/download.py) and the CLI's
``--dataset_url file://`` path (cli._maybe_download) on the CPU, on
archives that the tests write (tests/torch_raw_files.py); nothing is
fetched over the network.

* download_url copies a file:// URL and skips a file already there (the
  JAX package's tests/test_download.py:50-59); any other scheme raises
  NotImplementedError before a socket is opened.
* ensure_raw_dataset: the three zip layouts (a wrapper named after
  raw_dir, a wrapper of another name, flat), the cached skip once the files
  are there (a broken archive is not read again), no URL; a tar whose
  member would land outside its folder is refused
  (tests/test_download.py:62-101 for the zips).
* The CLI: ``--dataset ml-latest-small --dataset_url file://...zip`` into
  a fresh raw dir builds a HIN equal, array for array, to the one built
  from the unzipped files, and main() trains and evaluates on it; without
  --dataset_url a missing file raises FileNotFoundError quoting the
  grouplens default; an https URL raises NotImplementedError.
"""

import dataclasses
import io
import os
import socket
import tarfile

import numpy as np
import pytest
import torch

from graph_recsys_benchmark_tpu_torch import cli as tcli
from graph_recsys_benchmark_tpu_torch.data import download as dl
from torch_raw_files import write_ml_csvs, write_ml_zip

ML = ["movies.csv", "ratings.csv", "tags.csv"]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Small CPU ops beside the other pytest workers: one torch thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def no_network(monkeypatch):
    """Any socket the code under test opens fails the test."""
    def refuse(*args, **kwargs):
        raise AssertionError("a socket was opened")

    monkeypatch.setattr(socket, "socket", refuse)
    monkeypatch.setattr(socket, "create_connection", refuse)


def test_download_url_file_scheme_and_skip(tmp_path, capsys):
    zpath = write_ml_zip(str(tmp_path / "ml-latest-small.zip"))
    folder = str(tmp_path / "dl")
    p1 = dl.download_url("file://" + zpath, folder)
    assert os.path.exists(p1) and os.path.dirname(p1) == folder
    assert dl.download_url("file://" + zpath, folder) == p1
    assert "Using exist file" in capsys.readouterr().out


@pytest.mark.parametrize("url", ["https://files.grouplens.org/datasets/movielens/x.zip",
                                 "http://example.invalid/x.zip", "ftp://example.invalid/x.zip"])
def test_other_schemes_raise_before_any_connection(url, tmp_path):
    with pytest.raises(NotImplementedError, match="Dataset download over http"):
        dl.download_url(url, str(tmp_path / "dl"))
    assert not (tmp_path / "dl").exists()
    with open(os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                           "ROADMAP.md")) as f:
        assert "**Dataset download over http(s)" in f.read()  # a title of Queue 1


@pytest.mark.parametrize("layout", ["named", "other-wrapper", "flat"])
def test_ensure_raw_dataset_zip_layouts(layout, tmp_path):
    wrapper = {"named": "ml-latest-small", "other-wrapper": "ml-small-v2", "flat": None}[layout]
    zpath = write_ml_zip(str(tmp_path / "a.zip"), wrapper=wrapper)
    raw_dir = str(tmp_path / "data" / "ml-latest-small")
    assert dl.ensure_raw_dataset(raw_dir, ML, "file://" + zpath)
    write_ml_csvs(str(tmp_path / "want"))
    for f in ML:
        with open(os.path.join(raw_dir, f)) as a, open(tmp_path / "want" / f) as b:
            assert a.read() == b.read(), f
    assert not os.path.exists(os.path.join(raw_dir, ".extract_tmp"))
    with open(zpath, "wb") as f:  # the files are there: the archive is not read again
        f.write(b"not a zip")
    assert dl.ensure_raw_dataset(raw_dir, ML, "file://" + zpath)


def test_ensure_raw_dataset_without_url(tmp_path):
    assert not dl.ensure_raw_dataset(str(tmp_path / "nope"), ["x.csv"], None)
    assert dl.DATASET_URLS["ml-latest-small"].endswith("ml-latest-small.zip")
    assert "grouplens.org/datasets/movielens" in dl.DATASET_URLS["ml-25m"]


def test_tar_refuses_members_outside_its_folder(tmp_path):
    tpath = str(tmp_path / "evil.tar.gz")
    with tarfile.open(tpath, "w:gz") as tf:
        data = b"x\n1\n"
        info = tarfile.TarInfo("../escaped.csv")
        info.size = len(data)
        tf.addfile(info, io.BytesIO(data))
    raw_dir = str(tmp_path / "raw")
    with pytest.raises((tarfile.FilterError, RuntimeError)):
        dl.ensure_raw_dataset(raw_dir, ["escaped.csv"], "file://" + tpath)
    assert not (tmp_path / "escaped.csv").exists()
    good = str(tmp_path / "good.tar.gz")
    with tarfile.open(good, "w:gz") as tf:
        info = tarfile.TarInfo("a.csv")
        info.size = len(data)
        tf.addfile(info, io.BytesIO(data))
    assert dl.ensure_raw_dataset(str(tmp_path / "raw2"), ["a.csv"], "file://" + good)


def _hin_arrays(hin):
    out = {}
    for f in dataclasses.fields(hin):
        v = getattr(hin, f.name)
        if isinstance(v, dict):
            out.update({f"{f.name}[{k}]": np.asarray(x) for k, x in v.items()})
        elif dataclasses.is_dataclass(v):
            out.update({f"{f.name}.{g.name}": np.asarray(getattr(v, g.name))
                        for g in dataclasses.fields(v)})
        else:
            out[f.name] = v
    return out


def test_cli_extracts_a_file_url_and_runs(tmp_path, capsys):
    zpath = write_ml_zip(str(tmp_path / "ml-latest-small.zip"))
    raw = str(tmp_path / "fresh" / "ml-latest-small")
    argv = ["--dataset", "ml-latest-small", "--num_core", "2", "--num_feat_core", "2"]
    got = tcli._build_hin(tcli.build_parser().parse_args(
        argv + ["--raw_dir", raw, "--dataset_url", "file://" + zpath]))
    write_ml_csvs(str(tmp_path / "unzipped"))
    want = tcli._build_hin(tcli.build_parser().parse_args(
        argv + ["--raw_dir", str(tmp_path / "unzipped")]))
    a, b = _hin_arrays(got), _hin_arrays(want)
    assert a.keys() == b.keys()
    for k in b:
        if isinstance(b[k], np.ndarray):
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        else:
            assert a[k] == b[k], k
    overall = tcli.main(argv + [
        "--raw_dir", str(tmp_path / "fresh2" / "ml-latest-small"),
        "--dataset_url", "file://" + zpath, "--model", "PEAGCN", "--emb_dim", "8",
        "--hidden_size", "8", "--repr_dim", "4", "--runs", "1", "--epochs", "1",
        "--device", "cpu", "--out_dir", str(tmp_path / "runs"),
        "--cache_dir", str(tmp_path / "cache")])
    assert np.isfinite(overall["HR"]).all()
    assert "Overall HR@10:" in capsys.readouterr().out


@pytest.mark.parametrize("dataset", ["ml-latest-small", "ml-25m"])
def test_cli_without_url_quotes_the_default(dataset, tmp_path):
    args = tcli.build_parser().parse_args(["--dataset", dataset, "--raw_dir",
                                           str(tmp_path / "empty")])
    with pytest.raises(FileNotFoundError, match=dl.DATASET_URLS[dataset].replace(".", r"\.")):
        tcli._build_hin(args)
    args = tcli.build_parser().parse_args([
        "--dataset", dataset, "--raw_dir", str(tmp_path / "raw"),
        "--dataset_url", dl.DATASET_URLS[dataset]])
    with pytest.raises(NotImplementedError, match="Dataset download over http"):
        tcli._build_hin(args)
