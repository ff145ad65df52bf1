"""The port's CLI (cli.py, __main__.py) against the JAX package's, on the CPU.

* build_parser: the same argv parses to the same values in both packages,
  the port's own ``--device`` aside.
* _build_hin: ``synthetic-ml`` in both candidate modes and
  ``ml-latest-small`` from grouplens-layout CSVs that the test writes;
  each HIN and its tables bitwise the JAX package's.
* main(... --device cpu): PEAGAT and PEAGCN at emb 8 / hidden 8 / repr 4,
  1 run x 2 epochs, finite metrics; a second call resumes at run level
  (no epoch is trained again) to the same summary; with ``--metapath_test
  true --full_ranking true`` the log holds the ablation and full-ranking
  lines.
* Every choice that is not ported raises NotImplementedError before any
  work, naming its ROADMAP Queue 1 item by a title that ROADMAP.md holds.
* The port's HIN cache never reads a pickle that the JAX CLI wrote.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from graph_recsys_benchmark_tpu import cli as jcli
from graph_recsys_benchmark_tpu_torch import cli as tcli

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = ["--emb_dim", "8", "--hidden_size", "8", "--repr_dim", "4", "--entity_aware", "true",
         "--runs", "1", "--epochs", "2", "--device", "cpu"]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Small CPU ops beside the other pytest workers: one torch thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("argv", [
    [],
    ["--model", "PEAGAT", "--dataset", "synthetic-ml", "--entity_aware", "true"],
    ["--model", "PEASage", "--dataset", "ml-latest-small", "--raw_dir", "/x", "--runs", "2",
     "--epochs", "3", "--batch_size", "512", "--lr", "0.01", "--candidate_mode", "rejection",
     "--message_dtype", "bf16", "--metapath_test", "true", "--full_ranking", "true",
     "--save_every_epoch", "0", "--cache_dir", "c", "--out_dir", "o", "--num_heads", "2"],
    ["--model", "KGAT", "--parallel", "edge", "--walk_length", "9", "--dropout", "0.5",
     "--opt", "sparseadam", "--dist_nprocs", "4", "--mesh_mp", "2", "--sampling_strategy",
     "random"],
])
def test_parser_matches_jax(argv):
    got = vars(tcli.build_parser().parse_args(argv + ["--device", "cpu"]))
    assert got.pop("device") == "cpu"
    assert got == vars(jcli.build_parser().parse_args(argv))
    assert tcli.build_parser().parse_args(argv).device is None  # the card by default


def _assert_hin_equal(thin, jhin):
    for f in dataclasses.fields(jhin):
        a, b = getattr(thin, f.name), getattr(jhin, f.name)
        if isinstance(b, dict):
            assert list(a) == list(b), f.name
            for k in b:
                np.testing.assert_array_equal(a[k], b[k], err_msg=f"{f.name}[{k}]")
        elif dataclasses.is_dataclass(b):
            assert type(a).__name__ == type(b).__name__, f.name
            for g in dataclasses.fields(b):
                x, y = getattr(a, g.name), getattr(b, g.name)
                assert x.dtype == y.dtype and x.shape == y.shape, (f.name, g.name)
                np.testing.assert_array_equal(x, y, err_msg=f"{f.name}.{g.name}")
        elif isinstance(b, np.ndarray):
            assert a.dtype == b.dtype, f.name
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        else:
            assert a == b, f.name


def _write_ml_csvs(folder, seed=0, num_users=60, num_movies=70):
    """Grouplens-layout movies.csv / ratings.csv / tags.csv from a seed."""
    rng = np.random.default_rng(seed)
    genres = ["Action", "Comedy", "Drama", "Horror", "Romance", "Sci-Fi"]
    os.makedirs(folder, exist_ok=True)
    with open(os.path.join(folder, "movies.csv"), "w") as f:
        f.write("movieId,title,genres\n")
        for m in range(num_movies):
            g = rng.choice(genres, size=rng.integers(1, 4), replace=False)
            title = f"Movie {m}, The ({rng.integers(1930, 2019)})" if m % 3 else f"Film {m}"
            f.write(f'{m + 1},"{title}",{"|".join(g)}\n')
    with open(os.path.join(folder, "ratings.csv"), "w") as f:
        f.write("userId,movieId,rating,timestamp\n")
        for u in range(num_users):
            for m in rng.choice(num_movies, size=rng.integers(6, 20), replace=False):
                f.write(f"{u + 1},{m + 1},{rng.integers(1, 11) / 2},"
                        f"{rng.integers(9e8, 1.5e9)}\n")
    with open(os.path.join(folder, "tags.csv"), "w") as f:
        f.write("userId,movieId,tag,timestamp\n")
        for _ in range(300):
            f.write(f"{rng.integers(1, num_users + 1)},{rng.integers(1, num_movies + 1)},"
                    f"tag{rng.integers(0, 12)},{rng.integers(9e8, 1.5e9)}\n")


@pytest.mark.parametrize("case", ["synthetic-dense", "synthetic-rejection", "ml-latest-small"])
def test_build_hin_matches_jax(case, tmp_path):
    if case == "ml-latest-small":
        _write_ml_csvs(str(tmp_path / "raw"))
        argv = ["--dataset", "ml-latest-small", "--raw_dir", str(tmp_path / "raw"),
                "--num_core", "2", "--num_feat_core", "2"]
    else:
        argv = ["--candidate_mode", case.split("-")[1]]
    thin = tcli._build_hin(tcli.build_parser().parse_args(argv))
    jhin = jcli._build_hin(jcli.build_parser().parse_args(argv))
    assert type(thin).__module__.startswith("graph_recsys_benchmark_tpu_torch.")
    _assert_hin_equal(thin, jhin)
    assert thin.num_users > 10 and thin.num_items > 10


def test_missing_raw_files_name_them(tmp_path):
    os.makedirs(tmp_path / "raw")
    (tmp_path / "raw" / "movies.csv").write_text("movieId,title,genres\n")
    args = tcli.build_parser().parse_args(["--dataset", "ml-latest-small", "--raw_dir",
                                           str(tmp_path / "raw")])
    with pytest.raises(FileNotFoundError, match=r"ratings\.csv.*tags\.csv"):
        tcli._build_hin(args)


def _log_lines(out_root):
    (path,) = [os.path.join(d, "logger_file.txt") for d, _, fs in os.walk(out_root)
               if "logger_file.txt" in fs]
    with open(path) as f:
        return f.read().splitlines()


@pytest.mark.parametrize("model", ["PEAGAT", "PEAGCN"])
def test_main_trains_and_resumes(model, tmp_path, capsys):
    extra = (["--metapath_test", "true", "--full_ranking", "true"] if model == "PEAGAT"
             else ["--message_dtype", "bf16"])
    argv = SMALL + ["--model", model, "--out_dir", str(tmp_path / "runs"),
                    "--cache_dir", str(tmp_path / "cache")] + extra
    overall = tcli.main(argv)
    for k in ("HR", "NDCG", "AUC", "train_loss", "eval_loss"):
        assert np.isfinite(overall[k]).all(), k
    assert overall["HR"].shape == (16,) and np.all(np.diff(overall["HR"]) >= 0)
    lines = _log_lines(tmp_path / "runs")
    epochs = [ln for ln in lines if ln.startswith("Run: 1, epoch: ") and "HR@5" in ln
              and "exclude" not in ln]
    assert len(epochs) == 2
    assert any(ln.startswith("Initial performance HR@10") for ln in lines)
    if model == "PEAGAT":
        # 9 paths at the last epoch, then again on run 1's latest (absent here:
        # epochs <= save_every_epoch, so the fresh init, as in the JAX package)
        assert sum("exclude path:" in ln for ln in lines) == 18
        assert sum(ln.startswith("Run: 1, full-ranking HR@10") for ln in lines) == 1
    out = capsys.readouterr().out
    assert "Overall HR@10:" in out

    again = tcli.main(argv)  # run-level resume: nothing trained again
    for k in overall:
        np.testing.assert_array_equal(again[k], overall[k])
    lines2 = _log_lines(tmp_path / "runs")
    assert [ln for ln in lines2 if ln in epochs] == epochs
    assert not any(ln.startswith("Initial") for ln in lines2[len(lines):])


@pytest.mark.parametrize("argv,item", [
    (["--dataset", "synthetic-ml25m"], "The remaining datasets"),
    (["--dataset", "yelp"], "The remaining datasets"),
    (["--model", "NGCF"], "Baselines"),
    (["--model", "MetaPath2Vec"], "Baselines"),
    (["--walk_length", "10"], "Baselines"),
    (["--dropout", "0.1"], "Training options left out of slice 2"),
    (["--opt", "sparseadam"], "Training options left out of slice 2"),
    (["--parallel", "a2a"], "Parallel, last"),
    (["--dist_coordinator", "localhost:1234"], "Parallel, last"),
    (["--mesh_mp", "2"], "Parallel, last"),
])
def test_unported_choices_raise_before_any_work(argv, item, tmp_path):
    with open(os.path.join(ROOT, "ROADMAP.md")) as f:
        assert f"**{item}" in f.read()  # a title of ROADMAP Queue 1
    with pytest.raises(NotImplementedError, match=f'ROADMAP Queue 1, "{item}"'):
        tcli.main(argv + ["--device", "cpu", "--out_dir", str(tmp_path / "runs"),
                          "--cache_dir", str(tmp_path / "cache")])
    assert not os.listdir(tmp_path)


def test_cache_never_reads_a_jax_pickle(tmp_path, monkeypatch):
    cache = str(tmp_path / "cache")
    jhin, _ = jcli.load_hin(jcli.build_parser().parse_args(["--cache_dir", cache]))
    (jax_pickle,) = os.listdir(cache)
    with open(os.path.join(cache, jax_pickle), "wb") as f:
        f.write(b"not a pickle")  # reading it would fail
    args = tcli.build_parser().parse_args(["--cache_dir", cache])
    hin, mp_edges = tcli.load_hin(args)
    assert type(hin).__module__ == "graph_recsys_benchmark_tpu_torch.data.hin"
    assert len(mp_edges) == 9
    _assert_hin_equal(hin, jhin)
    assert len(os.listdir(cache)) == 2

    def no_build(args):
        raise AssertionError("the port's own pickle was not read")

    monkeypatch.setattr(tcli, "_build_hin", no_build)
    again, _ = tcli.load_hin(args)
    _assert_hin_equal(again, jhin)
