"""The port's CLI (cli.py, __main__.py) against the JAX package's, on the CPU.

* build_parser: the same argv parses to the same values in both packages,
  the port's own ``--device`` aside.
* _build_hin: ``synthetic-ml`` in both candidate modes,
  ``synthetic-ml25m``, ``synthetic-yelp``, and ``ml-latest-small``,
  ``ml-25m`` and ``yelp`` from raw files that the test writes; each HIN and
  its tables bitwise the JAX package's.  A missing raw file is named in the
  error.  load_hin picks the metapath table by the HIN's name as the JAX
  CLI does (Yelp 11, ML-25M 13, ml-small 9).
* main(... --device cpu): PEAGAT and PEAGCN at emb 8 / hidden 8 / repr 4,
  1 run x 2 epochs, finite metrics (PEAGAT on synthetic-yelp and
  synthetic-ml25m 1 run x 1 epoch, with dropout and SparseAdam); a second call resumes at run level
  (no epoch is trained again) to the same summary; with ``--metapath_test
  true --full_ranking true`` the log holds the ablation and full-ranking
  lines.
* --parallel a2a and --parallel dp in one process train to --parallel
  none's losses; --mesh_mp 2 in a world of one raises before any file;
  --parallel dp --dropout 0.1 draws one mask a union step and a step.
* The port's HIN cache never reads a pickle that the JAX CLI wrote.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from graph_recsys_benchmark_tpu import cli as jcli
from graph_recsys_benchmark_tpu_torch import cli as tcli
from graph_recsys_benchmark_tpu_torch.models import pea as tpea
from torch_raw_files import write_ml25m_csvs, write_ml_csvs, write_yelp_json

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


@pytest.mark.parametrize("case", ["synthetic-dense", "synthetic-rejection", "ml-latest-small",
                                  "synthetic-ml25m", "synthetic-yelp", "ml-25m", "yelp"])
def test_build_hin_matches_jax(case, tmp_path):
    raw = str(tmp_path / "raw")
    if case in ("ml-latest-small", "ml-25m", "yelp"):
        {"ml-latest-small": write_ml_csvs, "ml-25m": write_ml25m_csvs,
         "yelp": write_yelp_json}[case](raw)
        argv = ["--dataset", case, "--raw_dir", raw, "--num_core", "2", "--num_feat_core", "2"]
    elif case in ("synthetic-ml25m", "synthetic-yelp"):
        argv = ["--dataset", case]
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


@pytest.mark.parametrize("dataset", ["ml-25m", "yelp"])
def test_missing_raw_files_name_them_for_ml25m_and_yelp(dataset, tmp_path):
    raw = str(tmp_path / "raw")
    if dataset == "ml-25m":
        write_ml_csvs(raw)  # the three ML files, no genome files
        want = r"\['genome-scores\.csv', 'genome-tags\.csv'\]"
    else:
        os.makedirs(raw)
        (tmp_path / "raw" / "yelp_academic_dataset_user.json").write_text("")
        want = (r"\['yelp_academic_dataset_business\.json', 'yelp_academic_dataset_review"
                r"\.json', 'yelp_academic_dataset_tip\.json', "
                r"'yelp_academic_dataset_checkin\.json'\]")
    args = tcli.build_parser().parse_args(["--dataset", dataset, "--raw_dir", raw])
    with pytest.raises(FileNotFoundError, match=want):
        tcli._build_hin(args)
    with pytest.raises(FileNotFoundError, match="pass --raw_dir"):
        tcli._build_hin(tcli.build_parser().parse_args(["--dataset", dataset]))


@pytest.mark.parametrize("dataset,channels", [("synthetic-yelp", 11), ("synthetic-ml25m", 13),
                                              ("synthetic-ml", 9)])
def test_load_hin_picks_the_metapaths_as_jax(dataset, channels, tmp_path):
    argv = ["--dataset", dataset]
    thin, tm = tcli.load_hin(tcli.build_parser().parse_args(
        argv + ["--cache_dir", str(tmp_path / "t")]))
    jhin, jm = jcli.load_hin(jcli.build_parser().parse_args(
        argv + ["--cache_dir", str(tmp_path / "j")]))
    assert thin.name == jhin.name
    assert len(tm) == len(jm) == channels
    for tc, jc in zip(tm, jm, strict=True):
        for (ts, td), (js, jd) in zip(tc, jc, strict=True):
            np.testing.assert_array_equal(ts, js)
            np.testing.assert_array_equal(td, jd)


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


@pytest.mark.parametrize("dataset,extra", [
    ("synthetic-yelp", ["--dropout", "0.1"]),
    ("synthetic-ml25m", ["--opt", "sparseadam"]),
])
def test_main_runs_the_new_datasets(dataset, extra, tmp_path, capsys):
    """The Yelp and ML-25M recipes (their batch sizes and 'random'
    sampling), 1 run x 1 epoch at a tiny width, with attention dropout and
    SparseAdam."""
    argv = ["--model", "PEAGAT", "--dataset", dataset, "--emb_dim", "8", "--hidden_size", "8",
            "--repr_dim", "4", "--entity_aware", "true", "--runs", "1", "--epochs", "1",
            "--device", "cpu", "--out_dir", str(tmp_path / "runs"),
            "--cache_dir", str(tmp_path / "cache")] + extra
    overall = tcli.main(argv)
    assert np.isfinite(np.ravel(overall["HR"])).all() and 0.0 <= overall["HR"][5] <= 1.0
    hin, mp = tcli.load_hin(tcli.build_parser().parse_args(argv))
    trainer, n = tcli.build_trainer(tcli.build_parser().parse_args(argv), hin, mp)
    assert n == {"synthetic-yelp": 11, "synthetic-ml25m": 13}[dataset]
    assert trainer.tcfg.sampling_strategy == "random"
    assert trainer.tcfg.batch_size == {"synthetic-yelp": 1024, "synthetic-ml25m": 4096}[dataset]
    assert "Overall HR@10:" in capsys.readouterr().out


def _train_losses(out_root):
    import re

    return [float(re.search(r"train loss: ([-0-9.]+)", ln).group(1))
            for ln in _log_lines(out_root) if ln.startswith("Run: ") and "train loss:" in ln]


@pytest.fixture(scope="module")
def one_process_losses(tmp_path_factory):
    """PEAGAT at the tiny width, one epoch, --parallel none: its log's
    train losses."""
    tmp = tmp_path_factory.mktemp("parallel_none")
    tcli.main(SMALL + ["--model", "PEAGAT", "--epochs", "1", "--out_dir", str(tmp / "runs"),
                       "--cache_dir", str(tmp / "cache")])
    return _train_losses(tmp / "runs")


@pytest.mark.parametrize("argv", [
    ["--parallel", "a2a"],
    ["--parallel", "dp"],
    ["--parallel", "dp", "--mesh_mp", "2"],
    ["--parallel", "dp", "--dropout", "0.1"],
])
def test_row_sharded_choices(argv, one_process_losses, tmp_path, monkeypatch):
    """--parallel a2a and --parallel dp in one process (a mesh of one) train
    the tiny flagship's epoch to --parallel none's losses (rtol 2e-4);
    --mesh_mp 2 in a world of one raises ValueError naming the world size
    before any file is written; --parallel dp --dropout 0.1 trains with one
    mask a union step and a step (DropoutMasks.draw spied), its loss moved
    from the no-dropout one but within 1e-2 of it."""
    argv = argv + SMALL + ["--model", "PEAGAT", "--epochs", "1",
                           "--out_dir", str(tmp_path / "runs"),
                           "--cache_dir", str(tmp_path / "cache")]
    if "--mesh_mp" in argv:
        with pytest.raises(ValueError, match="world of 1 rank"):
            tcli.main(argv)
        assert not os.listdir(tmp_path)
        return
    drawn = []
    draw = tpea.DropoutMasks.draw

    def spy(self, c, k, g, heads):
        drawn.append((c, k, heads, self.p))
        return draw(self, c, k, g, heads)

    monkeypatch.setattr(tpea.DropoutMasks, "draw", spy)
    tcli.main(argv)
    losses = _train_losses(tmp_path / "runs")
    assert len(losses) == len(one_process_losses) == 1
    if "--dropout" in argv:
        assert drawn and drawn[:2] == [(None, 0, 1, 0.1), (None, 1, 1, 0.1)]
        assert drawn == drawn[:2] * (len(drawn) // 2)
        assert losses != one_process_losses
        np.testing.assert_allclose(losses, one_process_losses, rtol=1e-2)
        return
    assert drawn == []
    np.testing.assert_allclose(losses, one_process_losses, rtol=2e-4)


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
