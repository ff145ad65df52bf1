"""The port's ML-25M and Yelp data layers against the JAX package's, on the CPU.

* ``synthetic_ml25m_raw`` and ``synthetic_yelp_raw``: every frame equal.
* ``build_ml25m_hin`` and ``build_yelp_hin`` on those frames, dense and
  rejection candidates: every field of the HIN bitwise equal
  (test_torch_cli._assert_hin_equal), and ``ml25m_metapath_edges`` /
  ``yelp_metapath_edges`` on them array for array.
* ``parse_ml25m_extras`` and ``parse_yelp_dir`` + ``preprocess_yelp_raw``
  on raw files the test writes (torch_raw_files.py: Yelp JSON lines with
  nested attribute dicts, "None" friends and businesses without a
  checkin): the same frames, and the HINs built from them equal.
"""

import numpy as np
import pandas as pd
import pytest

from graph_recsys_benchmark_tpu.data import ml_raw as jraw
from graph_recsys_benchmark_tpu.data import movielens as jml
from graph_recsys_benchmark_tpu.data import synthetic as jsyn
from graph_recsys_benchmark_tpu.data import yelp as jyelp
from graph_recsys_benchmark_tpu.data import yelp_raw as jyraw
from graph_recsys_benchmark_tpu_torch.data import ml_raw as traw
from graph_recsys_benchmark_tpu_torch.data import movielens as tml
from graph_recsys_benchmark_tpu_torch.data import synthetic as tsyn
from graph_recsys_benchmark_tpu_torch.data import yelp as tyelp
from graph_recsys_benchmark_tpu_torch.data import yelp_raw as tyraw
from test_torch_cli import _assert_hin_equal as assert_hin_equal
from torch_raw_files import write_ml25m_csvs, write_yelp_json


def assert_metapaths_equal(tm, jm):
    assert len(tm) == len(jm)
    for tc, jc in zip(tm, jm, strict=True):
        for (ts, td), (js, jd) in zip(tc, jc, strict=True):
            np.testing.assert_array_equal(ts, js)
            np.testing.assert_array_equal(td, jd)


def test_synthetic_frames_equal_jax():
    for tf, jf in zip(tsyn.synthetic_ml25m_raw(seed=0), jsyn.synthetic_ml25m_raw(seed=0),
                      strict=True):
        pd.testing.assert_frame_equal(tf, jf)
    for tf, jf in zip(tsyn.synthetic_yelp_raw(seed=0), jsyn.synthetic_yelp_raw(seed=0),
                      strict=True):
        pd.testing.assert_frame_equal(tf, jf)


@pytest.mark.parametrize("mode", ["dense", "rejection"])
def test_ml25m_hin_and_metapaths_equal_jax(mode):
    raw = jsyn.synthetic_ml25m_raw(seed=0)
    jh = jml.build_ml25m_hin(*raw, 3, 2, candidate_mode=mode)
    th = tml.build_ml25m_hin(*tsyn.synthetic_ml25m_raw(seed=0), 3, 2, candidate_mode=mode)
    assert_hin_equal(th, jh)
    assert (th.num_nodes, th.num_users, th.num_items) == (420, 150, 78)
    tm, jm = tml.ml25m_metapath_edges(th), jml.ml25m_metapath_edges(jh)
    assert len(tm) == 13
    assert_metapaths_equal(tm, jm)


@pytest.mark.parametrize("mode", ["dense", "rejection"])
def test_yelp_hin_and_metapaths_equal_jax(mode):
    jh = jyelp.build_yelp_hin(*jsyn.synthetic_yelp_raw(seed=0), num_core=4,
                              candidate_mode=mode)
    th = tyelp.build_yelp_hin(*tsyn.synthetic_yelp_raw(seed=0), num_core=4,
                              candidate_mode=mode)
    assert_hin_equal(th, jh)
    assert (th.num_nodes, th.num_users, th.num_items) == (420, 314, 33)
    assert th.train_pos.shape[0] == 2228
    tm, jm = tyelp.yelp_metapath_edges(th), jyelp.yelp_metapath_edges(jh)
    assert len(tm) == 11
    assert_metapaths_equal(tm, jm)


def test_ml25m_raw_files_parse_like_jax(tmp_path):
    raw = str(tmp_path / "ml-25m")
    write_ml25m_csvs(raw)
    for tf, jf in zip(traw.parse_ml25m_extras(raw), jraw.parse_ml25m_extras(raw), strict=True):
        pd.testing.assert_frame_equal(tf, jf)
    tframes = traw.parse_ml_dir(raw) + traw.parse_ml25m_extras(raw)
    jframes = jraw.parse_ml_dir(raw) + jraw.parse_ml25m_extras(raw)
    th = tml.build_ml25m_hin(*tframes, 2, 2)
    jh = jml.build_ml25m_hin(*jframes, 2, 2)
    assert_hin_equal(th, jh)
    assert th.num_users > 20 and "genome_tid" in th.types


def test_yelp_raw_files_parse_like_jax(tmp_path):
    raw = str(tmp_path / "yelp")
    write_yelp_json(raw)
    tframes, jframes = tyraw.parse_yelp_dir(raw), jyraw.parse_yelp_dir(raw)
    for tf, jf in zip(tframes, jframes, strict=True):
        pd.testing.assert_frame_equal(tf, jf)
    tpre, jpre = tyraw.preprocess_yelp_raw(*tframes), jyraw.preprocess_yelp_raw(*jframes)
    for tf, jf in zip(tpre, jpre, strict=True):
        pd.testing.assert_frame_equal(tf, jf)
    business = tpre[0]
    assert (business.checkin_count == 0).any()  # a business without a checkin
    assert business.attributes.str.len().gt(0).any()
    assert tyraw.flatten_attributes(None) == []
    th = tyelp.build_yelp_hin(*tpre, num_core=2)
    jh = jyelp.build_yelp_hin(*jpre, num_core=2)
    assert_hin_equal(th, jh)
    assert th.num_users > 100
    assert_metapaths_equal(tyelp.yelp_metapath_edges(th), jyelp.yelp_metapath_edges(jh))
