"""A run with the timed path broken underneath comes out not correct: the
harness's look for a card skipped, the rest of a run driven on the CPU at
a tiny size, each fault the cells can have planted in the program."""

import pytest
import torch

from graph_recsys_benchmark_tpu_torch.train import engine
from graph_recsys_benchmark_tpu_torch.train.pea_trainer import PEATrainer


def test_a_sound_run_is_correct(run_tiny):
    assert run_tiny("tiny.train")["correct"] is True


def test_a_step_that_leaves_the_state_unchanged(run_tiny, monkeypatch):
    orig = PEATrainer.optimizer

    def frozen(self, params):
        opt = orig(self, params)
        opt.step = lambda closure=None: None
        return opt

    monkeypatch.setattr(PEATrainer, "optimizer", frozen)
    res = run_tiny("tiny.train")
    assert res["correct"] is False
    assert res["checks"]["change_gap"]["value"] == pytest.approx(1.0)


def test_half_of_the_batch_left_out(run_tiny, monkeypatch):
    orig = PEATrainer.batch_loss

    def half(self, params, batch, row_mask, generator=None):
        keep = (torch.arange(row_mask.numel(), device=row_mask.device) % 2 == 0).float()
        return 2.0 * orig(self, params, batch, row_mask * keep, generator)

    monkeypatch.setattr(PEATrainer, "batch_loss", half)
    res = run_tiny("tiny.train")
    assert res["correct"] is False
    assert res["checks"]["grad1_gap"]["value"] > res["checks"]["grad1_gap"]["limit"]


def test_a_negative_drawn_outside_the_rule(run_tiny, monkeypatch):
    orig = engine.sample_cf_negatives

    def users(generator, u, tables, strategy):
        orig(generator, u, tables, strategy)
        return u.clone()  # a node of the table, but no item

    monkeypatch.setattr(engine, "sample_cf_negatives", users)
    res = run_tiny("tiny.train")
    assert res["correct"] is False and res["checks"]["batch_violations"]["value"] > 0


@pytest.mark.parametrize("fault", ["rank", "half_users", "score"])
def test_an_eval_answer_altered(run_tiny, monkeypatch, fault):
    orig = PEATrainer.evaluate

    def altered(self, params, generator, metapath_idx=None):
        res = orig(self, params, generator, metapath_idx)
        if fault == "rank":  # one user's answer changed where it is produced
            res["ranks"] = res["ranks"].clone()
            res["ranks"][3] = (res["ranks"][3] + 40) % 100
        elif fault == "half_users":  # the means over half of the users
            from graph_recsys_benchmark_tpu_torch.eval.metrics import ranks_to_metrics

            hr, ndcg = ranks_to_metrics(res["ranks"][::2])
            res["HR"], res["NDCG"] = hr.mean(0), ndcg.mean(0)
        return res

    if fault == "score":  # the pair scorer's scores perturbed at the source
        from graph_recsys_benchmark_tpu_torch.train import pea_trainer

        pred = pea_trainer.pea_predict

        def noisy(params, cached, u, i):
            s = pred(params, cached, u, i)
            return s + 1e-2 * torch.sin(1e3 * s)

        monkeypatch.setattr(pea_trainer, "pea_predict", noisy)
    else:
        monkeypatch.setattr(PEATrainer, "evaluate", altered)
    res = run_tiny("tiny.eval")
    assert res["correct"] is False
