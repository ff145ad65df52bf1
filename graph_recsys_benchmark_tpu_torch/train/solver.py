"""Solver: multi-run / multi-epoch orchestration with resume.

Port of the JAX package's ``train/solver.py``, which replicates
BaseSolver.run (reference solvers.py:106-414):

  * run loop with seed 2019+run (solvers.py:123)
  * run-level resume from the global logger, epoch-level resume from the
    `latest` checkpoint (solvers.py:110-121, 148-161)
  * optional init_eval of the untrained model (solvers.py:162-186)
  * per epoch: train -> evaluate -> log -> checkpoint
    (`save_epochs` snapshots + `latest` after `save_every_epoch`,
    solvers.py:257-272)
  * optional metapath-ablation eval at the final epoch for PEA models
    (solvers.py:224-244), and again after all runs on run 1's `latest`
  * optional full-catalog ranking at the end of each run
  * per-run summary = max over epochs; overall = mean over runs

The trainer supplies the port's API (train/pea_trainer.PEATrainer):
  device                                  the trainer's torch.device
  init(seed) -> params                    an nn.Module
  optimizer(params) -> optimizer          a torch.optim.Optimizer
  run_epoch(params, optimizer, generator) -> train_loss (0-dim tensor)
  evaluate(params, generator, metapath_idx=None) -> metrics dict
  evaluate_full(params) -> metrics dict   (optional)

One ``torch.Generator`` on the trainer's device, seeded with the run's
seed, stands in for the JAX key splits of a run: its draws are held to
distribution parity, as sampling is.  The epoch's loss is read with one
``float()`` an epoch, as the JAX Solver reads it; nothing syncs inside
the epoch.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from ..utils.checkpoint import load_checkpoint, save_checkpoint
from ..utils.logging import RunLogger


def _host(x):
    """A metric (tensor on any device, or array) as a numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


class Solver:
    def __init__(
        self,
        trainer,
        out_dir,
        runs=5,
        epochs=30,
        init_eval=True,
        save_epochs=(5, 10, 15, 20, 25),
        save_every_epoch=26,
        metapath_test=False,
        num_metapaths=0,
        seed_base=2019,
        full_ranking=False,
    ):
        self.trainer = trainer
        self.out_dir = out_dir
        self.runs = runs
        self.epochs = epochs
        self.init_eval = init_eval
        self.save_epochs = set(save_epochs)
        self.save_every_epoch = save_every_epoch
        self.metapath_test = metapath_test
        self.num_metapaths = num_metapaths
        self.seed_base = seed_base
        self.full_ranking = full_ranking and hasattr(trainer, "evaluate_full")
        self.logger = RunLogger(out_dir)

    def _history(self, rec_metrics):
        if rec_metrics is None:
            return {
                "HR": np.zeros((0, 16)),
                "NDCG": np.zeros((0, 16)),
                "AUC": np.zeros((0,)),
                "train_loss": np.zeros((0,)),
                "eval_loss": np.zeros((0,)),
            }
        return {k: np.asarray(v) for k, v in rec_metrics.items()}

    def _fresh(self, seed):
        """(params, optimizer, generator) of a run from its seed."""
        params = self.trainer.init(seed)
        generator = torch.Generator(device=self.trainer.device).manual_seed(seed)
        return params, self.trainer.optimizer(params), generator

    def _final_metapath_ablation(self):
        """After ALL runs: reload run 1's latest checkpoint and re-run the
        metapath-ablation sweep at the final epoch, exactly as the reference
        does once training finishes (solvers.py:334-392: rebuild the model,
        `load_model(run_1/latest.pkl)`, then one eval per excluded path).
        Without that file (epochs <= save_every_epoch) the fresh init is
        evaluated, as in the JAX package."""
        run = 1
        params, opt, gen = self._fresh(self.seed_base + run)
        latest = os.path.join(self.out_dir, f"run_{run}", "latest.ckpt")
        load_checkpoint(latest, params, opt)
        for mp in range(self.num_metapaths):
            ma = self.trainer.evaluate(params, gen, metapath_idx=mp)
            self.logger.write(
                "Run: {}, epoch: {}, exclude path:{}, HR@5: {:.4f}, HR@10: {:.4f}, "
                "HR@15: {:.4f}, HR@20: {:.4f}, NDCG@5: {:.4f}, NDCG@10: {:.4f}, "
                "NDCG@15: {:.4f}, NDCG@20: {:.4f}, AUC: {:.4f}".format(
                    run, self.epochs, mp,
                    float(ma["HR"][0]), float(ma["HR"][5]), float(ma["HR"][10]),
                    float(ma["HR"][15]), float(ma["NDCG"][0]), float(ma["NDCG"][5]),
                    float(ma["NDCG"][10]), float(ma["NDCG"][15]), float(ma["AUC"]),
                )
            )

    def run(self):
        start_run = self.logger.last_run + 1
        t_all = time.perf_counter()
        for run in range(start_run, self.runs + 1):
            params, opt, gen = self._fresh(self.seed_base + run)

            ckpt_dir = os.path.join(self.out_dir, f"run_{run}")
            latest = os.path.join(ckpt_dir, "latest.ckpt")
            params, opt, last_epoch, rec = load_checkpoint(latest, params, opt)
            hist = self._history(rec)

            if last_epoch == 0 and self.init_eval:
                m = self.trainer.evaluate(params, gen)
                self.logger.write(
                    "Initial performance HR@10: {:.4f}, NDCG@10: {:.4f}, AUC: {:.4f}".format(
                        float(m["HR"][5]), float(m["NDCG"][5]), float(m["AUC"])
                    )
                )

            t_run = time.perf_counter()
            for epoch in range(last_epoch + 1, self.epochs + 1):
                train_loss = self.trainer.run_epoch(params, opt, gen)

                if self.metapath_test and epoch == self.epochs:
                    for mp in range(self.num_metapaths):
                        ma = self.trainer.evaluate(params, gen, metapath_idx=mp)
                        self.logger.write(
                            "Run: {}, epoch: {}, exclude path:{}, HR@10: {:.4f}, NDCG@10: {:.4f}, AUC: {:.4f}".format(
                                run, epoch, mp, float(ma["HR"][5]), float(ma["NDCG"][5]), float(ma["AUC"])
                            )
                        )

                m = self.trainer.evaluate(params, gen)
                hr = _host(m["HR"])
                ndcg = _host(m["NDCG"])
                auc = float(m["AUC"])
                eval_loss = float(m["eval_loss"])
                train_loss = float(train_loss)

                hist["HR"] = np.vstack([hist["HR"], hr])
                hist["NDCG"] = np.vstack([hist["NDCG"], ndcg])
                hist["AUC"] = np.append(hist["AUC"], auc)
                hist["train_loss"] = np.append(hist["train_loss"], train_loss)
                hist["eval_loss"] = np.append(hist["eval_loss"], eval_loss)

                self.logger.log_epoch(run, epoch, hr, ndcg, auc, train_loss, eval_loss)

                if epoch in self.save_epochs:
                    save_checkpoint(
                        os.path.join(ckpt_dir, f"epoch_{epoch}.ckpt"),
                        params, opt, epoch, hist,
                    )
                if epoch > self.save_every_epoch:
                    save_checkpoint(latest, params, opt, epoch, hist)

            if self.full_ranking:
                mf = self.trainer.evaluate_full(params)
                self.logger.write(
                    "Run: {}, full-ranking HR@10: {:.4f}, NDCG@10: {:.4f}".format(
                        run, float(mf["HR"][5]), float(mf["NDCG"][5])
                    )
                )

            if self.trainer.device.type == "cuda":
                torch.cuda.synchronize(self.trainer.device)
            duration = time.perf_counter() - t_run
            self.logger.finish_run(
                hist["HR"], hist["NDCG"], hist["AUC"].reshape(-1, 1),
                hist["train_loss"].reshape(-1, 1), hist["eval_loss"].reshape(-1, 1),
            )
            best = np.max(hist["HR"], axis=0) if len(hist["HR"]) else np.zeros(16)
            self.logger.write(
                "Run: {}, Duration: {:.2f}s, best HR@10: {:.4f}".format(run, duration, best[5])
            )

        if self.metapath_test and self.num_metapaths:
            self._final_metapath_ablation()

        overall = self.logger.overall()
        if overall:
            self.logger.write(
                "Overall HR@10: {:.4f}, NDCG@10: {:.4f}, AUC: {:.4f} ({:.1f}s total)".format(
                    overall["HR"][5], overall["NDCG"][5], float(np.ravel(overall["AUC"])[0]),
                    time.perf_counter() - t_all,
                )
            )
        return overall
