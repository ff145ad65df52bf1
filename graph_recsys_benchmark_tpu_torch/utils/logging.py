"""Run/epoch metric logging with the reference's summary semantics.

A copy of the JAX package's ``utils/logging.py`` (numpy only), so that
both packages write byte-identical ``logger_file.txt`` lines and equal
``global_logger.npz`` arrays.  The reference appends one formatted line
per epoch to `logger_file.txt` (fsync'd per write,
general_utils.py:270-272), keeps per-epoch metric arrays, summarizes each
run as the column-wise MAX over epochs, and reports the mean over runs
(solvers.py:281-300, 394-413).  `RunLogger` reproduces that:
`global_logger.npz` holds per-run rows and enables run-level resume
(general_utils.py:182-191).

``writer=False`` keeps the history in memory and writes no file: the
ranks of a world share one run directory, and rank 0 writes it
(train/solver.py), as it alone writes the checkpoints.
"""

from __future__ import annotations

import os

import numpy as np


class RunLogger:
    def __init__(self, folder, writer=True):
        self.folder = folder
        self.writer = writer
        os.makedirs(folder, exist_ok=True)
        self.global_path = os.path.join(folder, "global_logger.npz")
        self.text_path = os.path.join(folder, "logger_file.txt")
        if os.path.isfile(self.global_path):
            data = np.load(self.global_path)
            self.runs = {k: list(data[k]) for k in data.files}
        else:
            self.runs = {"HR": [], "NDCG": [], "AUC": [], "train_loss": [], "eval_loss": []}

    @property
    def last_run(self):
        return len(self.runs["HR"])

    def write(self, line):
        if not self.writer:
            return
        with open(self.text_path, "a") as f:
            f.write(line + "\n")
            f.flush()
            os.fsync(f.fileno())

    def log_epoch(self, run, epoch, hr, ndcg, auc, train_loss, eval_loss,
                  extras=None):
        """extras: extra named losses, e.g. KGAT/KGCN's kg_train_loss
        (reference prints 'kg train loss' + 'cf train loss' per epoch,
        kgat_solver_bpr.py:386-394)."""
        extra_txt = "".join(
            ", {}: {:.4f}".format(k.replace("_", " "), v)
            for k, v in (extras or {}).items()
        )
        self.write(
            "Run: {}, epoch: {}, HR@5: {:.4f}, HR@10: {:.4f}, HR@15: {:.4f}, HR@20: {:.4f}, "
            "NDCG@5: {:.4f}, NDCG@10: {:.4f}, NDCG@15: {:.4f}, NDCG@20: {:.4f}, AUC: {:.4f}, "
            "train loss: {:.4f}, eval loss: {:.4f}{}".format(
                run, epoch, hr[0], hr[5], hr[10], hr[15],
                ndcg[0], ndcg[5], ndcg[10], ndcg[15], auc, train_loss, eval_loss,
                extra_txt,
            )
        )

    def finish_run(self, hr_hist, ndcg_hist, auc_hist, train_hist, eval_hist):
        """Per-run summary = max over epochs (solvers.py:296-300)."""
        self.runs["HR"].append(np.max(hr_hist, axis=0))
        self.runs["NDCG"].append(np.max(ndcg_hist, axis=0))
        self.runs["AUC"].append(np.max(auc_hist, axis=0))
        self.runs["train_loss"].append(np.mean(train_hist, axis=0))
        self.runs["eval_loss"].append(np.mean(eval_hist, axis=0))
        if self.writer:
            np.savez(self.global_path, **{k: np.asarray(v) for k, v in self.runs.items()})

    def overall(self):
        """Mean over runs of the per-run maxima (solvers.py:394-413)."""
        return {k: np.mean(np.asarray(v), axis=0) for k, v in self.runs.items() if len(v)}
