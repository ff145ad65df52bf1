"""Readings that set a cell's limits, on the card in one process: the
program's check numbers over many seeds, the control's (the reference at
TF32 in the program's place, one precision below the configuration's), and,
in a training cell, a planted fault's (the reference with half of each
batch left out and the sum scaled back up, in the program's place).

    python3 portbench/study/limits.py --workload <cell> --seeds <s> ... \
        --control <s> ... --out chiprun_out/limits-<cell>.jsonl

One JSON line a seed: {"seed", "program": {...}, "control": {...},
"half_batch": {...}}.  The benchmark's runs never run this; the card test
portbench/tests/test_portbench_control.py runs it on three seeds.
"""

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.dirname(HERE), os.path.dirname(os.path.dirname(HERE))]

import torch  # noqa: E402

from pbcore import check, eval_window, reference, spec, train_window  # noqa: E402
from pbcore.setup import prepare  # noqa: E402


def halve(mask):
    """Every other row of the batch left out."""
    keep = torch.arange(mask.numel(), device=mask.device) % 2 == 0
    return mask * keep


def train_readings(env, seed, control):
    _, record, state = train_window.run(env, seed, 0.0, False, time.perf_counter())
    del state
    arrays = check.dataset_arrays(env.hin, env.device)
    want, grad1 = check.reference_steps(env, record, arrays)
    numbers, notes = check.train_numbers(check.program_steps(record), want, grad1)
    out = {"program": numbers,
           "program_worst_grad1": [notes["grad1_worst_leaf"], notes["grad1_worst_gap"]],
           "program_worst_change": [notes["change_worst_leaf"], notes["change_worst_gap"]]}
    out["program"]["batch_violations"] = check.batch_violation_count(env, record, arrays)
    if control:
        tf32, _ = check.reference_steps(env, record, arrays, "tf32")
        out["control"] = check.train_numbers(tf32, want, grad1)[0]
        half, _ = check.reference_steps(env, record, arrays, mask_fn=halve, scale=2.0)
        out["half_batch"] = check.train_numbers(half, want, grad1)[0]
    return out


def eval_readings(env, seed, control):
    _, record, state = eval_window.run(env, seed, 0.0, False, time.perf_counter())
    del state
    arrays = check.dataset_arrays(env.hin, env.device)
    negs = [p.neg for p in record.passes]
    s_pos, s_negs = check.pass_scores(env, record.p0, arrays, negs)
    out = {"program": check.eval_numbers(record, arrays, s_pos, s_negs)}
    if control:
        c_pos, c_negs = check.pass_scores(env, record.p0, arrays, negs, "tf32")
        out["control"] = {
            "rank_gap": max(reference.rank_gap((c_neg > c_pos[:, None]).sum(1), s_pos, s_neg)
                            for c_neg, s_neg in zip(c_negs, s_negs)),
            "metrics_gap": max(float((reference.metrics_from_scores(c_pos, c_neg)
                                      - reference.metrics_from_scores(s_pos, s_neg)).abs().max())
                               for c_neg, s_neg in zip(c_negs, s_negs))}
    return out


def study(cell_name, seeds, control_seeds, out=None, device="cuda"):
    cell = spec.load_cell(cell_name)
    env = prepare(cell.config, cell.traffic, device)
    readings = train_readings if cell.traffic["driver"] == "train_window" else eval_readings
    rows = []
    for seed in list(seeds) + [s for s in control_seeds if s not in seeds]:
        row = {"seed": seed, **readings(env, seed, seed in control_seeds)}
        rows.append(row)
        line = json.dumps(row)
        print(line, flush=True)
        if out:
            with open(out, "a") as fh:
                fh.write(line + "\n")
        if env.device.type == "cuda":
            torch.cuda.empty_cache()
    return rows


def main():
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control", type=int, nargs="*", default=[])
    p.add_argument("--out")
    args = p.parse_args()
    study(args.workload, args.seeds, args.control, args.out)


if __name__ == "__main__":
    main()
