"""The readings a cell's limits are set from, at the cell's own size, in
one process: the program's compared numbers over many seeds (the lower
readings), and the control's and the planted faults' (the upper
readings), each passed through ``check.verdict`` against the cell's
limits as a run's are.  The benchmark's own runs never run this.

    python3 portbench/control.py --workload <cell> --seeds 11,12,... \\
        [--control-seeds 21,22,23] --seconds 10

The program's readings come from whole runs of the cell's kind with a
short window (``--seconds``; one pass over a serving cell's replay set
at the least).  The control is the reference in the program's place with
every matrix product in float8 (the precision below the configurations'
bf16; ``reference.model.mm``):

  - serving (e4m3, a scale a row and a column: fp8 inference): read in
    every ``--seeds`` run on that run's own check sample with the run's
    own numbers (``check.served_readings``), the control's last-position
    logits and the token it puts first in place of the served ones;
  - training (e4m3 forward, e5m2 gradients, a scale a tensor), on each
    ``--control-seeds`` seed: the control's steps from the same weights
    and batches, read against the float32 reference's as the program's
    are; and the fault "half of each batch left out, the mean over the
    rest" (the reference on half the rows).  A state left unchanged
    reads 1 on the change and needs no run.

Each reading is printed as a JSON line to standard output.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
for _p in (str(ROOT), str(ROOT / "src")):
    if _p not in sys.path:
        sys.path.insert(0, _p)

SERVING = "rowwise"
TRAINING = "tensorwise"


def _emit(**row) -> None:
    print(json.dumps(row), flush=True)


def _judged(readings: dict, limits: dict) -> dict:
    from portbench import check

    correct, _ = check.verdict(readings, limits)
    return {"readings": readings, "correct": correct}


def serving_run(cell, seed: int, device: str, seconds: float) -> dict:
    """One run of a serving cell whose check also reads the control on
    the same sample: the program's and the control's readings, each
    judged against the cell's limits."""
    from portbench import spec

    ctx = spec.Run(cell=cell, seed=seed, seconds=seconds, trace=False,
                   device=device, started=time.time(), control=SERVING)
    out = spec.kind(cell.traffic).run(ctx)
    return {"program": _judged(out["readings"], cell.limits),
            "control": _judged(out["control_readings"], cell.limits),
            "checked": out["checked"], "attempted": out["attempted"]}


def training_control(cell, seed: int, device: str) -> dict:
    """The control's and the half-batch fault's readings against the
    float32 reference, from the weights and batches a run would use."""
    import torch

    from portbench import check, generator, weights
    from portbench.reference import model as reference

    reference.no_tf32()
    tr = cell.traffic
    sz = weights.sizes(cell.conf)
    dtype = getattr(torch, cell.conf["torch_dtype"])
    w = weights.make(cell.conf, seed, device)
    batches = [generator.train_batch(tr, sz["V"], seed, i, device)
               for i in range(tr["checked_steps"])]
    full = [(b["tokens"], b["labels"]) for b in batches]
    half = [(t[: len(t) // 2], lab[: len(lab) // 2]) for t, lab in full]
    ref = reference.train_steps(w, sz, full, tr["optimizer"], dtype=dtype)
    out = {}
    ctl = reference.train_steps(w, sz, full, tr["optimizer"],
                                fp8=TRAINING, dtype=dtype)
    out["control"], out["control_at"] = check.train_readings(ctl, ref)
    del ctl
    flt = reference.train_steps(w, sz, half, tr["optimizer"], dtype=dtype)
    out["half_batch"], out["half_batch_at"] = check.train_readings(flt, ref)
    for name in ("control", "half_batch"):
        out[name + "_correct"], _ = check.verdict(out[name], cell.limits)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=10.0)
    args = ap.parse_args(argv)

    import torch

    from portbench import spec

    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    device = "cuda"
    cell = spec.cell(args.workload)
    kind = spec.kind(cell.traffic)
    serving = cell.traffic["kind"] != "train"
    for seed in [int(s) for s in args.seeds.split(",") if s]:
        t0 = time.perf_counter()
        if serving:
            row = serving_run(cell, seed, device, args.seconds)
        else:
            ctx = spec.Run(cell=cell, seed=seed, seconds=args.seconds,
                           trace=False, device=device, started=time.time())
            out = kind.run(ctx)
            row = {"program": _judged(out["readings"], cell.limits),
                   "worst": out.get("worst"), "checked": out["checked"]}
            del out
        _emit(kind="program", seed=seed, **row,
              seconds=time.perf_counter() - t0)
        torch.cuda.empty_cache()
    control_seeds = [] if serving else args.control_seeds.split(",")
    for seed in [int(s) for s in control_seeds if s]:
        t0 = time.perf_counter()
        _emit(kind="control", seed=seed,
              readings=training_control(cell, seed, device),
              seconds=time.perf_counter() - t0)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
