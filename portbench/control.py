"""Readings that set a cell's limits: the program's numbers over many
seeds, and the control's on the same batches, in one process.

    python3 portbench/control.py --workload <cell> --first-seed <n> \
        --seeds <count> --seconds <window s>
    python3 portbench/control.py --config <file> --traffic <file> ...

(the second form: a configuration under a mix that no cell names yet).

For each seed the cell's stream runs through a fresh simulator and
scheduler as in a benchmark run (warm prefix, then a window of the given
wall seconds); then the reference judges the recorded decisions, and the
control, the reference computed with its matrix products in TF32 (the
precision below the configuration's float32 with TF32 off), is read at
each row of the same batches on the same state. One JSON line a seed:
the program's readings and, under "control", the control's. The
benchmark's own runs never run the control.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload")
    p.add_argument("--config")
    p.add_argument("--traffic")
    p.add_argument("--first-seed", type=int, required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--seconds", type=float, default=10.0)
    args = p.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch
    from portbench.bench import cell as cl
    from portbench.yard.reference import Reference
    from portbench.yard.training import encoder_params
    if not torch.cuda.is_available():
        sys.exit("portbench control: CUDA is not available")
    workload, cfg, mix = cl.cell_files(args.workload, args.config,
                                       args.traffic, ROOT)
    fleet = cl.Fleet.build(cfg, "cuda")
    e = cfg["estimators"]["encoder"]
    params = encoder_params(e, e["seed"])
    ref = Reference(cfg, fleet.world, params, fleet.pairs, device="cuda")
    ctl = Reference(cfg, fleet.world, params, [], device="cuda", tf32=True)
    ctl.trees = ref.trees            # the fits do not depend on precision
    for s in range(args.first_seed, args.first_seed + args.seeds):
        t0 = time.perf_counter()
        d = cl.Drive(fleet, mix, s)
        d.warm()
        d.window(args.seconds)
        d.release()
        read = cl.readings(d, ref, ctl)
        read.update(seed=s, seconds=time.perf_counter() - t0,
                    workload=workload)
        print(json.dumps(read), flush=True)


if __name__ == "__main__":
    main()
