"""Faults planted under the timed path, each of which a cell's check has
to come out not correct on, and their readings at a cell's own size.

    python3 portbench/faults.py --workload <cell> --first-seed <n> \
        --seeds <count> --seconds <window s> [--faults a,b]
    python3 portbench/faults.py --config <file> --traffic <file> ...

(the second form: a configuration under a mix that no cell names yet).

For each fault and seed the cell's stream runs through a fresh simulator
and scheduler with the fault planted, as in a benchmark run (warm
prefix, then a window of the given wall seconds); the reference then
judges the recorded decisions. One JSON line per fault and seed: the
numbers compared, their limits and `correct`. The benchmark's own runs
never plant a fault; `test_portbench_faults.py` plants each at a CPU
size through the same functions.

Each fault takes `mp`, anything with pytest's `monkeypatch.setattr(obj,
name, value)`.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def stale_mirror(mp):
    """A step that returns its state unchanged: the hot path's device
    mirror of the fleet's telemetry keeps its first reading."""
    from repro_torch.core import hotpath
    sync = hotpath.FusedHotPath._sync_state

    def frozen(self, tel):
        first = getattr(self, "_frozen", None)
        if first is None:
            first = self._frozen = tuple(t.clone() for t in sync(self, tel))
        return first
    mp.setattr(hotpath.FusedHotPath, "_sync_state", frozen)


def _wrap_k1(mp, before=None, after=None, **fixed):
    """K1 called with its arguments changed by `before`, its outputs by
    `after`, and the keywords in `fixed` set."""
    from repro_torch.core import hotpath
    k1 = hotpath.k1.decision_megakernel

    def broken(*args, **kw):
        args = list(args)
        kw.update(fixed)
        if before is not None:
            before(args)
        out = list(k1(*args, **kw))
        if after is not None:
            after(args, out)
        return tuple(out)
    broken.launches = broken.plain_calls = 0
    broken.tap = None
    mp.setattr(hotpath.k1, "decision_megakernel", broken)


def half_batch(mp):
    """Half of the batch left out: the second half of each window's rows
    reach the kernel without their prompts."""
    def zero(args):
        emb, rv = args[0].clone(), args[1]
        n = int(rv[0].sum())
        emb[0, n - n // 2:n] = 0.0
        args[0] = emb
    _wrap_k1(mp, before=zero)


def altered_answer(mp):
    """An answer altered where it is produced: the first row of each
    decision call moves to the next alive instance."""
    import torch

    def alter(args, out):
        alive = torch.nonzero(args[9]).flatten().tolist()
        c = out[0].clone()
        c[0, 0] = alive[(alive.index(int(c[0, 0])) + 1) % len(alive)]
        out[0] = c
    _wrap_k1(mp, after=alter)


def moved_placement(mp):
    """A placement altered where it is produced: every third request goes
    to the next cell."""
    from repro_torch.serving import hierarchy
    pick = hierarchy.GlobalBalancer.pick
    calls = [0]

    def moved(self, t, viable):
        ci = pick(self, t, viable)
        calls[0] += 1
        return (ci + 1) % len(viable) if calls[0] % 3 == 0 else ci
    mp.setattr(hierarchy.GlobalBalancer, "pick", moved)


def affinity_dropped(mp):
    """A step left out: K1 launched with the affinity weight 0, so the
    prefix-affinity discount is never applied."""
    _wrap_k1(mp, w_aff=0.0)


SIG_PLANE = 20       # K1's positional argument: the (I, 64) prefix plane


def stale_prefix_plane(mp):
    """A state returned unchanged: from the window's first decision on,
    K1 is handed the prefix plane as the hot path staged it then (the
    warm prefix's sketches), not as the window's dispatches change it."""
    from portbench.bench import cell
    window = cell.Drive.window
    kept = []          # [None] once the window opens, then its plane

    def opened(self, seconds, on_start=None):
        def start():
            kept.append(None)
            if on_start is not None:
                on_start()
        return window(self, seconds, on_start=start)

    def keep(args):
        if kept:
            if kept[0] is None:
                kept[0] = args[SIG_PLANE].clone()
            args[SIG_PLANE] = kept[0]
    mp.setattr(cell.Drive, "window", opened)
    _wrap_k1(mp, before=keep)


FAULTS = {f.__name__: f for f in (stale_mirror, half_batch, altered_answer,
                                  moved_placement, affinity_dropped,
                                  stale_prefix_plane)}


def for_config(cfg) -> list:
    """The faults a cell of this configuration can have."""
    names = ["stale_mirror", "half_batch", "altered_answer"]
    if cfg["scheduler"].get("hierarchy"):
        names.append("moved_placement")
    if cfg["scheduler"]["rbconfig"].get("affinity_weight", 0.0) > 0.0:
        names += ["affinity_dropped", "stale_prefix_plane"]
    return names


class Patch:
    """`monkeypatch.setattr` outside pytest, undone by `undo`."""

    def __init__(self):
        self.saved = []

    def setattr(self, obj, name, value):
        self.saved.append((obj, name, getattr(obj, name)))
        setattr(obj, name, value)

    def undo(self):
        while self.saved:
            obj, name, value = self.saved.pop()
            setattr(obj, name, value)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload")
    p.add_argument("--config")
    p.add_argument("--traffic")
    p.add_argument("--first-seed", type=int, required=True)
    p.add_argument("--seeds", type=int, default=3)
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--faults", default="")
    args = p.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch
    from portbench.bench import cell as cl
    from portbench.yard.reference import Reference
    from portbench.yard.training import encoder_params
    if not torch.cuda.is_available():
        sys.exit("portbench faults: CUDA is not available")
    workload, cfg, mix = cl.cell_files(args.workload, args.config,
                                       args.traffic, ROOT)
    names = args.faults.split(",") if args.faults else for_config(cfg)
    fleet = cl.Fleet.build(cfg, "cuda")
    e = cfg["estimators"]["encoder"]
    ref = Reference(cfg, fleet.world, encoder_params(e, e["seed"]),
                    fleet.pairs, device="cuda")
    limits = cfg["check"]["limits"]
    for name in names:
        for s in range(args.first_seed, args.first_seed + args.seeds):
            t0 = time.perf_counter()
            mp = Patch()
            FAULTS[name](mp)
            try:
                d = cl.Drive(fleet, mix, s)
                d.warm()
                d.window(args.seconds)
            except Exception as e:  # a run that crashes is not correct
                print(json.dumps({"workload": workload, "fault": name,
                                  "seed": s, "correct": False,
                                  "error": repr(e)}), flush=True)
                continue
            finally:
                mp.undo()
            d.release()
            read = cl.readings(d, ref)
            correct, _ = cl.judge(read, limits)
            print(json.dumps({
                "workload": workload, "fault": name, "seed": s,
                "correct": correct, "seconds": time.perf_counter() - t0,
                **{k: read[k] for k in read if not isinstance(read[k],
                                                              dict)}}),
                flush=True)


if __name__ == "__main__":
    main()
