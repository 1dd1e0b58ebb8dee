"""The readings that the limits of limits/<cell>.json are set from.

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,... \
        [--control-seeds 1,2,3] [--plant-fault half_batch] [--out FILE]

For each seed, the program's first steps as a run takes them (the cell's
set-up and entry, no window) against the float32 reference: the numbers of
reference/compare.py, one JSON line a seed, with both sides' first
gradients of the parameters whose reference gradient is quiet. For each control seed also the
control, the reference itself in the precision below the configuration's
(TF32 for float32, float8 for bfloat16), against the float32 reference.
With --plant-fault the program runs with that fault (faults.py) and its
lines are the fault's readings. A cell of several cards runs one process
a card, as a run does. Prints the card's line first; --out writes the
lines as one JSON list.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
os.environ["USE_FLAX"] = "0"


def readings(args, cell, device, group) -> list:
    import torch

    from benchmark.harness import card, core, guard
    from benchmark.reference import compare

    if args.rank == 0:
        print(card.card_line(0) if device.type == "cuda" else f"{device}: no card", flush=True)
    control = "tf32" if cell.dtype == "float32" else "fp8"
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    lines = []
    for seed in (int(s) for s in args.seeds.split(",")):
        ctx, entry, program = core.first_steps(cell, seed, device, group)
        guard.check("after set-up")
        entry.free(ctx)
        if device.type == "cuda":
            torch.cuda.empty_cache()
        if group is not None:
            group.barrier()
        if args.rank:
            continue
        t0 = time.perf_counter()
        ref = core.reference_readings(cell, ctx)
        line = {"seed": seed, "fault": args.plant_fault,
                "reference_s": time.perf_counter() - t0,
                "program": compare.numbers(program, ref),
                "quiet": compare.quiet_parameters(program, ref),
                "reference_quiet": compare.reference_quiet(program, ref),
                "losses": program["losses"],
                "worst_grad": compare.worst_parameters(program, ref, "grad_norms"),
                "worst_change": compare.worst_parameters(program, ref, "change_norms"),
                "reference_losses": ref["losses"]}
        if seed in controls:
            ctrl = core.reference_readings(cell, ctx, control)
            line["control"] = {"precision": control, **compare.numbers(ctrl, ref),
                               "worst_grad": compare.worst_parameters(ctrl, ref, "grad_norms"),
                               "losses": ctrl["losses"]}
        guard.check("before the seed's line")
        print(json.dumps(line), flush=True)
        lines.append(line)
        if device.type == "cuda":
            torch.cuda.empty_cache()
    if group is not None:
        from palette_and_histo_gan_tpu_torch.parallel import distributed

        distributed.shutdown()
    return lines


def main() -> int:
    from benchmark.harness import core, guard, spec

    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--plant-fault", default=None)
    p.add_argument("--out", default=None)
    p.add_argument("--rank", type=int, default=0)
    p.add_argument("--rendezvous", default=None)
    p.add_argument("--test-device", default=None)
    p.add_argument("--test-overrides", default=None)
    args = p.parse_args()
    overrides = json.loads(args.test_overrides) if args.test_overrides else None
    cell = core.apply_overrides(spec.cell(args.workload), overrides)
    device = core.find_device(args, cell)
    if device is None:
        return 2
    if args.plant_fault:
        from benchmark import faults

        faults.plant(args.plant_fault, cell.model)
    lines = core.with_ranks(args, cell, device,
                            lambda group: readings(args, cell, device, group),
                            os.path.abspath(__file__))
    guard.check("calibration")
    if args.rank == 0 and args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(lines, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
