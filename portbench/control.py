"""The controls of the comparison that decides ``correct``: the plain
reference put in the program's place with one of the configuration's
guarantees broken, judged by the same comparison as a run. Each has to
come out as not correct on the cells whose traffic exercises what it
breaks:

- ``word128``: words of 128 bits, where the configuration states exact
  256-bit arithmetic (a concrete call's values and balances are wider);
- ``nofork``: every fork child dropped as it is placed, where the
  configuration states that a symbolic JUMPI forks into a free lane (a
  frontier of symbolic starts forks at every branch).

A traffic mix names the control of its cells (``"control"``).

    python3 -m portbench.control --workload <cell> --seeds <n> [<n> ...] [--control <name> ...]

For each seed and control it draws the cell's first hand-off batch,
hands it to the reference and to the control under the round loop's
default settings, and prints one JSON line with the numbers the run
compares. Runs on the card when there is one, else on the CPU (slow at
the cells' sizes). Not part of a benchmark run.
"""

import argparse
import json
import sys
import time

from portbench import check, run, traffic
from portbench.reference import engine, lanes

# the round loop's defaults in a process with no host-phase history
# (backend.FUSED_K_DEFAULT, FUSED_STEPS_PER_ROUND, the screen on)
DEFAULT_SETTINGS = (16, 256, True)


def truncating_step(bits: int = 128):
    """The reference's step on a machine whose words hold ``bits`` bits
    (every stack word reduced mod 2^bits after each step)."""
    keep = bits // 16  # 16-bit digits

    def step(cb, s):
        s = engine.step_plain(cb, s)
        L = s.stack.shape[0]
        words = s.stack.view(L, -1, check.NDIGITS).clone()
        words[:, :, keep:] = 0
        return s._replace(stack=words.view(L, -1))

    return step


CONTROLS = {
    "word128": {"step": truncating_step(128)},
    "nofork": {"keep_forks": False},
}


def reading(config: dict, np_batch: dict, device, control: str, settings=DEFAULT_SETTINGS) -> dict:
    want, want_counts, want_pv = check.reference_handoff(config, np_batch, device, settings)
    got, got_counts, got_pv = check.reference_handoff(config, np_batch, device, settings, **CONTROLS[control])
    plane_diff = check.plane_differences(got, want)
    return {
        "control": control,
        "plane_bytes_differing": int(sum(plane_diff.values())) + check.coverage_differences(got_pv, want_pv),
        "info_fields_differing": sum(1 for a, b in zip(got_counts, want_counts) if a != b),
        "planes": plane_diff,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", nargs="+", choices=sorted(CONTROLS),
                    help="the controls to read (default: the one the cell's mix names)")
    args = ap.parse_args(argv)
    import torch

    device = "cuda" if torch.cuda.is_available() else "cpu"
    bench = run.load_benchmark()
    cell, config = run.load_cell(bench, args.workload)
    mix = traffic.load_mix(cell["traffic"])
    for seed in args.seeds:
        np_batch = lanes.numpy_batch(lanes.BatchConfig(**config["batch"]), traffic.lane_specs(config, mix, seed, 0))
        for control in args.control or [mix["control"]]:
            t0 = time.time()
            r = reading(config, np_batch, device, control)
            print(json.dumps({"workload": args.workload, "seed": seed, "device": device,
                              "seconds": time.time() - t0, **r}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
