"""The driver the A/B scripts share: one program run in two checkouts in
turns, one JSON line per run.

``ab_main`` parses ``a``, ``b`` and ``--order`` (and the script's own
options), runs ``python -c <run_one> <run_argv(args)>`` in the root of
each checkout in the order given, and prints each run's last line of
output (a JSON object) with its turn, tree and path. A run that fails,
prints nothing or reports ``"ok": false`` fails the A/B. Where a run's
``items`` carry a ``digest``, every run of both checkouts must agree on
each item's digest; a line ``{"outputs_agree": ...}`` says whether they
did.
"""

import argparse
import json
import os
import subprocess
import sys


def ab_main(doc, run_one, run_argv, add_options=None, argv=None, order="ABBA") -> int:
    ap = argparse.ArgumentParser(description=doc.split("\n\n")[0])
    ap.add_argument("a", help="checkout A (e.g. the parent)")
    ap.add_argument("b", help="checkout B")
    ap.add_argument("--order", default=order)
    if add_options is not None:
        add_options(ap)
    args = ap.parse_args(argv)
    trees = {"A": args.a, "B": args.b}
    ok = True
    digests = {}
    for i, key in enumerate(args.order):
        proc = subprocess.run([sys.executable, "-c", run_one, *map(str, run_argv(args))],
                              cwd=os.path.abspath(trees[key]), capture_output=True, text=True)
        lines = proc.stdout.strip().splitlines()
        if proc.returncode != 0 or not lines:
            print(json.dumps({"run": i, "tree": key, "rc": proc.returncode, "stderr": proc.stderr[-4000:]}),
                  flush=True)
            ok = False
            continue
        out = json.loads(lines[-1])
        ok = ok and out.get("ok", True)
        for item, rec in out.get("items", {}).items():
            if "digest" in rec:
                digests.setdefault(item, set()).add(rec["digest"])
        print(json.dumps({"run": i, "tree": key, "path": trees[key], **out}), flush=True)
    differ = sorted(item for item, d in digests.items() if len(d) > 1)
    if digests:
        print(json.dumps({"outputs_agree": not differ, "differ": differ}), flush=True)
    return 0 if ok and not differ else 1
