"""The one traffic generator: a mix file of parameters -> the hand-off
batches of a run, drawn from ``--seed``.

A mix (``portbench/traffic/<name>.json``) gives the seed lanes of each
hand-off and their kinds, each kind with an exact share, so every seed
gets the same set of lane kinds, sizes and values classes in another
order and with other drawn values:

- ``seed_lanes``: lanes seeded per hand-off (the rest stay free for
  JUMPI forks); ``distinct_batches``: how many different batches a run
  draws and hands off in turn; ``control``: the control of the mix's
  cells (``portbench/control.py``).
- ``kinds``: ``[{"share", "calldata", "caller", "callvalue",
  "storage"}]``. ``calldata`` is ``"symbolic"`` or ``"abi"`` (the
  configuration's function, its arguments drawn below); ``caller``
  ``"symbolic"`` or ``"drawn"`` (a seeded 160-bit address);
  ``callvalue`` ``"symbolic"`` or a number; ``storage`` ``"symbolic"``,
  ``"empty"`` or ``"caller_balance"`` (the caller's balance under the
  configuration's ``balances_key``, drawn from ``balances``).
- ``array_lengths``: the lengths an ``address[]`` argument cycles
  through (each as often); ``values``: classes of a ``uint256``
  argument, ``[{"share", "lo_bits", "hi_bits"}]`` drawing uniformly from
  [2^lo_bits, 2^hi_bits), or ``{"share", "exact": "0x.."}``;
  ``balances``: the same form for ``caller_balance``.

Lane specs are the keyword arguments of ``reference.lanes._fill_lane``;
``handoff_batches`` turns them into the host planes both sides start
from.
"""

import json
import os

import numpy as np
import torch

from portbench.reference import keccak, lanes

HERE = os.path.dirname(os.path.abspath(__file__))
MASK64 = (1 << 64) - 1


def load_mix(name: str) -> dict:
    with open(os.path.join(HERE, "traffic", name + ".json")) as f:
        return json.load(f)


def _counts(shares, n):
    """Exact counts for ``shares`` over ``n`` items (largest remainders)."""
    raw = [s * n for s in shares]
    base = [int(x) for x in raw]
    rest = sorted(range(len(raw)), key=lambda i: base[i] - raw[i])
    for i in rest[: n - sum(base)]:
        base[i] += 1
    return base


def _classes(rng, classes, n):
    """``n`` draws, each class as often as its share, in seeded order."""
    out = []
    for cls, k in zip(classes, _counts([c["share"] for c in classes], n)):
        for _ in range(k):
            if "exact" in cls:
                out.append(int(cls["exact"], 0))
            else:
                lo, hi = 1 << int(cls["lo_bits"]), 1 << int(cls["hi_bits"])
                span = hi - lo
                r = int.from_bytes(rng.bytes(40), "big") % span
                out.append(lo + r)
    perm = rng.permutation(n)
    return [out[i] for i in perm]


def _address(rng) -> int:
    return int.from_bytes(rng.bytes(20), "big") | 1


def keccak_words(values) -> list:
    """keccak256 of each value as one 32-byte big-endian word."""
    if not values:
        return []
    data = torch.tensor([list(v.to_bytes(32, "big")) for v in values], dtype=torch.uint8)
    out = keccak.keccak256_plain(data, torch.full((len(values),), 32, dtype=torch.int64))
    return [int.from_bytes(bytes(row.tolist()), "big") for row in out]


def _abi(function: dict, args: list) -> bytes:
    """Selector and the ABI encoding of ``args`` for the static types
    ``address`` and ``uint256`` and the dynamic ``address[]``."""
    head, tail = [], []
    n_head = len(function["args"])
    for typ, val in zip(function["args"], args):
        if typ in ("address", "uint256"):
            head.append(int(val))
        elif typ == "address[]":
            head.append(32 * (n_head + len(tail)))
            tail.append(len(val))
            tail.extend(int(a) for a in val)
        else:
            raise ValueError(f"argument type {typ} has no encoder")
    words = head + tail
    return bytes.fromhex(function["selector"]) + b"".join(w.to_bytes(32, "big") for w in words)


def lane_specs(config: dict, mix: dict, seed: int, index: int) -> list:
    """The seed lanes of hand-off batch ``index`` of a run under ``seed``."""
    rng = np.random.default_rng([int(seed) & MASK64, (int(seed) >> 64) & MASK64, index])
    n = int(mix["seed_lanes"])
    kinds = mix["kinds"]
    counts = _counts([k["share"] for k in kinds], n)
    fn = config.get("function")
    cap = int(config["batch"]["calldata_bytes"])
    specs = []
    for kind, k in zip(kinds, counts):
        callers = [_address(rng) for _ in range(k)] if kind["caller"] == "drawn" else [None] * k
        calldata = [None] * k
        if kind["calldata"] == "abi":
            values = _classes(rng, mix["values"], k)
            lengths = [mix["array_lengths"][i % len(mix["array_lengths"])] for i in range(k)]
            lengths = [lengths[i] for i in rng.permutation(k)]
            calldata = []
            for i in range(k):
                args = []
                for typ in fn["args"]:
                    if typ == "uint256":
                        args.append(values[i])
                    elif typ == "address":
                        args.append(_address(rng))
                    else:
                        args.append([_address(rng) for _ in range(lengths[i])])
                cd = _abi(fn, args)
                if len(cd) > cap:
                    raise ValueError(f"calldata of {len(cd)} bytes exceeds the batch's {cap}")
                calldata.append(cd)
        balances = _classes(rng, mix["balances"], k) if kind["storage"] == "caller_balance" else None
        keys = keccak_words(callers) if balances is not None else None
        for i in range(k):
            spec = {}
            if kind["calldata"] == "symbolic":
                spec["symbolic_calldata"] = True
            else:
                spec["calldata"] = calldata[i]
            if callers[i] is None:
                spec["symbolic_caller"] = True
            else:
                spec["caller"] = callers[i]
            if kind["callvalue"] == "symbolic":
                spec["symbolic_callvalue"] = True
            else:
                spec["callvalue"] = int(kind["callvalue"])
            if kind["storage"] == "symbolic":
                spec["symbolic_storage"] = True
            elif balances is not None and balances[i]:
                spec["storage"] = {keys[i]: balances[i]}
            specs.append(spec)
    return [specs[i] for i in rng.permutation(n)]


def handoff_batches(config: dict, mix: dict, seed: int) -> list:
    """The host planes (numpy, the program's layout) of each distinct
    hand-off batch of a run."""
    cfg = lanes.BatchConfig(**config["batch"])
    return [lanes.numpy_batch(cfg, lane_specs(config, mix, seed, i)) for i in range(int(mix["distinct_batches"]))]
