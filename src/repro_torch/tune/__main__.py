"""CLI for the cutout autotuner (the port of ``python -m repro.tune``).

    python -m repro_torch.tune --update              # retune every canonical
                                                     # cutout on the card,
                                                     # merge into the table
    python -m repro_torch.tune --update --kernel ssd.chunked
    python -m repro_torch.tune --smoke               # tune one tiny shape
                                                     # class fresh, assert the
                                                     # winner beats the default
    python -m repro_torch.tune --smoke --device cpu  # the same on the CPU
    python -m repro_torch.tune --list                # registry + table contents

It runs on the card unless ``--device cpu`` is given, and raises when there
is no card: it never falls back to the CPU.  ``--update`` merges the
entries of the device's backend (``cuda`` on the card) into
``TUNED_kernels_torch.json`` (or ``$REPRO_TORCH_TUNED_TABLE``); other
kernels' and other backends' entries survive.
"""
from __future__ import annotations

import argparse
import platform
import subprocess
import sys

import torch

from . import cutouts, registry, table, tuner


def _log(s: str) -> None:
    print(s, flush=True)


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def table_env(device: torch.device) -> dict:
    """The ``env`` of a table written on ``device``."""
    env = {"torch": torch.__version__, "cuda": torch.version.cuda,
           "python": platform.python_version(), "machine": platform.machine(),
           "backend": device.type}
    if device.type == "cuda":
        env["device"] = card_line()
    return env


def _tune_spec(name: str, *, smoke: bool, iters: int, slack: float, device):
    """(shape_class, entry) for one canonical cutout on ``device``."""
    kern = registry.REGISTRY[name]
    args = cutouts.build(name, smoke=smoke, device=device)
    sc = kern.shape_class(*args)
    _log(f"== {name} [{sc}] space={kern.space}")
    entry = tuner.tune_kernel(name, args, iters=iters, slack=slack, log=_log)
    _log(f"   winner {entry['params']} "
         f"{entry['winner_us']}us vs default {entry['default_us']}us "
         f"(ratio {entry['ratio']}, pruned {entry['pruned']}/"
         f"{entry['space_size']})")
    return sc, entry


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.tune")
    mode = ap.add_mutually_exclusive_group(required=True)
    mode.add_argument("--update", action="store_true",
                      help="retune the canonical cutouts and merge the "
                           "winners into TUNED_kernels_torch.json")
    mode.add_argument("--smoke", action="store_true",
                      help="tune the tiny smoke shape classes fresh "
                           "(nothing written); fail unless each winner "
                           "beats (<=) its default")
    mode.add_argument("--list", action="store_true",
                      help="print the kernel registry and table entries")
    ap.add_argument("--kernel", action="append", default=None,
                    help="restrict --update/--smoke to these kernels")
    ap.add_argument("--iters", type=int, default=20,
                    help="timing iterations per surviving config")
    ap.add_argument("--slack", type=float, default=tuner.DEFAULT_SLACK,
                    help="roofline prune slack (bound <= slack * best)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the cutouts run (default: the card)")
    args = ap.parse_args(argv)

    names = args.kernel or sorted(cutouts.CUTOUTS)
    for n in names:
        if n not in cutouts.CUTOUTS:
            ap.error(f"unknown kernel {n!r}; known: {sorted(cutouts.CUTOUTS)}")

    if args.list:
        tab = table.load_table()
        for name, kern in sorted(registry.REGISTRY.items()):
            print(f"{name}: space={kern.space} defaults={kern.defaults} "
                  f"backends={kern.backends}")
        for key, entry in sorted(tab["entries"].items()):
            print(f"  {key}: {entry['params']} (ratio {entry['ratio']})")
        return 0

    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("repro_torch.tune: no CUDA device is available; pass "
                           "--device cpu to tune on the CPU")
    device = torch.device(args.device)
    backend = device.type
    kw = dict(iters=args.iters, slack=args.slack, device=device)

    if args.smoke:
        failures = []
        smokable = [n for n in names if cutouts.CUTOUTS[n].smoke is not None]
        if not smokable:
            _log("no smoke cutouts among " + ", ".join(names))
            return 1
        for name in smokable:
            _, entry = _tune_spec(name, smoke=True, **kw)
            if entry["winner_us"] > entry["default_us"]:
                failures.append(f"{name}: winner {entry['winner_us']}us "
                                f"slower than default {entry['default_us']}us")
        if failures:
            _log("tuner smoke FAILED:")
            for f in failures:
                _log(f"  - {f}")
            return 1
        _log("tuner smoke ok")
        return 0

    # --update
    tab = table.load_table()
    for name in names:
        kern = registry.REGISTRY[name]
        if backend not in kern.backends:
            _log(f"-- {name}: space not meaningful on {backend} "
                 f"(backends={kern.backends}), entry unchanged")
            continue
        sc, entry = _tune_spec(name, smoke=False, **kw)
        tab["entries"][table.entry_key(name, sc, backend)] = entry
    tab["env"] = table_env(device)
    table.save_table(tab)
    _log(f"table written: {table.active_path()} ({len(tab['entries'])} entries)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
