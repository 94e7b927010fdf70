"""The benchmark of ``doubly_contrastive_semseg_tpu_torch`` on NVIDIA cards.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout. One process runs one cell of
``BENCHMARK.json``: set-up (the port imported, its CUDA libraries loaded or
built into its ``_build/``, weights and inputs made from ``--seed``, the
cell's shapes warmed up), a measured window of ``--seconds``, and, once the
window has closed, the comparison with the plain reference that decides
``correct``. The last line of standard output is one JSON object; the
numbers compared, each beside its limit, are also the last lines of
standard error. With ``--trace 1`` the metrics are the cell's per-layer
ones, read from a profiled stretch after the window. Without a card the run
fails and prints no result; it never falls back to the CPU."""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def result(rec, manifest_, trace: bool) -> dict:
    """The result line: the cell's metrics (end-to-end without the trace,
    per-layer with it; a qualified end-to-end metric reports its quantity),
    the device, the breakdown and the numbers compared, last."""
    from perfbench.harness import manifest
    metrics = {}
    for m in manifest.cell_metrics(manifest_, rec.cell["name"], trace):
        name = m["name"]
        if trace:
            value = manifest.metric_reader(name)(rec)
        else:
            value = rec.e2e.get(name, rec.e2e.get(manifest.unqualified(name)))
        if value is not None:
            metrics[name] = {"value": value, "unit": m["unit"]}
    device = {"platform": rec.device["platform"], "kind": rec.device["kind"],
              "count": rec.cell["chips"], "memory_peak_bytes": rec.memory_peak_bytes,
              "power_limit": rec.device["power_limit"]}
    out = {"correct": bool(rec.correct), "attempted": rec.attempted, "failed": rec.failed,
           "metrics": metrics, "device": device}
    if trace and rec.trace is not None:
        device["busy_s"] = rec.trace.busy_s
        device["window_s"] = rec.trace.window_s
        out["breakdown"] = {"device_ops": rec.trace.top_ops(10),
                            "idle_gaps": rec.trace.idle_gaps(10)}
    from perfbench.harness import compare
    out["checks"] = compare.checks(rec.numbers, rec.limits)
    return out


def run_cell(args, device="cuda", check_chip=True, overrides=None, out_dir=None):
    """Runs one cell and returns its result dict (the record's fields
    too, under ``_record``). ``check_chip`` False, ``device`` and
    ``overrides`` serve the CPU tests of the harness alone."""
    from perfbench.harness import env, manifest
    env.set_cache_dirs()
    man = manifest.load_manifest()
    cell = manifest.workload(man, args.workload)
    config = manifest.config(man, cell["config"])
    mix = manifest.traffic(cell["traffic"])
    if check_chip:
        env.require_cards(cell["chips"])
    drv = manifest.driver(mix["driver"])
    rec = drv.run(cell, config, mix, args.seed, args.seconds, bool(args.trace), device=device,
                  overrides=overrides, t_start=T_START if check_chip else None, out_dir=out_dir)
    rec.device = env.card_info(device)
    return result(rec, man, bool(args.trace)), rec


def main(argv=None) -> int:
    args = parse(argv)
    from perfbench.harness import env
    try:
        out, _ = run_cell(args)
    except env.NoDevice as e:
        print(f"perfbench: {e}", file=sys.stderr)
        return 2
    found = env.forbidden_modules()
    if found:
        print(f"perfbench: the run loaded {', '.join(found)}; no result", file=sys.stderr)
        return 3
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
