"""Readings that the correctness limits are set from, at a cell's own size:

    python3 perfbench/calibrate.py --workload <cell> --seeds 1,2,3 [--out file.jsonl]

For each seed, in one process: the program's numbers against the plain
reference (the lower reading), the control's (the reference in float8 put
in the program's place: the upper reading), and the faults a cell of its
kind can have, planted in the program or in the reference put in its
place. Training: the second half of each batch left out (``half_batch``);
a state left unchanged reads 1 by the measure and needs no run. Serving:
an answer altered where it is produced (``altered``: one pixel's label of
each frame moved to the next class). The benchmark's own runs never run
this. One JSON line a seed."""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def train_readings(config: dict, mix: dict, seed: int, device) -> dict:
    from perfbench.drivers import train_step
    from perfbench.harness import compare
    from perfbench.reference.train import half_batch
    prog = train_step.Program(config, mix, seed, device)
    first = prog.first_steps()
    prog.free()
    ref = prog.reference()
    ctl = prog.reference(fp8=True)
    return {"program": compare.train_gaps(first, ref),
            "control": compare.train_gaps(ctl, ref),
            "half_batch": compare.train_gaps(prog.reference(fault=half_batch), ref),
            "look": {"program": compare.look(first, ref), "control": compare.look(ctl, ref)}}


def serve_readings(config: dict, mix: dict, seed: int, device) -> dict:
    import gc

    import torch

    from perfbench.drivers import serve
    from perfbench.harness import compare, seeded
    b, (h, w) = mix["batch"], mix["frame_hw"]
    shapes = serve.reference_shapes(config)
    torch.backends.cudnn.benchmark = True
    model = serve.program_model(config, seed, device, shapes)
    fn = serve.make_serving_fn(model, device=device)
    pool = seeded.frame_pool(seed, mix["pool"], h, w, device, pin=False)
    labels = []
    with torch.no_grad():
        for s in range(0, mix["pool"], b):
            labels.append(fn(pool["left"][s:s + b].to(device)).cpu())
    labels = torch.cat(labels)
    del fn, model
    gc.collect()
    torch.cuda.empty_cache()
    ref = serve.reference_model(config, seed, device, shapes)
    ctl = serve.reference_model(config, seed, device, shapes, fp8=True)
    worst = {k: {"label_gap": 0.0, "label_tail_gap": 0.0}
             for k in ("program", "control", "altered")}
    with torch.no_grad():
        for f in range(mix["pool"]):
            image = pool["left"][f:f + 1].to(device)
            logits = ref(image)["seg_beforeup"][0]
            up = torch.nn.functional.interpolate(ctl(image)["seg_beforeup"], scale_factor=4,
                                                 mode="bilinear", align_corners=False)
            served = labels[f].to(device)
            altered = served.clone()
            altered[h // 2, w // 2] = (altered[h // 2, w // 2] + 1) % logits.shape[0]
            for k, lab in (("program", served), ("control", up[0].argmax(0)),
                           ("altered", altered)):
                for name, v in compare.label_gaps(logits, lab).items():
                    worst[k][name] = max(worst[k][name], v)
    return worst


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    from perfbench.harness import env, manifest
    env.set_cache_dirs()
    env.require_cards(1)
    man = manifest.load_manifest()
    cell = manifest.workload(man, args.workload)
    config = manifest.config(man, cell["config"])
    mix = manifest.traffic(cell["traffic"])
    info = env.card_info("cuda")
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        if mix["driver"] == "train_step":
            readings = train_readings(config, mix, seed, "cuda")
        else:
            readings = serve_readings(config, mix, seed, "cuda")
        line = {"workload": args.workload, "seed": seed, **readings,
                "seconds": time.perf_counter() - t0, "card": info}
        text = json.dumps(line)
        print(text, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(text + "\n")
    found = env.forbidden_modules()
    if found:
        print(f"calibrate: loaded {found}", file=sys.stderr)
        return 3
    return 0


if __name__ == "__main__":
    sys.exit(main())
