"""The control: the plain reference, one precision below what the
configuration states, put in the program's place.

    python3 portbench/control.py --workload <name> --seeds 1 2 3 \
        [--mode fp8|tf32-fp8] [--out control.jsonl]

For each seed it draws the cell's traffic and weights as a run does and
hands them to the configuration module's ``control``, which computes the
numbers the check compares with the reference in the lower mode standing
in for the program (for the diarization configurations,
``portbench/diarization.py``: the longest recording of the pool and
seeded others, its log-probs and its embeddings, under the masks of its
own hard segmentation, held against the float32 reference's). A sound
comparison finds it not correct. Benchmark runs never run this; it sets
the upper reading of each limit (``PERF.md``).
"""

import argparse
import json
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def control(workload_name: str, seed: int, mode: str, device,
            files: int = None, mix: dict = None, root: Path = ROOT):
    """-> [(uri, seconds, numbers)] of the seed's checked recordings."""
    from portbench import harness
    from portbench.traffic.generator import Traffic, load_mix
    bench = harness.load_benchmark(root)
    workload = harness.find(bench["workloads"], workload_name)
    entry = harness.find(bench["configs"], workload["config"])
    config = json.loads((root / entry["file"]).read_text())
    module = harness.config_module(root, entry["name"])
    with tempfile.TemporaryDirectory(prefix="portbench-control-") as tmp:
        mix = mix or load_mix(workload["traffic"],
                              root / harness.HERE.name / "traffic")
        traffic = Traffic(mix, seed, Path(tmp))
        traffic.write(device)
        ctx = harness.Context(seed, device, Path(tmp), config, traffic)
        return module.control(ctx, module.draw_weights(ctx), mode, files)


def main(argv) -> int:
    import torch
    parser = argparse.ArgumentParser(prog="portbench/control.py")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--mode", default=None)
    parser.add_argument("--out", default=None)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    from portbench import harness
    bench = harness.load_benchmark()
    entry = harness.find(bench["configs"], harness.find(
        bench["workloads"], args.workload)["config"])
    config = json.loads((ROOT / entry["file"]).read_text())
    mode = args.mode or config["control"]
    lines = []
    for seed in args.seeds:
        for uri, seconds, found in control(args.workload, seed, mode,
                                           torch.device("cuda", 0)):
            lines.append({"workload": args.workload, "mode": mode,
                          "seed": seed, "recording": uri,
                          "seconds": seconds, **found})
    for name in config["limits"]:
        if name in lines[0]:
            worst = [max(line[name] for line in lines if line["seed"] == s)
                     for s in args.seeds]
            print(f"{name}: smallest worst-of-seed {min(worst)!r}")
    if args.out:
        path = ROOT / args.out
        path.parent.mkdir(parents=True, exist_ok=True)
        with path.open("a") as f:
            for line in lines:
                f.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
