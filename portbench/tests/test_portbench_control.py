"""The control on the card, at a size a test run holds: the plain
reference one precision below what each configuration states, put in the
program's place, must fail the check (``PERF.md`` gives its readings at
the cells' own sizes, from ``portbench/control.py``)."""

import json

import pytest

from portbench.control import control
from portbench.harness import ROOT, find, load_benchmark


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["community1.batch", "sseriouss.batch"])
def test_the_control_is_not_correct(card, tiny_mix, workload):
    bench = load_benchmark()
    entry = find(bench["configs"], find(bench["workloads"],
                                        workload)["config"])
    config = json.loads((ROOT / entry["file"]).read_text())
    for seed in (2 ** 40 + 1, 2 ** 40 + 2, 2 ** 40 + 3):
        found = control(workload, seed, config["control"], card, files=2,
                        mix=tiny_mix)
        worst = {name: max(f[name] for _, _, f in found)
                 for name in config["limits"] if name in found[0][2]}
        assert any(worst[name] > config["limits"][name] for name in worst), \
            (seed, worst)
