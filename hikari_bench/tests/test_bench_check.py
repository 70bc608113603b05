"""The comparison that decides ``correct``, driven through the rest of a
run on the CPU at a size a test run holds (the harness's look for a card
skipped): sound runs come out correct; the control (the reference in
bfloat16, put in the port's place) and each fault that a cell can have,
planted in the timed path, come out not correct. The cells run on one
card, so none has an exchange between chips to leave out; a viewer's
frame has no batch mean, so half the batch is the trainer's fault.

The train cell is left out of ``BENCHMARK.json`` while the port's train
step gives non-finite gradients on some frames (PERF.md); its traffic,
check and limits stay, and run here from a copy of the benchmark that
names it.

The copy also names a cell made of new files only, as a later PR adds
one: a configuration of the port's procedural city at 8 x 8 blocks (3,290
triangles, so the port walks tiles and the reference takes its clustered
search) whose ``reference_scene`` names the reference's twin in
``reference/io/city_twin.py``, with its own traffic and limits files in
the copy."""

import json
import math
from pathlib import Path

import pytest

from hikari_bench import check, faults, run, spec

SEED = 2**31 + 977
TRAIN = {"name": "cornell1080_train", "config": "cornell_tu4x_1080p", "traffic": "train",
         "chips": 1, "why": "a test"}


def shrink(config):
    c = json.loads(json.dumps(config))
    c["settings"]["width"], c["settings"]["height"] = 64, 48
    return c


CITY = {"name": "city8_view", "config": "city8_test", "traffic": "view_city8", "chips": 1,
        "why": "a test"}
# The city cell's configuration but for its settings, which are the
# cornell cell's.
CITY_CONFIG = json.loads((Path(__file__).parent / "city8_test.json").read_text())


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """A benchmark that names the view cell, the train cell and a city
    cell whose configuration, traffic and limits are files of the copy."""
    bench = spec.load_benchmark()
    bench["workloads"] += [TRAIN, CITY]
    bench["end_to_end"].append({"name": "train_rays_per_s", "unit": "rays/s", "better": "higher",
                                "bound": 0.2, "source": "host_clock",
                                "workloads": [TRAIN["name"]]})
    for m in bench["end_to_end"]:
        if "workloads" in m and "cornell1080_view" in m["workloads"]:
            m["workloads"].append(CITY["name"])
    for c in bench["configs"]:
        c["file"] = str(spec.ROOT / c["file"])
    bench["configs"].append({"name": CITY_CONFIG["name"], "source": CITY_CONFIG["source"],
                             "file": "hikari_bench/configs/city8_test.json", "reduced": [],
                             "why": "a test"})
    d = tmp_path_factory.mktemp("bench")
    (d / "BENCHMARK.json").write_text(json.dumps(bench))
    own = d / "hikari_bench"
    for sub in ("configs", "limits", "traffic"):
        (own / sub).mkdir(parents=True)
    cornell = spec.find_cell("cornell1080_view")
    config = dict(CITY_CONFIG, settings=cornell.config["settings"])
    (own / "configs" / "city8_test.json").write_text(json.dumps(config))
    (own / "traffic" / "view_city8.json").write_text(json.dumps(cornell.traffic))
    limits = {"limits": check.load_limits("cornell1080_view")}
    (own / "limits" / "city8_view.json").write_text(json.dumps(limits))
    return d


def outcome(root, workload, factory=None):
    result, numbers = run.run(workload, SEED, 0.0, False, device="cpu", program_factory=factory,
                              shrink=shrink, root=root)
    return result["correct"], {n.name: n.value for n in numbers}


CELLS = ["cornell1080_view", "cornell1080_train", "city8_view"]
KIND = {"cornell1080_view": "view", "cornell1080_train": "train", "city8_view": "view"}


@pytest.mark.parametrize("workload", CELLS)
def test_sound_run_is_correct(root, workload):
    correct, numbers = outcome(root, workload)
    assert correct, numbers


@pytest.mark.parametrize("workload", CELLS)
def test_control_is_not_correct(root, workload):
    correct, numbers = outcome(root, workload, faults.Control)
    assert not correct, numbers


@pytest.mark.parametrize(
    "workload, fault",
    [(w, f) for w in CELLS for f in faults.FAULTS[KIND[w]]],
    ids=lambda x: x if isinstance(x, str) else x.__name__)
def test_fault_is_not_correct(root, workload, fault):
    correct, numbers = outcome(root, workload, fault)
    assert not correct, numbers


def test_a_non_finite_reading_is_never_passed_over():
    nan = float("nan")
    assert math.isnan(check.worst([0.0, nan, 1e-9]))
    assert math.isnan(check.grad_gap({"a": 1.0, "b": nan}, {"a": 1.0, "b": nan}))
    assert not check.Number("grad_gap", check.worst([nan, 0.0]), 1e-5).ok
