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
names it."""

import json
import math

import pytest

from hikari_bench import check, faults, run, spec

SEED = 2**31 + 977
TRAIN = {"name": "cornell1080_train", "config": "cornell_tu4x_1080p", "traffic": "train",
         "chips": 1, "why": "a test"}


def shrink(config):
    c = json.loads(json.dumps(config))
    c["settings"]["width"], c["settings"]["height"] = 64, 48
    return c


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """A benchmark that names the view cell and the train cell."""
    bench = spec.load_benchmark()
    bench["workloads"].append(TRAIN)
    bench["end_to_end"].append({"name": "train_rays_per_s", "unit": "rays/s", "better": "higher",
                                "bound": 0.2, "source": "host_clock",
                                "workloads": [TRAIN["name"]]})
    for c in bench["configs"]:
        c["file"] = str(spec.ROOT / c["file"])
    d = tmp_path_factory.mktemp("bench")
    (d / "BENCHMARK.json").write_text(json.dumps(bench))
    return d


def outcome(root, workload, factory=None):
    result, numbers = run.run(workload, SEED, 0.0, False, device="cpu", program_factory=factory,
                              shrink=shrink, root=root)
    return result["correct"], {n.name: n.value for n in numbers}


CELLS = ["cornell1080_view", "cornell1080_train"]
KIND = {"cornell1080_view": "view", "cornell1080_train": "train"}


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
