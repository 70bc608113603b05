"""The benchmark finds every piece of a cell by its name: configuration,
traffic and per-layer readers are files of their own."""

import json

import pytest

from hikari_bench import check, spec

BENCH = spec.load_benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.mark.parametrize("name", CELLS)
def test_cell_pieces_by_name(name):
    cell = spec.find_cell(name)
    assert cell.config_name == cell.entry["config"]
    assert cell.traffic["kind"] in ("view", "train")
    assert {m["name"] for m in cell.end_to_end} >= {"setup_s", "peak_mem_gib"}
    assert len(cell.end_to_end) >= 3 and cell.per_layer
    for m in cell.per_layer:
        assert callable(spec.metric_reader(m["name"]))
    assert set(check.load_limits(name)) >= {"hits_off", "image_off", "state_off"}


def test_every_metric_has_a_reader_and_every_config_a_file():
    for m in BENCH["per_layer"]:
        assert callable(spec.metric_reader(m["name"]))
    for c in BENCH["configs"]:
        data = json.loads((spec.ROOT / c["file"]).read_text())
        assert data["name"] == c["name"] and data["source"] == c["source"]
        assert data["reduced"] == c["reduced"]


def test_unknown_names_raise():
    with pytest.raises(spec.SpecError):
        spec.find_cell("no_such_cell")
    with pytest.raises(spec.SpecError):
        spec.metric_reader("no_such_metric")


def test_a_new_cell_needs_no_edit(tmp_path, monkeypatch):
    """A later cell is entries and files: a copy of the benchmark with one
    more workload finds it through the same code."""
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append({"name": "cornell1080_train_copy", "config": "cornell_tu4x_1080p",
                               "traffic": "train", "chips": 1, "why": "a test"})
    for c in bench["configs"]:
        c["file"] = str(spec.ROOT / c["file"])
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = spec.find_cell("cornell1080_train_copy", tmp_path)
    assert cell.traffic["kind"] == "train"
    # Metrics without a workloads list belong to every cell.
    assert "setup_s" in {m["name"] for m in cell.end_to_end}


def test_a_root_holds_its_own_traffic_limits_and_readers(tmp_path):
    """Traffic, limits and metric readers come from the benchmark at the
    root a run is given, where it has them, and else from this package."""
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append({"name": "view_copy", "config": "cornell_tu4x_1080p",
                               "traffic": "view_copy", "chips": 1, "why": "a test"})
    for c in bench["configs"]:
        c["file"] = str(spec.ROOT / c["file"])
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    own = tmp_path / "hikari_bench"
    (own / "traffic").mkdir(parents=True)
    (own / "limits").mkdir()
    traffic = dict(spec.find_cell("cornell1080_view").traffic, sample_rays=77)
    (own / "traffic" / "view_copy.json").write_text(json.dumps(traffic))
    (own / "limits" / "view_copy.json").write_text(json.dumps({"limits": {"hits_off": 0.5}}))
    assert spec.find_cell("view_copy", tmp_path).traffic["sample_rays"] == 77
    assert check.load_limits("view_copy", tmp_path) == {"hits_off": 0.5}
    assert spec.find_cell("cornell1080_view", tmp_path).traffic == \
        spec.find_cell("cornell1080_view").traffic
    assert check.load_limits("cornell1080_view", tmp_path) == check.load_limits("cornell1080_view")
    with pytest.raises(spec.SpecError):
        check.load_limits("no_such_cell", tmp_path)
    (own / "metrics").mkdir()
    (own / "metrics" / "own_metric.py").write_text("def read(ctx):\n    return 7.5\n")
    assert spec.metric_reader("own_metric", tmp_path)(None) == 7.5
    name = BENCH["per_layer"][0]["name"]
    assert spec.metric_reader(name, tmp_path).__code__.co_filename == \
        spec.metric_reader(name).__code__.co_filename
    with pytest.raises(spec.SpecError):
        spec.metric_reader("own_metric")
