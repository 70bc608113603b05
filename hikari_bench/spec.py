"""Finding a cell's pieces by the names ``BENCHMARK.json`` gives them: its
configuration (``configs/<config>.json``), its traffic mix
(``traffic/<traffic>.json``), the readers of its per-layer metrics
(``metrics/<metric>.py``) and, in ``check``, its limits
(``limits/<workload>.json``). A later cell or metric adds files and
entries; nothing here names one. A benchmark at another root (a test's)
may hold its own traffic, limits and metric readers beside its
configurations, under the same paths; what it lacks comes from this
package."""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


class SpecError(RuntimeError):
    """``BENCHMARK.json`` or a file it names is missing or does not fit."""


@dataclass(frozen=True)
class Cell:
    """One workload: its entry, configuration, traffic and the metrics it
    reports (each an entry of ``BENCHMARK.json``)."""

    name: str
    entry: dict
    config_name: str
    config: dict
    traffic_name: str
    traffic: dict
    end_to_end: tuple
    per_layer: tuple

    @property
    def chips(self) -> int:
        return int(self.entry["chips"])


def load_benchmark(root: Path = ROOT) -> dict:
    path = root / "BENCHMARK.json"
    if not path.is_file():
        raise SpecError(f"no {path.name} at {root}")
    return json.loads(path.read_text())


def _reports(metric: dict, cell: str) -> bool:
    return cell in metric.get("workloads", [cell])


def load_json(path: Path) -> dict:
    if not path.is_file():
        raise SpecError(f"missing {path}")
    return json.loads(path.read_text())


def locate(root: Path | None, *parts: str) -> Path:
    """A file of this package (``parts`` under it) as the benchmark at
    ``root`` holds it, where ``root`` has it, else this package's own."""
    if root is not None:
        path = Path(root).joinpath(HERE.relative_to(ROOT), *parts)
        if path.is_file():
            return path
    return HERE.joinpath(*parts)


def find_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of the benchmark at ``root``, with its files read."""
    bench = load_benchmark(root)
    entries = {w["name"]: w for w in bench["workloads"]}
    if name not in entries:
        raise SpecError(f"no workload {name!r}; have {sorted(entries)}")
    entry = entries[name]
    configs = {c["name"]: c for c in bench["configs"]}
    if entry["config"] not in configs:
        raise SpecError(f"workload {name!r} names no configuration of the benchmark")
    config = load_json(root / configs[entry["config"]]["file"])
    traffic = load_json(locate(root, "traffic", f"{entry['traffic']}.json"))
    return Cell(
        name=name,
        entry=entry,
        config_name=entry["config"],
        config=config,
        traffic_name=entry["traffic"],
        traffic=traffic,
        end_to_end=tuple(m for m in bench["end_to_end"] if _reports(m, name)),
        per_layer=tuple(m for m in bench["per_layer"] if _reports(m, name)),
    )


def metric_reader(name: str, root: Path | None = None):
    """The ``read(ctx)`` function of ``metrics/<name>.py``, of the
    benchmark at ``root`` where it has one, else of this package."""
    path = locate(root, "metrics", f"{name}.py")
    if not path.is_file():
        raise SpecError(f"no reader {path} for the metric {name!r}")
    spec = importlib.util.spec_from_file_location(f"hikari_bench.metrics.{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
