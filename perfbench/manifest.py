"""Read ``BENCHMARK.json`` and resolve a cell's files by name.

A cell (an entry of ``workloads``) names a configuration and a traffic
mix. Its configuration is the ``file`` of that entry of ``configs``, its
traffic mix ``traffic/<traffic>.json``, its limits
``limits/<workload>.json``, and each metric it reports has a reader
``metrics/<metric>.py`` with a function ``read(ctx)``. Nothing here
lists a cell, a mix or a metric: a new one is a new file and a new entry
in ``BENCHMARK.json``.
"""

import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


class Cell:
    """One workload of the manifest with everything it resolves to."""

    def __init__(self, manifest, name, root=ROOT):
        self.manifest = manifest
        cells = {w["name"]: w for w in manifest["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json; it has "
                           f"{sorted(cells)}")
        self.entry = cells[name]
        self.name = name
        configs = {c["name"]: c for c in manifest["configs"]}
        self.config_entry = configs[self.entry["config"]]
        self.bench_dir = root / "perfbench"
        self.config = _load_json(root / self.config_entry["file"])
        self.traffic = _load_json(self.bench_dir / "traffic" / f"{self.entry['traffic']}.json")
        self.limits = _load_json(self.bench_dir / "limits" / f"{name}.json")

    @property
    def chips(self):
        return int(self.entry["chips"])

    def metrics(self, trace):
        """The metric entries this cell reports: its end-to-end metrics
        with ``trace`` off, its per-layer metrics with it on."""
        group = self.manifest["per_layer" if trace else "end_to_end"]
        return [m for m in group if self.name in m.get("workloads", [self.name])]

    def reader(self, metric_name):
        """The ``read(ctx)`` function of ``metrics/<metric_name>.py``."""
        return load_module(self.bench_dir / "metrics" / f"{metric_name}.py").read


def _load_json(path):
    with open(path) as f:
        return json.load(f)


def load_manifest(root=ROOT):
    return _load_json(root / "BENCHMARK.json")


def load_module(path):
    """Import a file by its path (metric files carry dots in their names)."""
    path = Path(path)
    spec = importlib.util.spec_from_file_location(
        "perfbench_file_" + path.stem.replace(".", "_").replace("-", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module
