"""Finding a cell's files by the names in ``BENCHMARK.json``.

``configs/<config>.json`` (the file the manifest names), ``traffic/<traffic>.json``,
``workloads/<cell>.json`` and ``metrics/<metric>.py`` (a ``read(records)``
function) under the benchmark's folder; nothing else names a cell.
"""

from __future__ import annotations

import importlib.util
import json
import os
from typing import Callable, Dict, List, Optional

FOLDER = "bench_port"


class Manifest:
    def __init__(self, root: str) -> None:
        self.root = root
        with open(os.path.join(root, "BENCHMARK.json")) as fh:
            self.data = json.load(fh)

    def _json(self, *parts: str) -> Dict:
        with open(os.path.join(self.root, *parts)) as fh:
            return json.load(fh)

    def cell(self, name: str, config: Optional[str] = None) -> Dict:
        """The cell's files; ``config`` puts another configuration in its
        place (a control run): one of the manifest's, or else the file
        ``configs/<config>.json``."""

        entry = next((w for w in self.data["workloads"] if w["name"] == name), None)
        if entry is None:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        config = config or entry["config"]
        conf = next((c["file"] for c in self.data["configs"] if c["name"] == config),
                    f"{FOLDER}/configs/{config}.json")
        cell = self._json(FOLDER, "workloads", f"{name}.json")
        return {"name": name, "entry": entry, "config": self._json(conf),
                "traffic": self._json(FOLDER, "traffic", f"{entry['traffic']}.json"),
                "cell": cell}

    def metrics(self, cell: str, trace: bool) -> List[Dict]:
        """The metrics this cell reports: its end-to-end ones, or with
        ``trace`` its per-layer ones."""

        group = self.data["per_layer" if trace else "end_to_end"]
        return [m for m in group if "workloads" not in m or cell in m["workloads"]]

    def reader(self, metric: str) -> Callable:
        path = os.path.join(self.root, FOLDER, "metrics", f"{metric}.py")
        spec = importlib.util.spec_from_file_location(
            "bench_metric_" + metric.replace(".", "_").replace("-", "_"), path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        return module.read
