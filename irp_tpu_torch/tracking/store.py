"""MLflow-compatible experiment tracking on the local filesystem (the JAX
package's ``tracking/store.py``).

The same API and the same on-disk layout as MLflow's FileStore,
``mlruns/<exp_id>/<run_id>/{params,metrics,tags,artifacts}`` with
``meta.yaml`` files, and the same default root (``IRP_TRACKING_URI``,
else ``./mlruns``): a run either package writes, the other package's
``TrackingClient`` reads.  Metric files hold MLflow's lines,
``<timestamp_ms> <value> <step>``.

``set_experiment`` resolves concurrent creators of one name to one id:
see its docstring.
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
import time
import uuid
from dataclasses import dataclass
from typing import Dict, List, Optional

_DEFAULT_URI = os.environ.get("IRP_TRACKING_URI", "./mlruns")
_state = {"uri": _DEFAULT_URI, "experiment_id": None, "run": None}


def _now_ms() -> int:
    return int(time.time() * 1000)


def set_tracking_uri(uri: str) -> None:
    _state["uri"] = uri
    _state["experiment_id"] = None


def get_tracking_uri() -> str:
    return _state["uri"]


def _root() -> str:
    root = _state["uri"]
    os.makedirs(root, exist_ok=True)
    return root


def _write_meta(path: str, meta: Dict) -> None:
    # meta.yaml in the trivial "key: value" subset MLflow uses.  String
    # values that would corrupt the line format (newlines — including a
    # lone \r, which universal-newlines reading splits) or not survive
    # the read-side strip (leading/trailing whitespace) are JSON-quoted —
    # still valid YAML, so external YAML readers keep working.
    with open(path, "w", newline="") as f:
        for k, v in meta.items():
            if isinstance(v, str) and (v != v.strip() or "\n" in v
                                       or "\r" in v or v.startswith('"')):
                v = json.dumps(v)
            f.write(f"{k}: {v}\n")


def _read_meta(path: str) -> Dict[str, str]:
    out = {}
    if not os.path.exists(path):
        return out
    with open(path) as f:
        for line in f:
            if ":" in line:
                k, v = line.split(":", 1)
                v = v.strip()
                if v.startswith('"') and v.endswith('"') and len(v) >= 2:
                    try:
                        v = json.loads(v)
                    except ValueError:
                        pass  # a literal quoted-looking value; keep as-is
                out[k.strip()] = v
    return out


def _ids_named(root: str, name: str) -> List[int]:
    """Ids of the experiments named ``name``, ascending."""
    return sorted(int(e) for e in os.listdir(root) if e.isdigit()
                  and _read_meta(os.path.join(root, e, "meta.yaml")
                                 ).get("name") == name)


def set_experiment(name: str) -> str:
    """Create-or-get an experiment; makes it active.  Returns its id.

    The claim of an id is one ``os.rename`` of a staged directory that
    already holds ``meta.yaml``, so an experiment directory is never seen
    without its name.  Ids are claimed in increasing order (the next id is
    always one past the largest), so when racing creators of one name
    claim several ids, the lowest was claimed first.  Every caller scans
    the names again after its own claim, or after finding the name on
    disk, and takes the lowest id with the name: all racers agree.  A
    duplicate it claimed itself loses its name (its ``meta.yaml`` is
    replaced by one marked deleted, atomically), so the name stays on one
    directory, and the directory stays, so the ids stay dense.
    """
    root = _root()
    named = _ids_named(root, name)
    if named:
        exp_id = str(named[0])
        _state["experiment_id"] = exp_id
        return exp_id
    existing = [int(e) for e in os.listdir(root) if e.isdigit()]
    next_id = max(existing) + 1 if existing else 0
    stage = tempfile.mkdtemp(prefix=".exp_stage_", dir=root)
    try:
        while True:
            exp_id = str(next_id)
            exp_dir = os.path.join(root, exp_id)
            _write_meta(os.path.join(stage, "meta.yaml"), {
                "artifact_location": exp_dir,
                "experiment_id": exp_id,
                "lifecycle_stage": "active",
                "name": name,
            })
            try:
                os.rename(stage, exp_dir)
                stage = None  # claimed: nothing left to clean up
                break
            except OSError:
                next_id += 1  # a concurrent creator took this id
    finally:
        if stage is not None:
            shutil.rmtree(stage, ignore_errors=True)
    lowest = str(_ids_named(root, name)[0])
    if lowest != exp_id:
        _retire_duplicate(os.path.join(root, exp_id), exp_id)
    _state["experiment_id"] = lowest
    return lowest


def _retire_duplicate(exp_dir: str, exp_id: str) -> None:
    """Take the name off a duplicate this caller claimed: a new
    ``meta.yaml`` without a name, marked deleted, swapped in atomically."""
    tmp = os.path.join(exp_dir, f".meta.{os.getpid()}.yaml")
    _write_meta(tmp, {"artifact_location": exp_dir,
                      "experiment_id": exp_id,
                      "lifecycle_stage": "deleted"})
    os.replace(tmp, os.path.join(exp_dir, "meta.yaml"))


@dataclass
class RunInfo:
    run_id: str
    experiment_id: str
    run_name: str
    status: str = "RUNNING"
    start_time: int = 0
    end_time: Optional[int] = None

    @property
    def run_uuid(self):
        return self.run_id


class Run:
    """Handle for one tracked run (context manager)."""

    def __init__(self, run_dir: str, info: RunInfo):
        self._dir = run_dir
        self.info = info

    @property
    def artifact_dir(self) -> str:
        return os.path.join(self._dir, "artifacts")

    def log_params(self, params: Dict) -> None:
        pdir = os.path.join(self._dir, "params")
        for k, v in params.items():
            path = os.path.join(pdir, str(k))
            # MLflow allows slash-namespaced keys ('val/acc'); its
            # FileStore nests them as subdirectories — match that
            os.makedirs(os.path.dirname(path), exist_ok=True)
            with open(path, "w") as f:
                f.write(str(v))

    def log_metrics(self, metrics: Dict, step: int = 0) -> None:
        mdir = os.path.join(self._dir, "metrics")
        ts = _now_ms()
        for k, v in metrics.items():
            path = os.path.join(mdir, str(k))
            os.makedirs(os.path.dirname(path), exist_ok=True)
            with open(path, "a") as f:
                f.write(f"{ts} {float(v)} {int(step)}\n")

    def set_tags(self, tags: Dict) -> None:
        tdir = os.path.join(self._dir, "tags")
        for k, v in tags.items():
            path = os.path.join(tdir, str(k))
            os.makedirs(os.path.dirname(path), exist_ok=True)
            with open(path, "w") as f:
                f.write(str(v))

    def log_artifact(self, local_path: str, artifact_path: str = "") -> str:
        dst_dir = os.path.join(self.artifact_dir, artifact_path)
        os.makedirs(dst_dir, exist_ok=True)
        dst = os.path.join(dst_dir, os.path.basename(local_path))
        shutil.copy2(local_path, dst)
        return dst

    def log_text(self, text: str, artifact_file: str) -> str:
        dst = os.path.join(self.artifact_dir, artifact_file)
        os.makedirs(os.path.dirname(dst), exist_ok=True)
        with open(dst, "w") as f:
            f.write(text)
        return dst

    def log_dict(self, data: Dict, artifact_file: str) -> str:
        return self.log_text(json.dumps(data, indent=2), artifact_file)

    def _write_run_meta(self) -> None:
        meta = {
            "artifact_uri": self.artifact_dir,
            "experiment_id": self.info.experiment_id,
            "lifecycle_stage": "active",
            "run_id": self.info.run_id,
            "run_name": self.info.run_name,
            "run_uuid": self.info.run_id,
            "start_time": self.info.start_time,
            "status": self.info.status,
        }
        if self.info.end_time is not None:  # only set once the run ends
            meta["end_time"] = self.info.end_time
        _write_meta(os.path.join(self._dir, "meta.yaml"), meta)

    def end(self, status: str = "FINISHED") -> None:
        self.info.status = status
        self.info.end_time = _now_ms()
        self._write_run_meta()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, *exc):
        if _state["run"] is self:
            _state["run"] = None
        if self.info.end_time is None:  # respect an explicit end() inside
            self.end("FAILED" if exc_type else "FINISHED")


def start_run(run_name: Optional[str] = None,
              experiment: Optional[str] = None) -> Run:
    """Start (and make active) a run in the active experiment."""
    if experiment is not None:
        set_experiment(experiment)
    if _state["experiment_id"] is None:
        set_experiment("Default")
    exp_id = _state["experiment_id"]
    run_id = uuid.uuid4().hex
    run_name = run_name or f"run_{run_id[:8]}"
    run_dir = os.path.join(_root(), exp_id, run_id)
    for sub in ("params", "metrics", "tags", "artifacts"):
        os.makedirs(os.path.join(run_dir, sub), exist_ok=True)
    info = RunInfo(run_id=run_id, experiment_id=exp_id, run_name=run_name,
                   start_time=_now_ms())
    run = Run(run_dir, info)
    run.set_tags({"mlflow.runName": run_name})
    run._write_run_meta()  # initial meta: RUNNING, no end_time
    _state["run"] = run
    return run


def active_run() -> Optional[Run]:
    return _state["run"]


def _require_run() -> Run:
    run = _state["run"]
    if run is None:
        run = start_run()
    return run


def log_params(params: Dict) -> None:
    _require_run().log_params(params)


def log_metrics(metrics: Dict, step: int = 0) -> None:
    _require_run().log_metrics(metrics, step)


def log_artifact(local_path: str, artifact_path: str = "") -> str:
    return _require_run().log_artifact(local_path, artifact_path)


def log_text(text: str, artifact_file: str) -> str:
    return _require_run().log_text(text, artifact_file)


def end_run(status: str = "FINISHED") -> None:
    run = _state["run"]
    if run is not None:
        run.end(status)
        _state["run"] = None


@dataclass
class MetricPoint:
    timestamp: int
    value: float
    step: int


class TrackingClient:
    """Read-back API (the reference's MlflowClient uses:
    get_metric_history, get_run params, artifact listing/download —
    hyperopt.py:519-538, final.py:174-189, final.py:415-537)."""

    def __init__(self, uri: Optional[str] = None):
        self.uri = uri or get_tracking_uri()

    def _experiments(self) -> Dict[str, str]:
        out = {}
        if not os.path.isdir(self.uri):
            return out
        for entry in sorted(os.listdir(self.uri)):
            if not entry.isdigit():
                continue  # skip .exp_stage_* staging dirs mid-claim
            meta = _read_meta(os.path.join(self.uri, entry, "meta.yaml"))
            if "name" in meta:
                out[entry] = meta["name"]
        return out

    def get_experiment_by_name(self, name: str) -> Optional[str]:
        for exp_id, exp_name in self._experiments().items():
            if exp_name == name:
                return exp_id
        return None

    def _run_dir(self, run_id: str) -> str:
        for exp_id in self._experiments():
            cand = os.path.join(self.uri, exp_id, run_id)
            if os.path.isdir(cand):
                return cand
        raise KeyError(f"run not found: {run_id}")

    @staticmethod
    def _iter_keys(base: str):
        """All key files under base, as slash-relative key names (MLflow
        nests slash-namespaced keys as subdirectories)."""
        for d, _, files in os.walk(base):
            for fname in files:
                yield os.path.relpath(os.path.join(d, fname), base)

    def get_run(self, run_id: str, include_metrics: bool = True) -> Dict:
        """Run info/params (+ latest metric values unless
        ``include_metrics=False`` — callers that read full histories
        anyway can skip the extra parse of every metric file)."""
        rdir = self._run_dir(run_id)  # resolved ONCE per run (get_metric_
        # history would otherwise rescan every experiment per metric)
        meta = _read_meta(os.path.join(rdir, "meta.yaml"))
        params = {}
        pdir = os.path.join(rdir, "params")
        if os.path.isdir(pdir):
            for k in self._iter_keys(pdir):
                with open(os.path.join(pdir, k)) as f:
                    params[k] = f.read()
        metrics = {}
        mdir = os.path.join(rdir, "metrics")
        if include_metrics and os.path.isdir(mdir):
            for k in self._iter_keys(mdir):
                hist = self._metric_history_at(os.path.join(mdir, k))
                if hist:
                    metrics[k] = hist[-1].value
        return {"info": meta, "params": params, "metrics": metrics}

    @staticmethod
    def _metric_history_at(path: str) -> List[MetricPoint]:
        if not os.path.exists(path):
            return []
        out = []
        with open(path) as f:
            for line in f:
                parts = line.split()
                if len(parts) >= 3:
                    out.append(MetricPoint(int(parts[0]), float(parts[1]),
                                           int(parts[2])))
        return out

    def get_metric_history(self, run_id: str, key: str) -> List[MetricPoint]:
        return self._metric_history_at(
            os.path.join(self._run_dir(run_id), "metrics", key))

    def get_metric_histories(self, run_id: str) -> Dict[str,
                                                        List[MetricPoint]]:
        """All metric histories of a run with ONE run-dir resolution
        (per-key get_metric_history would rescan every experiment's
        meta.yaml per metric)."""
        mdir = os.path.join(self._run_dir(run_id), "metrics")
        if not os.path.isdir(mdir):
            return {}
        return {k: self._metric_history_at(os.path.join(mdir, k))
                for k in self._iter_keys(mdir)}

    def search_runs(self, experiment_name: str,
                    run_name: Optional[str] = None) -> List[Dict]:
        exp_id = self.get_experiment_by_name(experiment_name)
        if exp_id is None:
            return []
        out = []
        exp_dir = os.path.join(self.uri, exp_id)
        for entry in sorted(os.listdir(exp_dir)):
            rdir = os.path.join(exp_dir, entry)
            if not os.path.isdir(rdir):
                continue
            meta = _read_meta(os.path.join(rdir, "meta.yaml"))
            if run_name is None or meta.get("run_name") == run_name:
                out.append(self.get_run(entry))
        return out

    def list_artifacts(self, run_id: str, path: str = "") -> List[str]:
        adir = os.path.join(self._run_dir(run_id), "artifacts", path)
        if not os.path.isdir(adir):
            return []
        out = []
        for base, _, files in os.walk(adir):
            for fname in files:
                out.append(os.path.relpath(os.path.join(base, fname),
                                           os.path.join(self._run_dir(run_id),
                                                        "artifacts")))
        return sorted(out)

    def artifact_path(self, run_id: str, artifact: str) -> str:
        return os.path.join(self._run_dir(run_id), "artifacts", artifact)
