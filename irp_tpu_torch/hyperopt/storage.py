"""SQLite study storage with resume.

Mirrors what the reference relies on from Optuna's RDBStorage: persistent
studies keyed by name in a sqlite file with ``load_if_exists=True`` resume
(reference functions/hyperopt.py:401-430, run_hyperopt.py:42-50), trial
params/values/intermediate values/user attrs.

A killed sweep continues where it left off: completed trials are reloaded,
RUNNING trials from the dead process are marked FAILED on load.  The
schema and the value encodings are the JAX package's, so a study database
either package writes, the other resumes.
"""

from __future__ import annotations

import json
import os
import sqlite3
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from irp_tpu_torch.hyperopt.distributions import dump_distribution, load_distribution

_SCHEMA = """
CREATE TABLE IF NOT EXISTS studies (
    study_id INTEGER PRIMARY KEY AUTOINCREMENT,
    study_name TEXT UNIQUE NOT NULL,
    direction TEXT NOT NULL DEFAULT 'maximize',
    created_at REAL
);
CREATE TABLE IF NOT EXISTS trials (
    trial_id INTEGER PRIMARY KEY AUTOINCREMENT,
    study_id INTEGER NOT NULL,
    number INTEGER NOT NULL,
    state TEXT NOT NULL,
    value REAL,
    datetime_start REAL,
    datetime_complete REAL,
    FOREIGN KEY (study_id) REFERENCES studies (study_id)
);
CREATE UNIQUE INDEX IF NOT EXISTS ix_trials_study_number
    ON trials (study_id, number);
CREATE TABLE IF NOT EXISTS trial_params (
    trial_id INTEGER NOT NULL,
    param_name TEXT NOT NULL,
    param_value TEXT NOT NULL,
    distribution TEXT NOT NULL,
    PRIMARY KEY (trial_id, param_name)
);
CREATE TABLE IF NOT EXISTS trial_intermediate_values (
    trial_id INTEGER NOT NULL,
    step INTEGER NOT NULL,
    value REAL NOT NULL,
    PRIMARY KEY (trial_id, step)
);
CREATE TABLE IF NOT EXISTS trial_user_attrs (
    trial_id INTEGER NOT NULL,
    key TEXT NOT NULL,
    value TEXT NOT NULL,
    PRIMARY KEY (trial_id, key)
);
"""


@dataclass
class FrozenTrial:
    trial_id: int
    number: int
    state: str  # RUNNING | COMPLETE | PRUNED | FAILED
    value: Optional[float]
    params: Dict[str, Any] = field(default_factory=dict)
    distributions: Dict[str, Any] = field(default_factory=dict)
    intermediate_values: Dict[int, float] = field(default_factory=dict)
    user_attrs: Dict[str, Any] = field(default_factory=dict)

    @property
    def last_step(self) -> Optional[int]:
        return max(self.intermediate_values) if self.intermediate_values else None


class SQLiteStorage:
    def __init__(self, path: str):
        self.path = path
        if path != ":memory:":
            d = os.path.dirname(os.path.abspath(path))
            os.makedirs(d, exist_ok=True)
        self._conn = sqlite3.connect(path, check_same_thread=False,
                                     timeout=30.0)
        self._lock = threading.Lock()
        with self._lock, self._conn:
            if path != ":memory:":
                # WAL + busy timeout: concurrent trial workers (threads or
                # separate processes a la Optuna distributed mode) contend
                # on this file.
                self._conn.execute("PRAGMA journal_mode=WAL")
                self._conn.execute("PRAGMA busy_timeout=30000")
            self._conn.executescript(_SCHEMA)

    # -- studies ---------------------------------------------------------
    def get_or_create_study(self, study_name: str,
                            direction: str = "maximize",
                            load_if_exists: bool = True,
                            fail_orphans: bool = True) -> int:
        with self._lock, self._conn:
            row = self._conn.execute(
                "SELECT study_id, direction FROM studies WHERE study_name=?",
                (study_name,)).fetchone()
            if row is not None:
                if not load_if_exists:
                    raise ValueError(f"study {study_name!r} already exists")
                if fail_orphans:
                    # mark orphaned RUNNING trials failed (dead-process
                    # resume).  Pass fail_orphans=False when joining a
                    # study that other worker processes are actively
                    # running against — their in-flight trials are not
                    # orphans.
                    self._conn.execute(
                        "UPDATE trials SET state='FAILED' "
                        "WHERE study_id=? AND state='RUNNING'", (row[0],))
                return row[0]
            try:
                cur = self._conn.execute(
                    "INSERT INTO studies (study_name, direction, "
                    "created_at) VALUES (?,?,?)",
                    (study_name, direction, time.time()))
                return cur.lastrowid
            except sqlite3.IntegrityError:
                # cross-process TOCTOU: another creator committed between
                # our SELECT and INSERT (two spawned workers racing
                # create_study on one db).  Re-read the winner's row.
                row = self._conn.execute(
                    "SELECT study_id FROM studies WHERE study_name=?",
                    (study_name,)).fetchone()
                if row is None:  # pragma: no cover — can't re-lose
                    raise
                if not load_if_exists:
                    raise ValueError(
                        f"study {study_name!r} already exists")
                return row[0]

    def find_study(self, study_name: str):
        """study_id for an existing study, or None — pure read, no
        creation, no orphan mutation (for viewers like run_dashboard)."""
        with self._lock:
            row = self._conn.execute(
                "SELECT study_id FROM studies WHERE study_name=?",
                (study_name,)).fetchone()
        return None if row is None else row[0]

    def study_direction(self, study_id: int) -> str:
        with self._lock:
            row = self._conn.execute(
                "SELECT direction FROM studies WHERE study_id=?",
                (study_id,)).fetchone()
        return row[0]

    # -- trials ----------------------------------------------------------
    def create_trial(self, study_id: int) -> FrozenTrial:
        # SELECT MAX + INSERT races across processes; the unique
        # (study_id, number) index turns a lost race into an
        # IntegrityError we retry (thread-level races are already
        # serialized by self._lock).
        for _ in range(64):
            with self._lock, self._conn:
                row = self._conn.execute(
                    "SELECT COALESCE(MAX(number), -1) + 1 FROM trials "
                    "WHERE study_id=?", (study_id,)).fetchone()
                number = row[0]
                try:
                    cur = self._conn.execute(
                        "INSERT INTO trials (study_id, number, state, "
                        "datetime_start) VALUES (?,?,?,?)",
                        (study_id, number, "RUNNING", time.time()))
                except sqlite3.IntegrityError:
                    continue  # another process claimed this number
                return FrozenTrial(trial_id=cur.lastrowid, number=number,
                                   state="RUNNING", value=None)
        raise RuntimeError("could not allocate a trial number")

    def set_param(self, trial_id: int, name: str, value: Any,
                  distribution) -> None:
        with self._lock, self._conn:
            self._conn.execute(
                "INSERT OR REPLACE INTO trial_params VALUES (?,?,?,?)",
                (trial_id, name, json.dumps(value),
                 dump_distribution(distribution)))

    def report_intermediate(self, trial_id: int, step: int,
                            value: float) -> None:
        with self._lock, self._conn:
            self._conn.execute(
                "INSERT OR REPLACE INTO trial_intermediate_values "
                "VALUES (?,?,?)", (trial_id, step, float(value)))

    def set_user_attr(self, trial_id: int, key: str, value: Any) -> None:
        with self._lock, self._conn:
            self._conn.execute(
                "INSERT OR REPLACE INTO trial_user_attrs VALUES (?,?,?)",
                (trial_id, key, json.dumps(value)))

    def finish_trial(self, trial_id: int, state: str,
                     value: Optional[float] = None) -> None:
        with self._lock, self._conn:
            self._conn.execute(
                "UPDATE trials SET state=?, value=?, datetime_complete=? "
                "WHERE trial_id=?", (state, value, time.time(), trial_id))

    def get_trials(self, study_id: int) -> List[FrozenTrial]:
        # Four study-scoped queries total, grouped in Python.  get_trials
        # runs on every suggest_* / pruner check / callback, so the naive
        # 3-queries-per-trial form is O(trials^2) sqlite traffic over a
        # sweep (and amplifies WAL contention in multi-process mode).
        with self._lock:
            rows = self._conn.execute(
                "SELECT trial_id, number, state, value FROM trials "
                "WHERE study_id=? ORDER BY number", (study_id,)).fetchall()
            by_id = {}
            trials = []
            for trial_id, number, state, value in rows:
                t = FrozenTrial(trial_id=trial_id, number=number, state=state,
                                value=value)
                by_id[trial_id] = t
                trials.append(t)
            for trial_id, name, pv, dist in self._conn.execute(
                    "SELECT p.trial_id, p.param_name, p.param_value, "
                    "p.distribution FROM trial_params p "
                    "JOIN trials tr ON tr.trial_id = p.trial_id "
                    "WHERE tr.study_id=?", (study_id,)):
                t = by_id.get(trial_id)
                if t is not None:
                    t.params[name] = json.loads(pv)
                    t.distributions[name] = load_distribution(dist)
            for trial_id, step, v in self._conn.execute(
                    "SELECT i.trial_id, i.step, i.value "
                    "FROM trial_intermediate_values i "
                    "JOIN trials tr ON tr.trial_id = i.trial_id "
                    "WHERE tr.study_id=?", (study_id,)):
                t = by_id.get(trial_id)
                if t is not None:
                    t.intermediate_values[step] = v
            for trial_id, key, v in self._conn.execute(
                    "SELECT a.trial_id, a.key, a.value "
                    "FROM trial_user_attrs a "
                    "JOIN trials tr ON tr.trial_id = a.trial_id "
                    "WHERE tr.study_id=?", (study_id,)):
                t = by_id.get(trial_id)
                if t is not None:
                    t.user_attrs[key] = json.loads(v)
        return trials

    def close(self):
        self._conn.close()
