"""Concurrent trials over the local devices (the JAX package's
``hyperopt/parallel.py``).

Small-model trials do not need every device: :func:`run_parallel_trials`
gives each worker thread a one-device mesh and runs one trial at a
time on it, every worker asking the shared study for its next trial.
(A trial's ``fit`` trains on one device: data-parallel training runs
one process per device, so a worker never holds more than one.)  The
SQLite storage is the coordination point (ask and tell are
thread-safe), so parallel trials compose with a study's resume.

Threads, not processes: the GIL serializes only host-side dispatch
while device work proceeds.  ``devices`` may repeat a device: workers
that share one card share its default stream, which is correct but
serializes their device work (two workers on one card are no faster
than one at the device; they overlap only host work).
"""

from __future__ import annotations

import math
import threading
import traceback
from typing import Callable, Optional, Sequence

import torch

from irp_tpu_torch.config import MeshConfig
from irp_tpu_torch.hyperopt.study import Study, TrialPruned, TrialState
from irp_tpu_torch.parallel.mesh import make_mesh


def run_parallel_trials(study: Study, objective_for_mesh: Callable,
                        n_trials: int,
                        max_workers: Optional[int] = None,
                        verbose: bool = False,
                        devices: Optional[Sequence] = None) -> None:
    """Run ``n_trials`` trials, scheduled over one-device meshes, one
    worker per device of ``devices``.

    ``objective_for_mesh(trial, mesh) -> float``: the objective receives
    the mesh its trial must run on (pass it as ``HyperoptContext.mesh``).
    ``devices``: the devices to deal out, every local CUDA device by
    default; a device may repeat.
    """
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
        if not devices:
            raise RuntimeError("no CUDA device is available; pass "
                               "devices=[torch.device('cpu'), ...]")
    devices = list(devices)
    n_workers = len(devices)
    if max_workers is not None:
        n_workers = min(n_workers, max_workers)
    n_workers = max(min(n_workers, n_trials), 1)

    meshes = [make_mesh(MeshConfig(data=1, model=1), devices=[dev])
              for dev in devices[:n_workers]]

    remaining = threading.Semaphore(n_trials)
    lock = threading.Lock()
    counter = {"done": 0}

    def _tell_safe(trial, state, value=None):
        try:
            study.tell(trial, state, value)
        except Exception:  # noqa: BLE001 — a storage hiccup: the trial
            traceback.print_exc()  # stays RUNNING, as an orphan

    def worker(mesh, wid):
        while remaining.acquire(blocking=False):
            # ask and tell hit the shared SQLite storage: an exception
            # there must not kill the worker and eat the trial budget
            try:
                trial = study.ask()
            except Exception:  # noqa: BLE001
                if verbose:
                    print(f"[worker {wid}] study.ask() failed:")
                    traceback.print_exc()
                continue
            try:
                value = objective_for_mesh(trial, mesh)
            except TrialPruned:
                _tell_safe(trial, TrialState.PRUNED)
                state = "PRUNED"
            except Exception as e:  # noqa: BLE001
                _tell_safe(trial, TrialState.FAILED)
                state = f"FAILED ({e!r})"
                if verbose:
                    traceback.print_exc()
            else:
                v = float(value)
                if math.isnan(v):
                    _tell_safe(trial, TrialState.FAILED)
                    state = "FAILED (nan)"
                else:
                    _tell_safe(trial, TrialState.COMPLETE, v)
                    state = f"{v:.3f}"
            with lock:
                counter["done"] += 1
                if verbose:
                    print(f"[worker {wid}] trial {trial.number}: {state} "
                          f"({counter['done']}/{n_trials})")

    threads = [threading.Thread(target=worker, args=(m, i), daemon=True)
               for i, m in enumerate(meshes)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
