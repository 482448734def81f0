"""The port's tracking store against the JAX package's: a run that
either package logs is read by the other package's TrackingClient, and
concurrent creators of one experiment name get one id."""

import os
import sys
import threading

import pytest

from irp_tpu import tracking as jax_tracking
from irp_tpu_torch import tracking
from irp_tpu_torch.tracking import store


def _log_run(trk, root):
    trk.set_tracking_uri(root)
    trk.set_experiment("animals10")
    with trk.start_run(run_name="optuna_trial_0_kfold") as run:
        run.log_params({"learning_rate": 0.001, "batch_size": 16,
                        "recommended_epochs": 3})
        for step, acc in enumerate((61.5, 70.25, 68.0)):
            run.log_metrics({"epoch_avg_val_acc": acc, "val/acc": acc / 2},
                            step=step)
        run.set_tags({"stage": "hyperopt"})
        return run.info.run_id


def _read_run(client, run_id):
    run = client.get_run(run_id)
    hist = {k: [(p.value, p.step) for p in v]
            for k, v in client.get_metric_histories(run_id).items()}
    tags = dict(client._experiments())
    return run["params"], run["metrics"], run["info"]["status"], hist, tags


@pytest.mark.parametrize("writer", ["torch", "jax"])
def test_a_run_is_read_by_the_other_package(tmp_path, writer):
    trk = {"torch": tracking, "jax": jax_tracking}
    roots = {name: str(tmp_path / name) for name in trk}
    ids = {name: _log_run(mod, roots[name]) for name, mod in trk.items()}
    reader = "jax" if writer == "torch" else "torch"
    got = _read_run(trk[reader].TrackingClient(roots[writer]), ids[writer])
    want = _read_run(trk[writer].TrackingClient(roots[writer]), ids[writer])
    assert got == want
    params, metrics, status, hist, _ = got
    assert params["recommended_epochs"] == "3"
    assert hist["epoch_avg_val_acc"] == [(61.5, 0), (70.25, 1), (68.0, 2)]
    assert status == "FINISHED"
    # each package's layout is the other's
    assert _read_run(trk[reader].TrackingClient(roots[reader]),
                     ids[reader])[:4] == got[:4]
    for name in trk:
        run_dir = os.path.join(roots[name], "0", ids[name])
        assert sorted(os.listdir(run_dir)) == [
            "artifacts", "meta.yaml", "metrics", "params", "tags"]
        tag = os.path.join(run_dir, "tags", "stage")
        assert open(tag).read() == "hyperopt"


def test_concurrent_set_experiment_gets_one_id(tmp_path):
    """8 threads at a barrier, 50 times over: one id every time, one
    directory with the name, no staging directory left."""
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for trial in range(50):
            root = str(tmp_path / f"mlruns{trial}")
            tracking.set_tracking_uri(root)
            tracking.set_experiment(f"other{trial % 3}")
            n_threads, ids = 8, []
            lock = threading.Lock()
            barrier = threading.Barrier(n_threads, timeout=30)

            def claim():
                barrier.wait()
                exp_id = tracking.set_experiment("shared")
                with lock:
                    ids.append(exp_id)

            threads = [threading.Thread(target=claim)
                       for _ in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=30)
            assert not any(t.is_alive() for t in threads)
            assert len(ids) == n_threads
            assert len(set(ids)) == 1, f"trial {trial}: {sorted(set(ids))}"
            entries = os.listdir(root)
            assert all(e.isdigit() for e in entries), entries
            names = [store._read_meta(os.path.join(root, e, "meta.yaml"))
                     .get("name") for e in entries]
            assert names.count("shared") == 1
            assert jax_tracking.TrackingClient(root).get_experiment_by_name(
                "shared") == ids[0]
    finally:
        sys.setswitchinterval(interval)
