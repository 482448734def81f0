"""Experiment tracking: an MLflow-style file store (no mlflow
dependency), readable by the JAX package's tracking client."""

from irp_tpu_torch.tracking.store import (  # noqa: F401
    TrackingClient,
    active_run,
    end_run,
    get_tracking_uri,
    log_artifact,
    log_metrics,
    log_params,
    log_text,
    set_experiment,
    set_tracking_uri,
    start_run,
)
