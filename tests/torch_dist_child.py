"""One rank of the port's two-process checks (tests/test_torch_distributed.py).

  python tests/torch_dist_child.py TASK RANK PORT DIR

Joins a two-rank gloo group on localhost:PORT (the CPU), runs TASK on
the inputs the test wrote to DIR and writes DIR/out_TASK_RANK.pt.  It
imports torch and the port only, as a rank of a real run does.
"""

import json
import os
import sys
from types import SimpleNamespace

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from irp_tpu_torch.config import ModelConfig, TrainConfig  # noqa: E402
from irp_tpu_torch.parallel import distributed  # noqa: E402
from irp_tpu_torch.parallel.mesh import make_mesh  # noqa: E402

torch.set_num_threads(1)


def basics(rank, d, _inputs):
    shards = [f"s{i:02d}.tar" for i in range(10)]
    total = torch.tensor([float(rank + 1)])
    distributed.all_reduce_sum(total)
    mesh = make_mesh()
    return {"index": distributed.process_index(),
            "count": distributed.process_count(),
            "shards": distributed.host_shards(shards),
            "total": float(total), "mesh_size": mesh.size,
            "mesh_index": mesh.index, "rows": str(mesh.rows(8))}


def _model(inputs):
    from irp_tpu_torch.models.classifier import get_classifier
    from irp_tpu_torch.train.loop import set_mode

    model = get_classifier(ModelConfig(**inputs["cfg"]), device="cpu")
    model.load_state_dict(inputs["state_dict"])
    set_mode(model, True)
    return model


def step(rank, d, inputs):
    """One data-parallel train step on this rank's rows of the global
    batch, given the global batch's draws; with ``naive``, also the
    per-rank semantics a plain DDP average would give (each rank's own
    BN moments and loss denominator, gradients averaged)."""
    from irp_tpu_torch.models.resnet import sync_batch_stats
    from irp_tpu_torch.train.state import create_train_state
    from irp_tpu_torch.train.step import (StepConfig, augment_mix,
                                          loss_and_grads, train_step)

    mesh = make_mesh()
    cfg = ModelConfig(**inputs["cfg"])
    scfg = StepConfig(intensity="medium", out_size=cfg.image_size,
                      compute_dtype=torch.float32,
                      mixup_alpha=inputs["mixup"],
                      grad_accum=inputs["accum"], dropout_rate=0.0)
    b = inputs["images"].shape[0] // d
    rows = slice(rank * b, (rank + 1) * b)
    images = inputs["images"][rows]
    labels = inputs["labels"][rows]
    cw = inputs["class_weights"]
    model = _model(inputs)
    state = create_train_state(model, TrainConfig(**inputs["train"]), cfg, 1)
    sync_batch_stats(model, mesh.group)
    m = train_step(state, images, labels, scfg, cw,
                   aug_draws=inputs["aug_draws"],
                   mix_draws=inputs["mix_draws"], mesh=mesh)
    out = {"loss": float(m["loss"]), "accuracy": float(m["accuracy"]),
           "state_dict": {k: v.clone() for k, v in
                          model.state_dict().items()}}
    if inputs.get("naive"):
        naive = _model(inputs)
        x, ya, yb, lam = augment_mix(images, labels, scfg,
                                     inputs["aug_draws"].rows(rows),
                                     inputs["mix_draws"])
        loss, _ = loss_and_grads(naive, x, ya, scfg, cw, yb, lam)
        grads = {n: distributed.all_reduce_sum(p.grad.clone()) / d
                 for n, p in naive.named_parameters() if p.requires_grad}
        out["naive_grads"] = grads
        out["naive_loss"] = float(distributed.all_reduce_sum(
            loss.detach().clone())) / d
    return out


def fit_and_final(rank, d, inputs):
    """fit(mesh=) with a validation set, train_final_model(mesh=) with
    rank-own checkpoint and tracking directories, and sharded
    extract_features."""
    from irp_tpu_torch import tracking
    from irp_tpu_torch.config import DatasetInfo
    from irp_tpu_torch.data.outliers import extract_features
    from irp_tpu_torch.data.pipeline import CachedDataset
    from irp_tpu_torch.train.final import train_final_model
    from irp_tpu_torch.train.fit import fit

    mesh = make_mesh()
    names = tuple(inputs["class_names"])

    def cached(images, labels):
        return CachedDataset(images=images, labels=labels,
                             keys=[str(i) for i in range(len(labels))],
                             class_names=names)

    train = cached(inputs["train_images"], inputs["train_labels"])
    val = cached(inputs["val_images"], inputs["val_labels"])
    info = DatasetInfo(**inputs["info"])
    cfg = ModelConfig(**inputs["cfg"])
    tracking.set_tracking_uri(os.path.join(inputs["dir"], f"mlruns{rank}"))
    tracking.set_experiment("dp")
    with tracking.start_run(run_name="fit") as run:
        result = fit(train, val, info, cfg, TrainConfig(**inputs["train"]),
                     logger=run, mode=inputs["mode"], mesh=mesh)
    logged = tracking.TrackingClient().get_metric_histories(run.info.run_id)
    best = SimpleNamespace(params=inputs["final_params"], user_attrs={})
    study = SimpleNamespace(best_trial=best, get_trials=lambda: [best])
    final = train_final_model(
        study, train, val, info, model_base=cfg,
        train_base=TrainConfig(**inputs["train"]),
        checkpoint_dir=os.path.join(inputs["dir"], f"ckpt{rank}"),
        experiment="dp_final", verbose=False, mesh=mesh)
    feats, _, _ = extract_features(val, cfg, batch_size=4, mesh=mesh,
                                   state_dict=inputs["feature_weights"])
    out = {"history": result.history, "best": result.best_val_acc,
           "val_acc_logged": [p.value for p in logged.get("val_acc", [])],
           "final_acc": final.test_acc, "final_run": final.run_id,
           "features": feats,
           "final_state": {k: v.clone() for k, v in
                           final.state.model.state_dict().items()}}
    if rank == 0:
        out["features_single"], _, _ = extract_features(
            val, cfg, batch_size=4, device="cpu",
            state_dict=inputs["feature_weights"])
    return out


TASKS = {"basics": basics, "step": step, "fit": fit_and_final}


def main():
    task, rank, port, root = sys.argv[1], int(sys.argv[2]), sys.argv[3], \
        sys.argv[4]
    inputs = (torch.load(os.path.join(root, f"in_{task}.pt"),
                         weights_only=False)
              if os.path.exists(os.path.join(root, f"in_{task}.pt"))
              else {})
    distributed.initialize(coordinator_address=f"localhost:{port}",
                           num_processes=2, process_id=rank, device="cpu")
    try:
        out = TASKS[task](rank, 2, inputs)
    finally:
        distributed.shutdown()
    torch.save(out, os.path.join(root, f"out_{task}_{rank}.pt"))
    print(json.dumps({"rank": rank, "task": task, "ok": True}), flush=True)


if __name__ == "__main__":
    main()
