"""One rank of the port's multi-process checks
(tests/test_torch_distributed.py, tests/test_torch_tensor_parallel*.py).

  python tests/torch_dist_child.py TASK RANK PORT DIR [WORLD]

Joins a WORLD-rank (default 2) gloo group on localhost:PORT (the CPU),
runs TASK on the inputs the test wrote to DIR and writes
DIR/out_TASK_RANK.pt.  It imports torch and the port only, as a rank of
a real run does; :func:`launch` is the parent's side.
"""

import contextlib
import hashlib
import json
import os
import socket
import subprocess
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


# -- the model axis (tests/test_torch_tensor_parallel*.py) -----------------

def _tp_mesh():
    """The (world / 2) x 2 process mesh."""
    from irp_tpu_torch.config import MeshConfig

    return make_mesh(MeshConfig(model=2))


def tp_basics(rank, d, _inputs):
    """This rank's coordinates and groups on the (d / 2) x 2 mesh: a sum
    over each of its groups, and a mesh that does not span the ranks."""
    from irp_tpu_torch.config import MeshConfig

    mesh = _tp_mesh()
    sums = {}
    for axis, group in (("model", mesh.model_group), ("data", mesh.group),
                        ("world", mesh.world_group)):
        t = torch.tensor([float(2 ** rank)])
        sums[axis] = float(distributed.all_reduce_sum(t, group))
    try:
        make_mesh(MeshConfig(data=d, model=2))
        refused = ""
    except ValueError as e:
        refused = str(e)
    return {"rank": mesh.rank, "index": mesh.index, "size": mesh.size,
            "model_index": mesh.model_index, "model_size": mesh.model_size,
            "shape": mesh.shape, "leader": mesh.is_leader, "sums": sums,
            "rows": str(mesh.rows(8)), "refused": refused,
            "global_batch": distributed.global_batch_for(4)}


def tp_forward(rank, d, inputs):
    """Each model's eval forward over the 1 x 2 mesh, its slices'
    shapes, whether the gathered weights and the unsharded forward are
    the whole ones, and the ValueErrors of layouts that do not split."""
    from irp_tpu_torch.models.classifier import Classifier
    from irp_tpu_torch.parallel.mesh import (gather_variables,
                                             shard_variables,
                                             unshard_variables)

    mesh = _tp_mesh()
    out = {}
    for name, case in inputs["models"].items():
        model = Classifier(ModelConfig(**case["cfg"]))
        model.load_state_dict(case["state_dict"])
        model = model.to(memory_format=torch.channels_last).eval()
        x = torch.from_numpy(case["x"]).permute(0, 3, 1, 2)
        with torch.no_grad():
            whole_logits = model(x)
        [model] = shard_variables(mesh, model)
        with torch.no_grad():
            logits = model(x)
        shapes = {k: tuple(v.shape) for k, v in model.state_dict().items()}
        gathered = gather_variables(mesh, model)
        unshard_variables(mesh, model)
        with torch.no_grad():
            back = model(x)
        out[name] = {
            "logits": logits, "whole_logits": whole_logits, "shapes": shapes,
            "gathered_whole": all(torch.equal(gathered[k], t) for k, t in
                                  case["state_dict"].items()),
            "unsharded_equal": torch.equal(back, whole_logits)}
    errors = {}
    for name, cfg in inputs["bad"].items():
        try:
            shard_variables(mesh, Classifier(ModelConfig(**cfg)))
            errors[name] = ""
        except ValueError as e:
            errors[name] = str(e)
    out["errors"] = errors
    return out


@contextlib.contextmanager
def _planted(fault, mesh):
    """A planted fault of tensor parallelism: 'g_backward', *g* with an
    all-reduce backward (``all_reduce_sum_autograd``); 'f_forward_only',
    *f* without its backward reduce; 'bias_first', the row bias added
    before the reduce; 'world_grads', the gradients summed over the
    world instead of the data group; None, the program as it is."""
    import torch.nn.functional as F

    from irp_tpu_torch.models import vit
    from irp_tpu_torch.parallel import tensor
    from irp_tpu_torch.train import step

    saved = [(tensor, "reduce_from_model"), (tensor, "copy_to_model"),
             (vit, "copy_to_model"), (step, "all_reduce_grads"),
             (tensor.RowParallelLinear, "forward")]
    saved = [(obj, name, getattr(obj, name)) for obj, name in saved]
    if fault == "g_backward":
        tensor.reduce_from_model = distributed.all_reduce_sum_autograd
    elif fault == "f_forward_only":
        tensor.copy_to_model = vit.copy_to_model = lambda x, group: x
    elif fault == "bias_first":
        def forward(self, x):
            dt = self.compute_dtype
            y = F.linear(x.to(dt), self.weight.to(dt), self.bias.to(dt))
            return distributed.reduce_from_model(y.float(),
                                                 self.group).to(dt)
        tensor.RowParallelLinear.forward = forward
    elif fault == "world_grads":
        grads = distributed.all_reduce_grads
        step.all_reduce_grads = lambda params, group: grads(
            params, mesh.world_group)
    elif fault is not None:
        raise ValueError(fault)
    try:
        yield
    finally:
        for obj, name, value in saved:
            setattr(obj, name, value)


def _digest(tensors: dict) -> str:
    """One hash of tensors by name, for bit-equality across ranks without
    writing the tensors."""
    h = hashlib.sha256()
    for name in sorted(tensors):
        h.update(name.encode())
        h.update(tensors[name].detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def update_gap(got: dict, old: dict, want: dict, names) -> float:
    """The largest, over ``names``, of max|got update - want update| /
    max|want update|."""
    worst = 0.0
    for n in names:
        update = want[n].double() - old[n].double()
        diff = got[n].double() - old[n].double() - update
        worst = max(worst, float(diff.abs().max() / update.abs().max()))
    return worst


def tp_step(rank, d, inputs):
    """One train step over the (d / 2) x 2 mesh on this rank's rows of
    the global batch, given the global draws: the clean step, each
    planted fault's, and with ``want_dropout`` the step with dropout
    drawn from a seeded generator and the remat step.  Each run's loss,
    accuracy, the hash of its whole weights (gathered) and its update
    gap (``update_gap`` over the ``trainable`` names) from its
    reference: ``want`` (the dropout run: ``want_dropout``, the remat
    run: the clean run's); the clean run's frozen tensors unchanged and
    its ``bn_keys`` tensors."""
    import dataclasses

    from irp_tpu_torch.models.resnet import sync_batch_stats
    from irp_tpu_torch.parallel.mesh import gather_variables, shard_variables
    from irp_tpu_torch.train.loop import set_mode
    from irp_tpu_torch.train.state import create_train_state
    from irp_tpu_torch.train.step import StepConfig, train_step

    mesh = _tp_mesh()
    base = ModelConfig(**inputs["cfg"])
    old, names = inputs["state_dict"], inputs["trainable"]
    b = inputs["images"].shape[0] // mesh.size
    rows = slice(mesh.index * b, (mesh.index + 1) * b)

    def run(want, fault=None, **over):
        cfg = dataclasses.replace(base, **over)
        scfg = StepConfig(intensity="medium", out_size=cfg.image_size,
                          compute_dtype=torch.float32,
                          mixup_alpha=inputs["mixup"],
                          grad_accum=inputs["accum"],
                          dropout_rate=cfg.dropout_rate)
        model = _model({**inputs, "cfg": dataclasses.asdict(cfg)})
        [model] = shard_variables(mesh, model)
        sync_batch_stats(model, mesh.group)
        set_mode(model, True)
        state = create_train_state(model, TrainConfig(**inputs["train"]),
                                   cfg, 1)
        gen = torch.Generator().manual_seed(inputs["generator_seed"])
        with _planted(fault, mesh):
            m = train_step(state, inputs["images"][rows],
                           inputs["labels"][rows], scfg,
                           inputs["class_weights"], gen,
                           aug_draws=inputs["aug_draws"],
                           mix_draws=inputs["mix_draws"], mesh=mesh)
        whole = gather_variables(mesh, model)
        return whole, {"loss": float(m["loss"]),
                       "accuracy": float(m["accuracy"]),
                       "digest": _digest(whole),
                       "gap": update_gap(whole, old, want, names)}

    out = {}
    clean, out["clean"] = run(inputs["want"])
    out["clean"]["frozen_unchanged"] = all(
        torch.equal(t, old[k]) for k, t in clean.items()
        if k not in names and k not in inputs["bn_keys"]
        and not k.endswith(("running_mean", "running_var",
                            "num_batches_tracked")))
    out["clean"]["bn"] = {k: clean[k] for k in inputs["bn_keys"]}
    for fault in inputs["faults"]:
        out[fault] = run(inputs["want"], fault)[1]
    if inputs.get("want_dropout") is not None:
        out["dropout"] = run(inputs["want_dropout"], dropout_rate=0.3)[1]
        out["remat"] = run(clean, remat_trainable_blocks=True)[1]
    return out


def tp_fit(rank, d, inputs):
    """Over the (d / 2) x 2 mesh: fit(mesh=) with validation; a checkpoint of
    a one-step Adam state written at model=2, and the parent's model=1
    checkpoint restored at model=2 (its tensors gathered back); then
    train_final_model(mesh=) with rank-own checkpoint and tracking
    directories."""
    from irp_tpu_torch import tracking
    from irp_tpu_torch.config import DatasetInfo
    from irp_tpu_torch.data.pipeline import CachedDataset
    from irp_tpu_torch.parallel.mesh import shard_variables
    from irp_tpu_torch.train.checkpoint import (_whole_state,
                                                restore_checkpoint,
                                                save_checkpoint)
    from irp_tpu_torch.train.final import train_final_model
    from irp_tpu_torch.train.fit import fit
    from irp_tpu_torch.train.state import create_train_state
    from irp_tpu_torch.train.step import StepConfig, train_step

    mesh = _tp_mesh()
    names = tuple(inputs["class_names"])

    def cached(images, labels):
        return CachedDataset(images=images, labels=labels,
                             keys=[str(i) for i in range(len(labels))],
                             class_names=names)

    train = cached(inputs["train_images"], inputs["train_labels"])
    val = cached(inputs["val_images"], inputs["val_labels"])
    info = DatasetInfo(**inputs["info"])
    out = {}
    cfg = ModelConfig(**inputs["fit_cfg"])
    tracking.set_tracking_uri(os.path.join(inputs["dir"], f"mlruns{rank}"))
    tracking.set_experiment("tp")
    with tracking.start_run(run_name="fit") as run:
        res = fit(train, val, info, cfg, TrainConfig(**inputs["train"]),
                  logger=run, mode="hbm", mesh=mesh)
    logged = tracking.TrackingClient().get_metric_histories(run.info.run_id)
    out.update(history=res.history, best=res.best_val_acc,
               val_acc_logged=[p.value for p in logged.get("val_acc", [])],
               fit_state={k: v.clone() for k, v in
                          res.state.model.state_dict().items()})

    ckpt = inputs["ckpt"]
    ccfg = ModelConfig(**ckpt["cfg"])
    scfg = StepConfig(intensity="medium", out_size=ccfg.image_size,
                      compute_dtype=torch.float32)

    def ckpt_state():
        model = _model({"cfg": ckpt["cfg"], "state_dict": ckpt["state_dict"]})
        [model] = shard_variables(mesh, model)
        return create_train_state(model, TrainConfig(**ckpt["train"]), ccfg,
                                  1)

    state = ckpt_state()
    b = ckpt["images"].shape[0] // mesh.size
    rows = slice(mesh.index * b, (mesh.index + 1) * b)
    train_step(state, ckpt["images"][rows], ckpt["labels"][rows], scfg,
               aug_draws=ckpt["aug_draws"], mesh=mesh)
    out["ckpt_path"] = save_checkpoint(os.path.join(inputs["dir"],
                                                    f"tp_ckpt{rank}"),
                                       state, mesh=mesh)
    out["ckpt_whole"] = _whole_state(mesh, state)
    restored = restore_checkpoint(ckpt["model1_path"], ckpt_state(),
                                  mesh=mesh)
    out["restored_local"] = restored.state_dict()
    out["restored_whole"] = _whole_state(mesh, restored)

    best = SimpleNamespace(params=inputs["final_params"], user_attrs={})
    study = SimpleNamespace(best_trial=best, get_trials=lambda: [best])
    final = train_final_model(
        study, train, val, info, model_base=ModelConfig(**inputs["final_cfg"]),
        train_base=TrainConfig(**inputs["train"]), mode="stream",
        checkpoint_dir=os.path.join(inputs["dir"], f"ckpt{rank}"),
        experiment="tp_final", verbose=False, mesh=mesh)
    out.update(final_acc=final.test_acc, final_run=final.run_id,
               final_state={k: v.clone() for k, v in
                            final.state.model.state_dict().items()})
    return out


TASKS = {"basics": basics, "step": step, "fit": fit_and_final,
         "tp_basics": tp_basics, "tp_forward": tp_forward,
         "tp_step": tp_step, "tp_fit": tp_fit}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def launch(task: str, root: str, inputs=None, world: int = 2,
           timeout: float = 300) -> list:
    """Every rank of ``task`` over a ``world``-rank gloo group on
    localhost, one process each (``inputs`` saved for them to DIR); their
    outputs, rank by rank.  A rank that fails fails the caller with its
    output's tail."""
    if inputs is not None:
        torch.save(inputs, os.path.join(root, f"in_{task}.pt"))
    port = str(_free_port())
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__),
                               task, str(r), port, root, str(world)],
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, text) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise AssertionError(f"rank {r} exited {p.returncode}:\n"
                                 f"{text[-4000:]}")
    return [torch.load(os.path.join(root, f"out_{task}_{r}.pt"),
                       weights_only=False) for r in range(world)]


def main():
    task, rank, port, root = sys.argv[1], int(sys.argv[2]), sys.argv[3], \
        sys.argv[4]
    world = int(sys.argv[5]) if len(sys.argv) > 5 else 2
    inputs = (torch.load(os.path.join(root, f"in_{task}.pt"),
                         weights_only=False)
              if os.path.exists(os.path.join(root, f"in_{task}.pt"))
              else {})
    distributed.initialize(coordinator_address=f"localhost:{port}",
                           num_processes=world, process_id=rank,
                           device="cpu")
    try:
        out = TASKS[task](rank, world, inputs)
    finally:
        distributed.shutdown()
    torch.save(out, os.path.join(root, f"out_{task}_{rank}.pt"))
    print(json.dumps({"rank": rank, "task": task, "ok": True}), flush=True)


if __name__ == "__main__":
    main()
