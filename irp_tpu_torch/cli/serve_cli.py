"""Online inference server of the PyTorch port: serve a trained model
over HTTP on the card (irp_tpu_torch/serve.py).

  # serve the final artifact on :8000
  python -m irp_tpu_torch.cli.serve_cli --weights final_model.npz \\
      --classes classes.json

  # score one JPEG; explain it (Grad-CAM overlay PNG, base64)
  curl -s -X POST --data-binary @cat.jpg -H 'Content-Type: image/jpeg' \\
      'http://127.0.0.1:8000/predict?topk=3'
  curl -s -X POST --data-binary @cat.jpg -H 'Content-Type: image/jpeg' \\
      'http://127.0.0.1:8000/explain'

  # with --allow-reload: swap the served weights with no downtime
  curl -s -X POST -H 'Content-Type: application/json' \\
      -d '{"weights": "new_model.npz"}' http://127.0.0.1:8000/reload

  # one replica per local card (one dispatch thread each), or each
  # batch split over the cards
  python -m irp_tpu_torch.cli.serve_cli --weights final_model.npz \\
      --replicas auto
  python -m irp_tpu_torch.cli.serve_cli --weights final_model.npz \\
      --data-parallel

--weights also takes an .irpx exported by predict_cli --export: its
programs fix the batch, the bucket ladder, TTA and the fused mode, and
it can be neither replicated nor split.  The
live weights serve the JAX package's unfused forward unless
--fused-frozen-blocks auto (or on) asks for the fused CUDA kernel.
"""

from __future__ import annotations

import argparse
import signal
import sys
import threading


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--weights", required=True,
                   help="final-weights artifact (.npz or torch .pth), or "
                        "an .irpx from predict_cli --export")
    p.add_argument("--classes", default=None,
                   help="class names: JSON file or comma-separated list")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--batch-size", type=int, default=64,
                   help="micro-batch cap = largest padded batch")
    p.add_argument("--window-ms", type=float, default=5.0,
                   help="max time the batcher waits to fill a batch")
    p.add_argument("--batch-buckets", default=None,
                   help="allowed padded batch sizes: 'auto' = the "
                        "1,2,4,...,batch-size ladder, or a comma list "
                        "ending at batch-size")
    p.add_argument("--image-size", type=int, default=None,
                   help="eval crop; default = the npz artifact's embedded "
                        "value, else 224")
    p.add_argument("--decoder", choices=["auto", "pil"], default="auto",
                   help="image decoder: auto = the native batch JPEG "
                        "decoder (irp_tpu_torch/data/jpeg.py) with PIL for "
                        "non-JPEGs and its misses, pil = PIL only")
    p.add_argument("--tta", action="store_true",
                   help="average the softmax over the identity and the "
                        "horizontal flip (~2x device time per dispatch)")
    p.add_argument("--fused-frozen-blocks", choices=["auto", "on", "off"],
                   default="off",
                   help="route the frozen identity bottlenecks through the "
                        "fused CUDA kernel: auto = on the card when "
                        "eligible, on = forced, off = never (the default, "
                        "the JAX package's unfused forward)")
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU instead of the card")
    p.add_argument("--verbose", action="store_true",
                   help="log each HTTP request")
    p.add_argument("--data-parallel", action="store_true",
                   help="split each batch over every local card (a local "
                        "mesh); on one card the same as without it")
    p.add_argument("--replicas", default=None,
                   help="'auto' (every local card) or N: a full model copy "
                        "per card, one dispatch thread each; the "
                        "alternative to --data-parallel")
    p.add_argument("--allow-reload", action="store_true",
                   help="enable POST /reload {\"weights\": path}: swap the "
                        "served model with no downtime (loaded and warmed "
                        "before the atomic swap, with this launch's flags); "
                        "off by default, as it lets HTTP clients make the "
                        "daemon read files")
    return p


def _local_device_count(cpu: bool) -> int:
    """Local devices a replica can take: the CUDA cards, or the one CPU
    device torch has."""
    import torch

    return 1 if cpu else torch.cuda.device_count()


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    is_irpx = args.weights.lower().endswith(".irpx")
    n_replicas = None
    if args.replicas is not None:
        if args.data_parallel:
            print("error: --replicas (a full model copy per device) and "
                  "--data-parallel (one batch split over devices) are "
                  "alternative strategies; pick one", file=sys.stderr)
            return 2
        if is_irpx:
            print("error: --replicas needs the live weights; an .irpx "
                  "program's device is baked", file=sys.stderr)
            return 2
        n_devices = _local_device_count(args.cpu)
        if args.replicas == "auto":
            n_replicas = n_devices
        else:
            try:
                n_replicas = int(args.replicas)
            except ValueError:
                print(f"error: --replicas must be 'auto' or an integer, "
                      f"got {args.replicas!r}", file=sys.stderr)
                return 2
            if not 1 <= n_replicas <= n_devices:
                print(f"error: --replicas {n_replicas} needs that many "
                      f"local devices, have {n_devices}", file=sys.stderr)
                return 2

    import numpy as np

    from irp_tpu_torch.infer import (load_class_names, load_predictor,
                                     replicate_predictor, serving_buckets)
    from irp_tpu_torch.serve import make_server

    class_names = load_class_names(args.classes) if args.classes else None
    if is_irpx and args.batch_buckets:
        print("error: an .irpx serves only the bucket ladder baked at "
              "export (predict_cli --export --export-batch-buckets ...); a "
              "bucketed artifact's ladder is used without this flag",
              file=sys.stderr)
        return 2
    device = "cpu" if args.cpu else "cuda"
    pad_buckets = None
    mesh = None

    def load(path, names=None):
        # the launch's flags; an .irpx fixes its own ladder (and refuses
        # a mesh: its device is fixed)
        return load_predictor(
            path, class_names=names, batch_size=args.batch_size,
            image_size=args.image_size,
            pad_buckets=(None if path.lower().endswith(".irpx")
                         else pad_buckets),
            tta=args.tta, device=device, mesh=mesh,
            fused_frozen_blocks=args.fused_frozen_blocks)

    try:
        if args.data_parallel:
            from irp_tpu_torch.parallel.mesh import make_mesh

            mesh = make_mesh(devices=["cpu"] if args.cpu else None)
        if args.batch_buckets:
            pad_buckets = serving_buckets(
                args.batch_buckets, args.batch_size,
                n_data=mesh.size if mesh is not None else 1)
        predictor = load(args.weights, class_names)
    except (ValueError, NotImplementedError, RuntimeError, OSError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    if predictor.source_size is not None:  # an .irpx: shapes are baked
        if predictor.source_size != 256:
            print(f"error: this artifact accepts only "
                  f"{predictor.source_size}x{predictor.source_size} "
                  "sources, but the daemon decodes requests to the 256x256 "
                  "cache contract; re-export with the default source size",
                  file=sys.stderr)
            return 2
        if args.batch_size != predictor.batch_size:
            print(f"note: the artifact fixes batch_size="
                  f"{predictor.batch_size}; --batch-size {args.batch_size} "
                  "is ignored", file=sys.stderr)
    # a reloaded artifact gets no launch-time --classes: the daemon keeps
    # the served names only where they fit, or takes the artifact's own
    loader = load if args.allow_reload else None
    served = (predictor if n_replicas is None
              else replicate_predictor(predictor, n=n_replicas))
    # bind first (fails fast on a busy port), then warm every served
    # batch size (cuDNN algorithm choice, kernel build) before traffic
    server = make_server(served, host=args.host, port=args.port,
                         window_ms=args.window_ms, decoder=args.decoder,
                         verbose=args.verbose, loader=loader,
                         weights_path=args.weights)
    cfg = predictor.model.config
    shapes = predictor.pad_buckets or (predictor.batch_size,)
    name = f"ResNet{cfg.depth}" if cfg.family == "resnet" else cfg.family
    where = (f"{n_replicas} replicas" if n_replicas
             else f"a {mesh.size}-device mesh" if mesh is not None
             else str(predictor.device))
    print(f"warming {name} forward on {where} "
          f"(crop {cfg.image_size}, batch sizes {list(shapes)}, "
          f"fused_frozen_blocks {cfg.fused_frozen_blocks}"
          f"{', exported program' if predictor.exported else ''}) ...",
          flush=True)
    for pred in server.batcher.predictors:
        for n in shapes:
            pred.predict_probs(np.zeros((n, 256, 256, 3), np.uint8))
    from irp_tpu_torch.data.jpeg import prepare

    why = prepare(args.decoder)  # build the decoder before the first request
    if why:
        print(f"note: the native JPEG decoder is unavailable, decoding "
              f"with PIL: {why}", file=sys.stderr)

    # SIGTERM drains like Ctrl-C: stop accepting, finish in-flight work
    draining = threading.Event()

    def _term(signum, frame):
        if draining.is_set():
            return
        draining.set()
        threading.Thread(target=server.shutdown, daemon=True).start()

    signal.signal(signal.SIGTERM, _term)
    print(f"serving on http://{args.host}:{server.port}  (POST /predict, "
          f"POST /explain{', POST /reload' if loader else ''}, GET /healthz, "
          f"GET /stats, GET /metrics)", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    draining.set()
    print("shutting down", flush=True)
    server.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
