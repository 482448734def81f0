"""Online inference serving: a micro-batched HTTP daemon (the JAX
package's ``serve.py``).

Requests enqueue; one dispatch thread drains the queue up to ``max_batch``
images or ``window_ms``, whichever comes first, and runs ONE
``Predictor.predict_probs`` for the group, so the card sees full batches
while clients send one image at a time.  Given a list of replicas
(``infer.replicate_predictor``), one dispatch thread per replica drains
the one shared queue, so concurrent micro-batches run on their replicas'
devices at once.  Decoding (image -> 256x256 uint8,
the cache contract) happens in the HTTP handler threads.  Everything is
stdlib: ``http.server.ThreadingHTTPServer`` + ``queue`` + ``threading``.

Endpoints
---------
- ``GET /healthz``  — liveness + model card (family, ResNet depth,
  classes, crop size).
- ``GET /stats``    — request/batch counters, mean batch fill, latency
  percentiles (p50/p90/p99 over the last 1024 requests), and each
  replica's dispatches and images (``per_replica``).
- ``GET /metrics``  — the same counters in Prometheus text format.
- ``POST /predict`` — a raw image body, or JSON ``{"instances":
  ["<base64 image>", ...]}``; ``?topk=k`` sets how many (name, prob)
  pairs each prediction carries.
- ``POST /explain`` — the same bodies; each image's prediction and a
  Grad-CAM overlay PNG (base64) of the regions that drove it
  (``explain.py``); ``?class=i`` explains class i instead of the
  predicted one.  It runs in the handler thread, outside the batcher, at
  most ``max_concurrent_explains`` at a time (503 beyond).
- ``POST /reload`` — ``{"weights": "<path>"}``: swap the served model with
  no downtime (the new one is loaded, copied to every replica's device
  and every served batch size warmed before one atomic swap; on failure
  400 and the old model serves on).
  Only with a loader (``serve_cli --allow-reload``); 403 otherwise.
"""

from __future__ import annotations

import base64
import json
import math
import queue
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import List, Optional
from urllib.parse import parse_qs, urlparse

import numpy as np

from irp_tpu_torch.infer import Predictor

_STOP = object()


def latency_percentiles(latencies_ms, qs=(0.50, 0.90, 0.99),
                        digits: int = 3) -> Optional[dict]:
    """{"p50": ..., ...} nearest-rank percentiles, or None if empty."""
    lat = sorted(latencies_ms)
    if not lat:
        return None
    # nearest rank: ceil(q*n) as a 1-based rank
    n = len(lat)
    return {f"p{int(q * 100)}": round(
        lat[min(max(math.ceil(q * n) - 1, 0), n - 1)], digits)
        for q in qs}


class ServerOverloadedError(RuntimeError):
    """The request queue is full — shed load instead of growing it."""


class ReloadDisabledError(RuntimeError):
    """POST /reload on a daemon launched without a loader (HTTP 403); its
    own type, so that the 403 never swallows a failed load."""


@dataclass
class _Pending:
    """One enqueued request: n images awaiting a shared dispatch."""

    images: np.ndarray                  # (n, H, W, 3) uint8
    event: threading.Event = field(default_factory=threading.Event)
    result: Optional[np.ndarray] = None  # (n, num_classes) float32
    error: Optional[BaseException] = None
    t_enqueue: float = field(default_factory=time.monotonic)
    cancelled: bool = False             # waiter gave up; skip the forward
    # the predictor that served this request, set at dispatch: a hot
    # reload can never pair one model's probabilities with another's names
    predictor: Optional[Predictor] = None

    def wait(self, timeout: Optional[float] = None) -> np.ndarray:
        if not self.event.wait(timeout):
            self.cancelled = True
            raise TimeoutError("inference request timed out")
        if self.error is not None:
            raise self.error
        return self.result


class MicroBatcher:
    """Groups concurrent requests into single padded-batch dispatches.

    ``predictor`` is one Predictor or a list of replicas (one dispatch
    thread each, slot i always serving ``predictors[i]``).  Each thread is
    started with its own stop token, so a thread that outlives a timed-out
    ``stop()`` (a dispatch stuck on the device) exits when it wakes, and a
    later ``start()`` never leaves two dispatchers serving one replica.
    """

    def __init__(self, predictor, max_batch: Optional[int] = None,
                 window_ms: float = 5.0, autostart: bool = True,
                 max_pending: Optional[int] = None):
        preds = (list(predictor) if isinstance(predictor, (list, tuple))
                 else [predictor])
        if not preds:
            raise ValueError("need at least one predictor")
        if len(preds) > 1 and len({
                (p.batch_size, p.pad_buckets, p.model.config.image_size,
                 p.num_classes) for p in preds}) != 1:
            raise ValueError(
                "replicas must share batch_size/pad_buckets/crop/classes: "
                "build them with replicate_predictor from one base")
        self.predictors: List[Predictor] = preds
        self.max_batch = (preds[0].batch_size if max_batch is None
                          else int(max_batch))
        if self.max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {self.max_batch}")
        self.window_s = max(float(window_ms), 0.0) / 1e3
        # bounded queue = load shedding (-> HTTP 503), ~8 batches of
        # backlog per dispatch thread
        self.max_pending = (max(64, 8 * self.max_batch) * len(preds)
                            if max_pending is None else int(max_pending))
        self._queue: queue.Queue = queue.Queue(maxsize=self.max_pending)
        # (thread, stop token) per replica slot
        self._slots: List[Optional[tuple]] = [None] * len(preds)
        self._stopped = False
        self._lock = threading.Lock()
        self._stats = {"requests": 0, "images": 0, "batches": 0,
                       "batch_images_sum": 0, "errors": 0, "rejected": 0,
                       "cancelled": 0}
        self._replica_stats = [{"batches": 0, "images": 0} for _ in preds]
        self._latencies_ms: deque = deque(maxlen=1024)
        if autostart:
            self.start()

    @property
    def predictor(self) -> Predictor:
        """The served model (the first replica when there are several)."""
        return self.predictors[0]

    @predictor.setter
    def predictor(self, value: Predictor) -> None:
        if len(self.predictors) > 1:
            # one assignment would collapse the replica set to one device
            raise ValueError("this batcher serves replicas; assign a full "
                             "list to .predictors instead")
        self.predictors = [value]

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> None:
        with self._lock:
            self._stopped = False
            for idx, slot in enumerate(self._slots):
                if (slot is not None and slot[0].is_alive()
                        and not slot[1].is_set()):
                    continue  # this replica is served
                token = threading.Event()
                thread = threading.Thread(
                    target=self._run, args=(token, idx), daemon=True,
                    name="irp-torch-microbatch" + (f"-{idx}" if idx
                                                   else ""))
                thread.start()
                self._slots[idx] = (thread, token)

    def stop(self, timeout: float = 10.0) -> None:
        with self._lock:
            self._stopped = True
            slots = [s for s in self._slots if s is not None]
            self._slots = [None] * len(self._slots)
        for _, token in slots:
            token.set()
            try:
                self._queue.put_nowait(_STOP)  # fast wake; never block
            except queue.Full:
                pass
        # one shared deadline: N stuck threads do not stretch stop()
        deadline = time.monotonic() + timeout
        for thread, _ in slots:
            thread.join(max(0.0, deadline - time.monotonic()))
        self._drain_reject(RuntimeError("batcher stopped"))

    def _drain_reject(self, exc: BaseException) -> None:
        while True:
            try:
                item = self._queue.get_nowait()
            except queue.Empty:
                return
            if item is _STOP:
                continue
            item.error = exc
            item.event.set()

    # -- client side -------------------------------------------------------
    def submit_async(self, images_u8: np.ndarray) -> _Pending:
        """Enqueue (n,H,W,3) uint8; returns a handle to ``wait()`` on.

        Raises ``ValueError`` for malformed/undersized input (validated
        here, so a bad request never poisons its co-batched neighbors)
        and :class:`ServerOverloadedError` when the queue is full.
        """
        images_u8 = np.ascontiguousarray(images_u8, np.uint8)
        if images_u8.ndim == 3:
            images_u8 = images_u8[None]
        if images_u8.ndim != 4 or images_u8.shape[-1] != 3:
            raise ValueError(
                f"expected (n,H,W,3) uint8, got {images_u8.shape}")
        if images_u8.shape[0] == 0:
            raise ValueError("empty request")
        crop = self.predictor.model.config.image_size
        h, w = images_u8.shape[1:3]
        if h < crop or w < crop:
            raise ValueError(
                f"images are {h}x{w} but the model's eval crop is "
                f"{crop}x{crop}")
        if self._stopped:
            raise RuntimeError("batcher stopped")
        pending = _Pending(images=images_u8)
        try:
            self._queue.put_nowait(pending)
        except queue.Full:
            with self._lock:
                self._stats["rejected"] += 1
            raise ServerOverloadedError(
                f"request queue full ({self.max_pending} pending)") from None
        if self._stopped:
            # raced stop(): its drain may already have run
            self._drain_reject(RuntimeError("batcher stopped"))
        with self._lock:
            self._stats["requests"] += 1
            self._stats["images"] += int(images_u8.shape[0])
        return pending

    def submit(self, images_u8: np.ndarray,
               timeout: Optional[float] = 60.0) -> np.ndarray:
        """Blocking score: (n,H,W,3) uint8 -> (n,num_classes) float32."""
        return self.submit_async(images_u8).wait(timeout)

    # -- dispatch thread ---------------------------------------------------
    def _run(self, token: threading.Event, idx: int = 0) -> None:
        while not token.is_set():
            try:
                item = self._queue.get(timeout=0.25)
            except queue.Empty:
                continue
            if item is _STOP:
                continue  # the loop condition reads the token
            group: List[_Pending] = [item]
            total = int(item.images.shape[0])
            deadline = time.monotonic() + self.window_s
            while total < self.max_batch and not token.is_set():
                remaining = deadline - time.monotonic()
                try:
                    nxt = (self._queue.get_nowait() if remaining <= 0
                           else self._queue.get(timeout=remaining))
                except queue.Empty:
                    break
                if nxt is _STOP:
                    break
                group.append(nxt)
                total += int(nxt.images.shape[0])
            self._dispatch(group, idx)

    def _dispatch(self, group: List[_Pending], idx: int = 0) -> None:
        live = [p for p in group if not p.cancelled]
        if len(live) < len(group):
            with self._lock:
                self._stats["cancelled"] += len(group) - len(live)
            for p in group:
                if p.cancelled:
                    p.event.set()
        # mixed spatial sizes cannot share one forward
        buckets: dict = {}
        for p in live:
            buckets.setdefault(p.images.shape[1:3], []).append(p)
        for bucket in buckets.values():
            self._dispatch_same_shape(bucket, idx)

    def _dispatch_same_shape(self, group: List[_Pending],
                             idx: int = 0) -> None:
        # one read: a hot reload swaps .predictors between dispatches
        preds = self.predictors
        predictor = preds[idx % len(preds)]
        for p in group:
            p.predictor = predictor
        try:
            images = (group[0].images if len(group) == 1 else
                      np.concatenate([p.images for p in group], axis=0))
            probs = predictor.predict_probs(images)
        except Exception as e:  # noqa: BLE001 — delivered to the waiters
            with self._lock:
                self._stats["errors"] += len(group)
            for p in group:
                p.error = e
                p.event.set()
            return
        done = time.monotonic()
        off = 0
        for p in group:
            n = int(p.images.shape[0])
            p.result = probs[off:off + n]
            off += n
            p.event.set()
        with self._lock:
            self._stats["batches"] += 1
            self._stats["batch_images_sum"] += off
            mine = self._replica_stats[idx % len(self._replica_stats)]
            mine["batches"] += 1
            mine["images"] += off
            for p in group:
                self._latencies_ms.append((done - p.t_enqueue) * 1e3)

    # -- observability -----------------------------------------------------
    def stats(self) -> dict:
        with self._lock:
            s = dict(self._stats)
            lat = list(self._latencies_ms)
            s["per_replica"] = [
                {"device": str(p.device), **r}
                for p, r in zip(self.predictors, self._replica_stats)]
        s["mean_batch_fill"] = (s["batch_images_sum"] / s["batches"]
                                if s["batches"] else 0.0)
        pcts = latency_percentiles(lat)
        if pcts is not None:
            s["latency_ms"] = pcts
        return s


def _topk_rows(probs: np.ndarray, names, topk: int) -> List[dict]:
    """Per-image {label, label_name, topk: [...]} dicts from (N, K)
    softmax."""
    k = max(1, min(topk, probs.shape[1]))
    idx = np.argsort(-probs, axis=1)[:, :k]
    rows = []
    for i in range(probs.shape[0]):
        label = int(idx[i, 0])
        rows.append({
            "label": label,
            "label_name": (names[label] if names else str(label)),
            "topk": [{"label": int(j),
                      "name": (names[int(j)] if names else str(int(j))),
                      "prob": round(float(probs[i, j]), 6)}
                     for j in idx[i]]})
    return rows


class _Handler(BaseHTTPRequestHandler):
    """Routes the endpoints onto the owning server's batcher."""

    server: "InferenceServer"
    protocol_version = "HTTP/1.1"
    # socket timeout: a client that stalls mid-body must not pin a
    # handler thread forever
    timeout = 120.0

    def log_message(self, fmt, *args):  # quiet by default
        if self.server.verbose:
            super().log_message(fmt, *args)

    def _send_json(self, code: int, payload: dict) -> None:
        body = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):  # noqa: N802 — BaseHTTPRequestHandler contract
        path = urlparse(self.path).path
        if path == "/healthz":
            cfg = self.server.batcher.predictor.model.config
            self._send_json(200, {
                "status": "ok",
                "uptime_s": round(time.monotonic() - self.server.t_start, 1),
                "generation": self.server.generation,
                "weights": self.server.weights_path,
                "device": str(self.server.batcher.predictor.device),
                "replicas": len(self.server.batcher.predictors),
                # depth is a ResNet field: another family's would be the
                # dataclass default
                "model": {"family": cfg.family,
                          **({"depth": cfg.depth}
                             if cfg.family == "resnet" else {}),
                          "num_classes": cfg.num_classes,
                          "image_size": cfg.image_size,
                          "class_names": list(self.server.class_names or [])
                          or None}})
        elif path == "/stats":
            stats = self.server.batcher.stats()
            stats["explain"] = self.server.explain_stats()
            self._send_json(200, stats)
        elif path == "/metrics":
            body = self.server.metrics_text().encode()
            self.send_response(200)
            self.send_header("Content-Type",
                             "text/plain; version=0.0.4; charset=utf-8")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
        else:
            self._send_json(404, {"error": f"unknown path {path}"})

    def _do_reload(self, body: bytes) -> None:
        try:
            payload = json.loads(body)
            weights = (payload.get("weights") if isinstance(payload, dict)
                       else None)
            if not isinstance(weights, str) or not weights:
                raise ValueError('body must be {"weights": "<path>"}')
        except ValueError as e:
            self._send_json(400, {"error": f"bad request: {e}"})
            return
        try:
            result = self.server.reload_weights(weights)
        except ReloadDisabledError as e:
            self._send_json(403, {"error": str(e)})
            return
        except Exception as e:  # noqa: BLE001 — a bad artifact, a failed
            # load or warm-up: the old model serves on, and the client
            # gets an answer
            self._send_json(400, {"error": f"reload failed: {e}",
                                  "generation": self.server.generation})
            return
        self._send_json(200, result)

    def do_POST(self):  # noqa: N802
        parsed = urlparse(self.path)
        if parsed.path not in ("/predict", "/explain", "/reload"):
            # body unread: keep-alive would misparse it as the next request
            self.close_connection = True
            self._send_json(404, {"error": f"unknown path {parsed.path}"})
            return
        try:
            query = parse_qs(parsed.query)
            topk = int(query.get("topk", ["1"])[0])
            explain_cls = None
            if parsed.path == "/explain":
                # /predict does not read 'class', so it never 400s on it
                cls_q = query.get("class", [None])[0]
                explain_cls = None if cls_q is None else int(cls_q)
            length = int(self.headers.get("Content-Length") or 0)
        except ValueError:
            self.close_connection = True
            self._send_json(400, {"error": "topk, class and Content-Length "
                                           "must be integers"})
            return
        if length <= 0:
            self._send_json(400, {"error": "empty request body"})
            return
        if length > self.server.max_request_bytes:
            self.close_connection = True
            self._send_json(413, {"error": "request body too large"})
            return
        body = self.rfile.read(length)
        if parsed.path == "/reload":
            self._do_reload(body)
            return
        ctype = (self.headers.get("Content-Type") or "").split(";")[0].strip()
        try:
            if ctype == "application/json":
                payload = json.loads(body)
                b64s = (payload.get("instances")
                        if isinstance(payload, dict) else None)
                if (not isinstance(b64s, list) or not b64s
                        or not all(isinstance(s, (str, bytes))
                                   for s in b64s)):
                    raise ValueError(
                        "JSON body must be {\"instances\": [<base64>, ...]}")
                blobs = [base64.b64decode(s, validate=True) for s in b64s]
            else:
                blobs = [body]
            from irp_tpu_torch.data.pipeline import decode_blobs

            images = decode_blobs(blobs, decoder=self.server.decoder)
        except Exception as e:  # noqa: BLE001 — any unparseable body is
            # the client's fault and gets an answer, not a dropped socket
            self._send_json(400, {"error": f"bad request: {e}"})
            return
        if parsed.path == "/explain":
            self._do_explain(images, topk, explain_cls)
            return
        t0 = time.monotonic()
        try:
            pending = self.server.batcher.submit_async(images)
            probs = pending.wait(timeout=self.server.request_timeout_s)
        except (TimeoutError, ServerOverloadedError) as e:
            self._send_json(503, {"error": str(e)})
            return
        except Exception as e:  # noqa: BLE001 — surfaced to the client
            self._send_json(500, {"error": f"inference failed: {e}"})
            return
        # the names of the predictor that served this dispatch
        preds = _topk_rows(probs, pending.predictor.class_names, topk)
        self._send_json(200, {
            "predictions": preds, "n": len(preds),
            "latency_ms": round((time.monotonic() - t0) * 1e3, 3)})

    def _do_explain(self, images: np.ndarray, topk: int,
                    explain_cls: Optional[int]) -> None:
        """Grad-CAM of each image: its prediction and an overlay PNG
        (base64).  Runs in this handler thread, not through the batcher;
        throughput belongs to /predict."""
        import io

        from PIL import Image

        from irp_tpu_torch.explain import center_crop_u8, overlay_cam
        from irp_tpu_torch.infer import softmax_np

        if not self.server._explain_slots.acquire(blocking=False):
            self._send_json(503, {"error": "explain capacity saturated; "
                                           "retry shortly"})
            return
        t0 = time.monotonic()
        # an error is answered after the slot is released, so that a
        # client's next /explain never finds this one's slot still held
        error = None
        try:
            # ONE snapshot: validation, maps and names all come from this
            # GradCAM's predictor, whatever a concurrent reload does
            gc = self.server.gradcam()
            predictor = gc.predictor
            num_classes = predictor.num_classes
            if explain_cls is not None and not 0 <= explain_cls < num_classes:
                error = (400, {"error": f"class must be in "
                                        f"[0, {num_classes})"})
                return
            n = images.shape[0]
            if predictor.tta:
                # the explain program is single-view: report the
                # flip-averaged scores /predict serves, and explain the
                # class they pick
                probs = gc.tta_scorer.predict_probs(images)
                cls = (np.argmax(probs, axis=1).astype(np.int32)
                       if explain_cls is None
                       else np.full((n,), explain_cls, np.int32))
                cams, _ = gc.explain(images, class_idx=cls)
            else:
                cams, logits = gc.explain(
                    images, class_idx=(None if explain_cls is None else
                                       np.full((n,), explain_cls, np.int32)))
                probs = softmax_np(logits)
        except Exception as e:  # noqa: BLE001 — surfaced to the client
            error = (500, {"error": f"explain failed: {e}"})
            return
        finally:
            self.server._explain_slots.release()
            if error is not None:
                self._send_json(*error)
        self.server.record_explain(int(images.shape[0]),
                                   (time.monotonic() - t0) * 1e3)
        cropped = center_crop_u8(images, predictor.model.config.image_size)
        rows = _topk_rows(probs, predictor.class_names, topk)
        for i, row in enumerate(rows):
            buf = io.BytesIO()
            Image.fromarray(overlay_cam(cropped[i], cams[i])).save(buf, "PNG")
            row["explained_class"] = (explain_cls if explain_cls is not None
                                      else row["label"])
            row["cam_png_b64"] = base64.b64encode(buf.getvalue()).decode()
        self._send_json(200, {
            "explanations": rows, "n": len(rows),
            "latency_ms": round((time.monotonic() - t0) * 1e3, 3)})


class InferenceServer(ThreadingHTTPServer):
    """HTTP front end over a :class:`MicroBatcher`.

    Build via :func:`make_server`; ``.start()`` serves on a daemon thread
    (tests, embedding), ``.serve_forever()`` blocks (CLI).  ``loader`` (a
    ``path -> Predictor`` callable) enables ``POST /reload``.
    """

    daemon_threads = True
    request_queue_size = 128

    def __init__(self, address, batcher: MicroBatcher, class_names=None,
                 decoder: str = "auto", request_timeout_s: float = 60.0,
                 max_request_bytes: int = 64 * 1024 * 1024,
                 max_concurrent_explains: int = 2, verbose: bool = False,
                 loader=None, weights_path: Optional[str] = None):
        self.batcher = batcher
        self.class_names = list(class_names) if class_names else None
        n = batcher.predictor.num_classes
        if self.class_names is not None and len(self.class_names) != n:
            raise ValueError(f"{len(self.class_names)} class names for a "
                             f"{n}-class model")
        if self.class_names is not None:
            # the predictor names each dispatch's answers (_Pending): every
            # replica carries the served names
            for p in batcher.predictors:
                p.class_names = self.class_names
        self.decoder = decoder
        self.request_timeout_s = request_timeout_s
        self.max_request_bytes = max_request_bytes
        self.verbose = verbose
        self.weights_path = weights_path
        self.t_start = time.monotonic()
        self._thread: Optional[threading.Thread] = None
        self._gradcam = None
        self._gradcam_lock = threading.Lock()
        self._explain_stats = {"requests": 0, "images": 0}
        self._explain_latencies_ms: deque = deque(maxlen=1024)
        # /explain bypasses the batcher's queue bound, so it has its own
        self._explain_slots = threading.BoundedSemaphore(
            max(1, int(max_concurrent_explains)))
        self._loader = loader
        self._reload_lock = threading.Lock()
        self.generation = 0
        super().__init__(address, _Handler)

    def gradcam(self):
        """The shared :class:`~irp_tpu_torch.explain.GradCAM`, built at the
        first /explain at batch ``min(8, batch_size)`` (an ``.irpx``: its
        baked batch), with ``tta_scorer``: the predictor that scores a TTA
        model's explanations (for live weights a clone at the same small
        batch that shares the served model)."""
        with self._gradcam_lock:
            if self._gradcam is None:
                from irp_tpu_torch.explain import GradCAM

                p = self.batcher.predictor
                gc = (GradCAM(p) if p.exported
                      else GradCAM(p, batch_size=min(8, p.batch_size)))
                gc.tta_scorer = p
                if p.tta and not p.exported:
                    gc.tta_scorer = Predictor(
                        model=p.model, class_names=p.class_names,
                        batch_size=min(8, p.batch_size), tta=True,
                        device=p.device)
                self._gradcam = gc
            return self._gradcam

    def reload_weights(self, weights_path: str) -> dict:
        """Serve ``weights_path`` instead, with no downtime: the new
        predictor is loaded and every served batch size run once BEFORE
        the swap, which is one attribute write (a dispatch in flight ends
        on the old weights, the next reads the new).  The shared Grad-CAM
        is dropped and rebuilt over the new weights.

        Raises :class:`ReloadDisabledError` without a loader and
        ``ValueError`` for an artifact the daemon cannot serve; any error
        leaves the old model serving."""
        if self._loader is None:
            raise ReloadDisabledError(
                "hot reload is disabled; launch serve_cli with "
                "--allow-reload (or pass make_server(loader=...))")
        with self._reload_lock:  # one reload at a time
            new = self._loader(weights_path)
            if new.source_size not in (None, 256):
                raise ValueError(
                    f"this artifact accepts only {new.source_size}x"
                    f"{new.source_size} sources, but the daemon decodes "
                    "requests to the 256x256 cache contract")
            if new.class_names is not None:
                names = list(new.class_names)
            elif (self.class_names is not None
                    and len(self.class_names) == new.num_classes):
                names = self.class_names  # still valid, kept
            elif self.class_names is not None:
                raise ValueError(
                    f"served class names ({len(self.class_names)}) do not "
                    f"fit the new {new.num_classes}-class model, and the "
                    "artifact carries none; reload with an artifact that "
                    "embeds class names")
            else:
                names = None
            olds = self.batcher.predictors
            news = [new]
            if len(olds) > 1:
                from irp_tpu_torch.infer import (predictor_device,
                                                 replicate_predictor)

                devices = [predictor_device(p) for p in olds]
                if any(d is None for d in devices):
                    raise ValueError("cannot recover the replica devices of "
                                     "the serving set; restart the daemon "
                                     "to reload")
                news = replicate_predictor(new, devices=devices)
            # every served shape runs on every replica before the swap (the
            # first run of a shape picks cuDNN's algorithms and builds the
            # kernels)
            for pred in news:
                for n in (pred.pad_buckets or (1,)):
                    pred.predict_probs(np.zeros((n, 256, 256, 3), np.uint8))
                pred.class_names = names
            old = olds[0]
            self.batcher.predictors = news  # atomic: dispatches read once
            if self.batcher.max_batch == old.batch_size:
                # the cap came from the old batch; track the new one
                self.batcher.max_batch = new.batch_size
            self.class_names = names
            with self._gradcam_lock:
                self._gradcam = None
            self.generation += 1
            self.weights_path = weights_path
            return {"reloaded": weights_path, "generation": self.generation,
                    "num_classes": int(new.num_classes),
                    "previous_num_classes": int(old.num_classes),
                    "replicas": len(news), "class_names": names}

    def record_explain(self, n_images: int, latency_ms: float) -> None:
        with self._gradcam_lock:
            self._explain_stats["requests"] += 1
            self._explain_stats["images"] += n_images
            self._explain_latencies_ms.append(latency_ms)

    def explain_stats(self) -> dict:
        """/explain's counters and latency percentiles (p50/p90/p99 over
        its last 1024 requests)."""
        with self._gradcam_lock:
            s = dict(self._explain_stats)
            lat = list(self._explain_latencies_ms)
        pcts = latency_percentiles(lat)
        if pcts is not None:
            s["latency_ms"] = pcts
        return s

    def metrics_text(self) -> str:
        """Prometheus text exposition (0.0.4) of the daemon's counters."""
        stats = self.batcher.stats()
        explain = self.explain_stats()
        cfg = self.batcher.predictor.model.config
        lines = []

        def metric(name, mtype, value, help_text, labels=""):
            lines.append(f"# HELP {name} {help_text}")
            lines.append(f"# TYPE {name} {mtype}")
            lines.append(f"{name}{labels} {value}")

        for key, help_text in (
                ("requests", "predict requests accepted"),
                ("images", "images scored by /predict"),
                ("batches", "device dispatches"),
                ("batch_images_sum", "images summed over dispatches"),
                ("rejected", "requests shed at the queue-depth bound"),
                ("cancelled", "requests abandoned before dispatch"),
                ("errors", "requests failed inside dispatch")):
            metric(f"irp_{key}_total", "counter", int(stats[key]), help_text)
        for key, help_text in (("requests", "explain requests served"),
                               ("images", "images explained")):
            metric(f"irp_explain_{key}_total", "counter", int(explain[key]),
                   help_text)
        metric("irp_batch_fill_mean", "gauge",
               round(float(stats["mean_batch_fill"]), 4),
               "mean images per device dispatch")
        for scope, payload in (("", stats), ("explain_", explain)):
            for pct, value in (payload.get("latency_ms") or {}).items():
                metric(f"irp_{scope}latency_ms_{pct}", "gauge",
                       round(float(value), 3),
                       f"{pct} request latency over the last 1024 requests "
                       "(ms)")
        metric("irp_uptime_seconds", "gauge",
               round(time.monotonic() - self.t_start, 1),
               "seconds since daemon start")
        metric("irp_reloads_total", "counter", self.generation,
               "successful hot weight reloads")
        depth_label = (f'depth="{cfg.depth}",' if cfg.family == "resnet"
                       else "")
        metric("irp_model_info", "gauge", 1,
               "model identity (labels carry the values)",
               labels=(f'{{family="{cfg.family}",{depth_label}'
                       f'num_classes="{cfg.num_classes}",'
                       f'image_size="{cfg.image_size}",'
                       f'device="{self.batcher.predictor.device}"}}'))
        return "\n".join(lines) + "\n"

    @property
    def port(self) -> int:
        return self.server_address[1]

    def start(self) -> None:
        self._thread = threading.Thread(target=self.serve_forever,
                                        daemon=True, name="irp-torch-http")
        self._thread.start()

    def stop(self) -> None:
        self.shutdown()
        if self._thread is not None:
            self._thread.join(5.0)
            self._thread = None
        self.server_close()
        self.batcher.stop()


def make_server(predictor, host: str = "127.0.0.1",
                port: int = 0, class_names=None,
                max_batch: Optional[int] = None, window_ms: float = 5.0,
                decoder: str = "auto", verbose: bool = False,
                request_timeout_s: float = 60.0, loader=None,
                weights_path: Optional[str] = None,
                max_concurrent_explains: int = 2) -> InferenceServer:
    """An :class:`InferenceServer` (not yet serving) for ``predictor``,
    one Predictor or a list of replicas (``infer.replicate_predictor``).

    ``port=0`` binds an ephemeral port (read ``server.port`` after).
    ``class_names`` defaults to the predictor's own.  ``loader`` (a ``path
    -> Predictor`` callable) enables ``POST /reload``; without it the
    served weights cannot change.  Beyond ``max_concurrent_explains``
    explains at once, /explain answers 503.
    """
    batcher = MicroBatcher(predictor, max_batch=max_batch,
                           window_ms=window_ms)
    names = (class_names if class_names is not None
             else batcher.predictor.class_names)
    try:
        return InferenceServer((host, port), batcher, class_names=names,
                               decoder=decoder, verbose=verbose,
                               request_timeout_s=request_timeout_s,
                               max_concurrent_explains=max_concurrent_explains,
                               loader=loader, weights_path=weights_path)
    except BaseException:
        batcher.stop()
        raise
