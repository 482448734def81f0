"""Python client for the port's inference daemon (``serve.py``; the JAX
package's ``client.py``).  Standard library only for bytes and paths.

    client = ServingClient("http://127.0.0.1:8000")
    client.wait_until_ready(timeout_s=300)
    [pred] = client.predict(open("cat.jpg", "rb").read(), topk=3)
    result = client.explain("cat.jpg", overlay_path="cam.png")

An image is encoded bytes (JPEG, PNG, ...), a file path, or an (H, W, 3)
uint8 ndarray (of numpy or a subclass of it), which is sent as a lossless
PNG so that the daemon decodes the exact pixels.
"""

from __future__ import annotations

import base64
import io
import json
import os
import sys
import time
import urllib.error
import urllib.request
from typing import List, Optional, Sequence, Union

ImageLike = Union[bytes, str, "os.PathLike", "numpy.ndarray"]  # noqa: F821


class ServingError(RuntimeError):
    """A non-2xx answer of the daemon, with its error message."""

    def __init__(self, status: int, message: str):
        super().__init__(f"HTTP {status}: {message}")
        self.status = status
        self.message = message


def _is_ndarray(obj) -> bool:
    """Whether ``obj`` is a numpy array, of any subclass.  An array exists
    only once numpy is imported, so bytes and paths never import it."""
    np = sys.modules.get("numpy")
    return np is not None and isinstance(obj, np.ndarray)


def _encode_image(image: ImageLike) -> bytes:
    """Any accepted image form -> encoded bytes for the wire."""
    if isinstance(image, bytes):
        return image
    if isinstance(image, (str, os.PathLike)):
        with open(image, "rb") as f:
            return f.read()
    if _is_ndarray(image):
        import numpy as np
        from PIL import Image

        if image.ndim != 3 or image.shape[-1] != 3:
            raise ValueError(f"expected an (H,W,3) uint8 array, got shape "
                             f"{image.shape}")
        buf = io.BytesIO()
        # PNG is lossless: the daemon scores exactly these pixels
        Image.fromarray(np.asarray(image, np.uint8)).save(buf, "PNG")
        return buf.getvalue()
    raise TypeError(f"unsupported image type {type(image).__name__} "
                    "(expected bytes, path, or (H,W,3) uint8 array)")


class ServingClient:
    """Client of one daemon.  Thread-safe: it keeps no request state."""

    def __init__(self, base_url: str, timeout_s: float = 60.0):
        self.base_url = base_url.rstrip("/")
        self.timeout_s = float(timeout_s)

    def _request(self, path: str, body: Optional[bytes] = None,
                 ctype: Optional[str] = None,
                 timeout_s: Optional[float] = None) -> dict:
        headers = {"Content-Type": ctype} if ctype else {}
        req = urllib.request.Request(
            self.base_url + path, data=body, headers=headers,
            # an empty body is still a POST (400 empty body, not a GET 404)
            method="POST" if body is not None else "GET")
        try:
            with urllib.request.urlopen(
                    req, timeout=timeout_s or self.timeout_s) as r:
                return json.loads(r.read())
        except urllib.error.HTTPError as e:
            try:
                message = json.loads(e.read()).get("error", str(e))
            except ValueError:  # not a JSON error body
                message = str(e)
            raise ServingError(e.code, message) from e

    def healthz(self) -> dict:
        """Liveness and the model card (GET /healthz)."""
        return self._request("/healthz")

    def stats(self) -> dict:
        """Batch fill, latency percentiles, explain counters (GET /stats)."""
        return self._request("/stats")

    def metrics_text(self) -> str:
        """The Prometheus text exposition (GET /metrics), as served."""
        req = urllib.request.Request(self.base_url + "/metrics")
        try:
            with urllib.request.urlopen(req, timeout=self.timeout_s) as r:
                return r.read().decode()
        except urllib.error.HTTPError as e:
            raise ServingError(e.code, str(e)) from e

    def wait_until_ready(self, timeout_s: float = 300.0,
                         poll_s: float = 0.5) -> dict:
        """Poll /healthz until the daemon answers; returns that answer or
        raises TimeoutError."""
        deadline = time.monotonic() + timeout_s
        while True:
            try:
                return self.healthz()
            except (OSError, ServingError):  # URLError is an OSError
                if time.monotonic() >= deadline:
                    raise TimeoutError(
                        f"daemon at {self.base_url} not ready after "
                        f"{timeout_s:.0f}s") from None
                time.sleep(poll_s)

    def reload(self, weights_path: str,
               timeout_s: Optional[float] = None) -> dict:
        """Swap the daemon's weights (POST /reload).  The daemon loads and
        warms the new model before it answers; it must have been launched
        with ``--allow-reload``."""
        body = json.dumps({"weights": str(weights_path)}).encode()
        return self._request("/reload", body=body, ctype="application/json",
                             timeout_s=timeout_s or max(self.timeout_s,
                                                        600.0))

    def predict(self, images: Union[ImageLike, Sequence[ImageLike]],
                topk: int = 1) -> List[dict]:
        """Score one image or a sequence of them (POST /predict): one
        prediction dict (``label``, ``label_name``, ``topk``) per image, in
        order; a single image gives a list of one."""
        single = isinstance(images, (bytes, str, os.PathLike)) or (
            _is_ndarray(images) and images.ndim == 3)
        try:
            batch = [images] if single else list(images)
        except TypeError:
            raise TypeError(
                f"unsupported image type {type(images).__name__} (expected "
                "bytes, path, (H,W,3) uint8 array, or a sequence of "
                "those)") from None
        if not batch:
            return []
        blobs = [_encode_image(im) for im in batch]
        if len(blobs) == 1:
            payload = self._request(f"/predict?topk={int(topk)}",
                                    body=blobs[0],
                                    ctype="application/octet-stream")
        else:
            body = json.dumps({"instances": [
                base64.b64encode(b).decode() for b in blobs]}).encode()
            payload = self._request(f"/predict?topk={int(topk)}", body=body,
                                    ctype="application/json")
        return payload["predictions"]

    def explain(self, image: ImageLike, class_idx: Optional[int] = None,
                topk: int = 1, overlay_path: Optional[str] = None) -> dict:
        """Grad-CAM of one image (POST /explain): the explanation dict
        with ``overlay_png`` (the PNG's bytes) in place of the wire's
        base64; ``overlay_path`` also writes the PNG there.  ``class_idx``
        explains that class instead of the predicted one."""
        query = f"/explain?topk={int(topk)}"
        if class_idx is not None:
            query += f"&class={int(class_idx)}"
        payload = self._request(query, body=_encode_image(image),
                                ctype="application/octet-stream")
        (ex,) = payload["explanations"]
        ex = dict(ex)
        ex["overlay_png"] = base64.b64decode(ex.pop("cam_png_b64"))
        if overlay_path:
            with open(overlay_path, "wb") as f:
                f.write(ex["overlay_png"])
        return ex
