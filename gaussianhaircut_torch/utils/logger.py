"""Training observability: a JSONL metrics log and PNG image grids (a copy
of ``gaussianhaircut_tpu/utils/logger.py`` without its TensorBoard mirror).

The reference logs scalars and images to TensorBoard
(train_gaussians.py:232-293); here scalars and histogram quantiles go to
``<model_path>/metrics.jsonl`` and images to ``<model_path>/images/``.
"""
from __future__ import annotations

import json
import os
import time

import numpy as np

from gaussianhaircut_torch.utils.image import write_png


class MetricsLogger:
    def __init__(self, model_path: str, filename: str = "metrics.jsonl"):
        os.makedirs(model_path, exist_ok=True)
        self._dir = model_path
        self._f = open(os.path.join(model_path, filename), "a")

    def _write(self, rec: dict) -> None:
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()

    def scalars(self, step: int, **kv) -> None:
        rec = {"step": step, "t": time.time()}
        rec.update({k: float(v) for k, v in kv.items()})
        self._write(rec)

    def images(self, step: int, **kv) -> None:
        """Image grids (train_gaussians.py:264-272): [C<=3, H, W] float in
        [0, 1] per key, written as <model_path>/images/<key>_<step>.png
        (``/`` in a key becomes ``_``)."""
        os.makedirs(os.path.join(self._dir, "images"), exist_ok=True)
        for k, v in kv.items():
            arr = np.asarray(v, dtype=np.float32)
            if arr.ndim == 2:
                arr = arr[None]
            if arr.shape[0] < 3:
                arr = np.concatenate(
                    [arr, np.zeros((3 - arr.shape[0],) + arr.shape[1:], arr.dtype)])
            arr = np.clip(arr[:3], 0.0, 1.0)
            img8 = (arr.transpose(1, 2, 0) * 255).astype(np.uint8)
            safe = k.replace("/", "_")
            write_png(os.path.join(self._dir, "images", f"{safe}_{step:06d}.png"), img8)

    def histogram(self, step: int, name: str, values) -> None:
        """Distribution logging (train_gaussians.py:290-291): a percentile
        summary to the JSONL."""
        arr = np.asarray(values, dtype=np.float32).reshape(-1)
        qs = np.percentile(arr, [0, 5, 25, 50, 75, 95, 100]) if arr.size else []
        self._write({"step": step, "t": time.time(), "histogram": name,
                     "count": int(arr.size), "quantiles": [float(q) for q in qs]})

    def close(self) -> None:
        self._f.close()
