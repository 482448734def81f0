"""One module per model family, found by the configuration's ``family``:
``families/<family>.py``.

Each gives, for its configurations:

- ``specs(cfg)``: every backbone state_dict entry, name -> (shape,
  kind), kinds as ``synth.weights`` reads them;
- ``num_features(cfg)``: the width of the features the head reads;
- ``stage_of(parts, cfg)``: the stage of a backbone entry, from its
  name's parts after ``backbone.``;
- ``features(p, cfg, x, prec, train, stats_out)``: the plain forward
  (``models.features`` says what it returns);
- ``products(cfg)``: (stage, operations per image, input carries a
  gradient when the stage trains) of every backbone product, in order,
  and the features' width (``roofline/counts.py``);

and where the family has them:

- ``calibrate(state, cfg, x)``: running statistics set in place from the
  eval-cropped float32 batch ``x``, as a trained network's are;
- ``k1_blocks(cfg, batch)``: (B, H, W, C, M) of each block kernel K1
  runs in one forward.
"""

from __future__ import annotations

import importlib


def load(cfg: dict):
    """The module of ``cfg['family']``."""
    name = f"benchmark.reference.families.{cfg['family']}"
    try:
        return importlib.import_module(name)
    except ModuleNotFoundError as e:
        if e.name != name:
            raise
        raise ValueError(f"no reference for family {cfg['family']!r}: add "
                         f"benchmark/reference/families/"
                         f"{cfg['family']}.py") from e
