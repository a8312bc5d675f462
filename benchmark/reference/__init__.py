"""The plain references, one module an architecture.

A configuration names its reference by a top-level ``"reference"``: a
module of this package. Without one it is ``model`` (MV-LDM). A reference
module exposes

* ``Model(model_cfg, nx=None)``, with ``.denoiser`` and ``.autoencoder``,
  whose parameter names are the published ones the seeded weights are
  keyed by; ``nx`` is a :class:`~benchmark.reference.numerics.Numerics`;
* ``unet_inputs(model_cfg, b, v, hw, backward)``: the positional
  arguments of one ``denoiser`` forward over ``b`` rows of ``v`` views of
  ``hw x hw`` latents, on the meta device (with ``backward`` the latents
  require a gradient).
"""

from __future__ import annotations

import importlib
from pathlib import Path
from types import ModuleType
from typing import Dict

HERE = Path(__file__).resolve().parent
DEFAULT = "model"


def reference_of(config: Dict) -> ModuleType:
    """The reference module of ``config`` (a configuration file's whole
    content); refuses a name that has no such module."""
    name = config.get("reference", DEFAULT)
    if not (isinstance(name, str) and name.isidentifier() and (HERE / f"{name}.py").is_file()):
        raise KeyError(f"configuration {config.get('name')!r} names no reference module "
                       f"{name!r} (benchmark/reference/{name}.py is missing)")
    module = importlib.import_module(f"{__name__}.{name}")
    missing = [a for a in ("Model", "unet_inputs") if not hasattr(module, a)]
    if missing:
        raise KeyError(f"configuration {config.get('name')!r} names reference {name!r}, "
                       f"which has no {' or '.join(missing)}")
    return module
