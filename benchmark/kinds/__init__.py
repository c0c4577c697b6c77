"""The kinds of program a cell drives, one module each, found by the
traffic file's ``kind``: ``benchmark/kinds/<kind>.py``.  A new kind of
model (one without a VAE, a point-cloud diffusion, an image-to-3D loss)
arrives as a new module and a traffic file that names it; the harness
(``run.py``, ``control.py``, ``check.py``) stays as it is.

A kind module defines

* ``Program(root, cell, seed, device)``: the program under test, built for
  the cell and the seed, with ``step(callback=None)`` (one training step
  through the program's own entry), ``leaves()`` and ``first_moments()``
  (the optimised leaves and Adam's first moments, for the check),
  ``tap(record)`` (a context that records each network stage's inputs and
  output under the stage's name), ``instrument()`` (the benchmark's spans
  around the program's layers), ``fault(name)`` (a planted fault, for the
  control), ``flops()`` (the step's FLOPs by precision) and ``spec`` (what
  the reference needs once the program is freed);
* ``Reference(cell, spec, seed, device, precision)``: the plain reference
  from the same seed, each network computed in the precision named for it
  (``{}``: all exact), with ``run(n_steps)`` (the same steps, its first
  step's stages tapped) and ``judges()`` (each stage recomputed exactly).
"""

from __future__ import annotations

import importlib
import re

NAME = re.compile(r"^[A-Za-z_][A-Za-z0-9_]{0,63}$")


def load(kind: str):
    """The module ``benchmark.kinds.<kind>``."""
    if not NAME.match(kind):
        raise ValueError(f"kind {kind!r} is no module name")
    return importlib.import_module(f"{__name__}.{kind}")
