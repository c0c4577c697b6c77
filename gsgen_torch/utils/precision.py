"""The port's one precision policy: fp32 work runs in full fp32.

The JAX package's fp32 paths (the VSD UNet applied to the fp32 masters,
the parity tests' pins) are exact fp32.  PyTorch leaves cuDNN's fp32
convolutions in TF32 by default (``torch.backends.cudnn.allow_tf32`` is
True and ``cudnn.conv.fp32_precision`` reads ``"tf32"``), which keeps
about three decimal digits.  :func:`exact_fp32` turns TF32 off for cuBLAS
matmuls and cuDNN convolutions through both of torch's interfaces: the
legacy ``allow_tf32`` flags and the ``fp32_precision`` settings (setting
only the legacy flags leaves ``cudnn.conv.fp32_precision`` at ``"none"``,
which defers to a global default).  ``build_trainer`` calls it, so the
entry point, ``chip_smoke.py`` and the tests run the same math.  There is
no switch back: TF32 stays off until a benchmark and a stated tolerance
say otherwise.
"""

from __future__ import annotations

import torch


def exact_fp32() -> None:
    """Run fp32 matmuls (cuBLAS) and convolutions (cuDNN) in IEEE fp32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.fp32_precision = "ieee"
    torch.backends.cudnn.conv.fp32_precision = "ieee"

