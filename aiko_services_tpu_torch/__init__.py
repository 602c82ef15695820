"""aiko_services_tpu_torch: the PyTorch + CUDA port of aiko_services_tpu.

The JAX package ``aiko_services_tpu`` stays the reference; this package
mirrors its module names (``ops/``, ``models/``, ``orchestration/``) and
is held against it by the ``tests/test_torch_*.py`` parity tests.  It
imports ``torch`` and ``numpy`` only, never JAX and nothing of the JAX
package.  Every Pallas kernel on a ported path is a hand-written CUDA
kernel for Hopper (``csrc/``), built at first use by ``ops/_cuda.py``.

Entry points run on the card unless the caller passes ``device="cpu"``
(the tests do); with no device given and no card present they raise.
"""

from .device import resolve_device

__all__ = ["resolve_device"]
