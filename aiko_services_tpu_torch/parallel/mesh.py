"""Device meshes over an explicit list of devices.

Port of the part of ``aiko_services_tpu/parallel/mesh.py`` that the
sharded collective matmuls need: :class:`MeshSpec` and :func:`make_mesh`.
A JAX mesh is built over ``jax.devices()``; the port's is built over a
list of ``torch.device``s, one a rank, in rank order:

* ``devices=None`` means every visible card (``cuda:0`` ..
  ``cuda:n-1``), and a mesh that asks for more ranks than there are cards
  raises;
* a list may repeat a device: ``["cuda:0"] * 4`` is four ranks on one
  card, each with its own streams, and ``["cpu"] * 8`` is the CPU tests'
  mesh, the port's counterpart of the JAX package's virtual 8-device CPU
  platform;
* a list that mixes the CPU and CUDA, or names a card that is not there,
  raises.

The device list is never shrunk to fit: a mesh has exactly the ranks it
was asked for.  ``ReplicaMesh`` is not ported yet (it serves the TP
engine, which is not either).
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import torch

__all__ = ["Mesh", "MeshSpec", "make_mesh"]


def _device(spec) -> torch.device:
    device = torch.device(spec)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", 0)
    return device


class Mesh:
    """Ranks laid out on named axes: ``devices[i]`` is rank i's device, in
    row-major order over ``axes`` (name -> size)."""

    def __init__(self, devices: Sequence[torch.device],
                 axes: Dict[str, int]):
        self.devices: Tuple[torch.device, ...] = tuple(devices)
        self.axes: Dict[str, int] = dict(axes)
        if math.prod(self.axes.values()) != len(self.devices):
            raise ValueError(f"mesh {self.axes} needs "
                             f"{math.prod(self.axes.values())} devices, got "
                             f"{len(self.devices)}")

    @property
    def size(self) -> int:
        return len(self.devices)

    def ring(self, axis: str) -> Tuple[torch.device, ...]:
        """The devices of the ring along ``axis``, in rank order.  Every
        other axis must have size 1 (the collective matmuls run on one
        ring)."""
        if axis not in self.axes:
            raise ValueError(f"mesh has no axis {axis!r}: {self.axes}")
        others = {name: size for name, size in self.axes.items()
                  if name != axis and size != 1}
        if others:
            raise ValueError(f"a ring along {axis!r} needs every other axis "
                             f"of size 1, got {others}")
        return self.devices

    def __repr__(self) -> str:
        return f"Mesh({self.axes}, {[str(d) for d in self.devices]})"


class MeshSpec:
    """Declarative mesh shape: ``MeshSpec(dp=2, tp=4)``.  ``-1`` for one
    axis means "all remaining devices"."""

    def __init__(self, **axes: int):
        if not axes:
            axes = {"dp": -1}
        self.axes: Dict[str, int] = dict(axes)

    def resolve(self, device_count: int) -> Dict[str, int]:
        sizes = dict(self.axes)
        wildcard = [k for k, v in sizes.items() if v == -1]
        if len(wildcard) > 1:
            raise ValueError("Only one mesh axis may be -1")
        if any(v < 1 for v in sizes.values() if v != -1):
            raise ValueError(f"mesh axis sizes must be >= 1: {sizes}")
        fixed = math.prod(v for v in sizes.values() if v != -1)
        if wildcard:
            if device_count % fixed:
                raise ValueError(
                    f"{device_count} devices not divisible by {fixed}")
            sizes[wildcard[0]] = device_count // fixed
        elif fixed != device_count:
            raise ValueError(
                f"Mesh {sizes} needs {fixed} devices, have {device_count}")
        return sizes

    def build(self, devices: Optional[Sequence] = None) -> Mesh:
        if devices is None:
            devices = [torch.device("cuda", i)
                       for i in range(torch.cuda.device_count())]
            if not devices:
                raise RuntimeError("make_mesh: no CUDA card is visible; "
                                   "pass an explicit device list (the CPU "
                                   "tests pass ['cpu'] * ranks)")
        devices = [_device(d) for d in devices]
        if not devices:
            raise ValueError("make_mesh: empty device list")
        types = {d.type for d in devices}
        if len(types) > 1:
            raise ValueError(f"make_mesh: the devices mix {sorted(types)}; "
                             "a mesh is all CPU or all CUDA")
        kind = types.pop()
        if kind not in ("cpu", "cuda"):
            raise ValueError(f"make_mesh: unsupported device type {kind!r}")
        if kind == "cuda":
            cards = torch.cuda.device_count()
            missing = sorted({d.index for d in devices if d.index >= cards})
            if missing:
                raise ValueError(f"make_mesh: cuda:{missing[0]} named, "
                                 f"{cards} card(s) visible")
        return Mesh(devices, self.resolve(len(devices)))


def make_mesh(devices: Optional[Sequence] = None, **axes: int) -> Mesh:
    return MeshSpec(**axes).build(devices)
