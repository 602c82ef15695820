"""Dynamic module loading for deploy descriptors.

The port's copy of ``aiko_services_tpu/utils/importer.py`` (it has no JAX
in it), with one addition: a descriptor naming the JAX package raises
without importing it, naming the port's counterpart.

The reference accepts two descriptor forms wherever user code is loaded
(``main/utilities/importer.py:28-47``, used by ``main/pipeline.py:939``
for pipeline elements and ``main/dashboard.py:744`` for dashboard
plugins): a dotted module path (``"package.module"``) or a filesystem
path to a source file (``"pathname/filename.py"``).  Loaded modules are
cached so every element of a pipeline definition that names the same
module shares one instance (and its module-level state, e.g. model
singletons).

Same contract here; the file-path form additionally registers the
module in ``sys.modules`` under a stable mangled name so dataclasses /
pickling inside dynamically-loaded elements behave normally.
"""

from __future__ import annotations

import hashlib
import importlib
import importlib.util
import os
import sys
import threading
from types import ModuleType
from typing import Dict, List

__all__ = ["load_module", "load_modules"]

_MODULES_LOADED: Dict[str, ModuleType] = {}
_LOAD_LOCK = threading.Lock()


def _module_name_for_path(pathname: str) -> str:
    stem = os.path.splitext(os.path.basename(pathname))[0]
    digest = hashlib.sha1(pathname.encode()).hexdigest()[:6]
    return f"aiko_dynamic_{stem}_{digest}"


#: The JAX package's top-level name, which the port never imports.
JAX_PACKAGE = "aiko_services_tpu"


def _refuse_jax_package(module_descriptor: str) -> None:
    """Raise if ``module_descriptor`` names a module of the JAX package
    (dotted, or a file under a directory of that name), naming the port's
    counterpart.  Nothing is imported."""
    if module_descriptor.endswith(".py") or os.sep in module_descriptor:
        parts = os.path.normpath(os.path.abspath(module_descriptor)) \
            .split(os.sep)
        if JAX_PACKAGE not in parts[:-1]:
            return
        index = len(parts) - 1 - parts[::-1].index(JAX_PACKAGE)
        relative = parts[index + 1:]
        relative[-1] = os.path.splitext(relative[-1])[0]
        if relative[-1] == "__init__":
            relative.pop()
    else:
        relative = module_descriptor.split(".")
        if relative[0] != JAX_PACKAGE:
            return
        relative = relative[1:]
    counterpart = ".".join([f"{JAX_PACKAGE}_torch"] + relative)
    raise ImportError(
        f"{module_descriptor!r} is a module of the JAX package, which the "
        f"port does not import: deploy the port's counterpart "
        f"{counterpart!r}")


def load_module(module_descriptor: str) -> ModuleType:
    """Load ``"package.module"`` or ``"pathname/filename.py"`` (cached).

    Thread-safe: concurrent pipelines in one process deploying from the
    same file share one exec (one module instance, one model singleton).
    A descriptor naming the JAX package raises :class:`ImportError`
    naming the port's counterpart (``aiko_services_tpu.elements`` ->
    ``aiko_services_tpu_torch.elements``) and imports nothing.
    """
    _refuse_jax_package(module_descriptor)
    with _LOAD_LOCK:
        if module_descriptor.endswith(".py") or os.sep in module_descriptor:
            key = os.path.abspath(module_descriptor)
            module = _MODULES_LOADED.get(key)
            if module is not None:
                return module
            if not os.path.exists(key):
                raise ImportError(
                    f"Module file not found: {module_descriptor}")
            name = _module_name_for_path(key)
            spec = importlib.util.spec_from_file_location(name, key)
            if spec is None or spec.loader is None:
                raise ImportError(
                    f"Cannot load module from {module_descriptor}")
            module = importlib.util.module_from_spec(spec)
            sys.modules[name] = module
            try:
                spec.loader.exec_module(module)
            except BaseException:
                sys.modules.pop(name, None)
                raise
        else:
            key = module_descriptor
            module = _MODULES_LOADED.get(key)
            if module is not None:
                return module
            module = importlib.import_module(module_descriptor)
        _MODULES_LOADED[key] = module
        return module


def load_modules(module_descriptors: List[str]) -> List[ModuleType]:
    return [load_module(descriptor) for descriptor in module_descriptors]
