"""Checkpoint import into the port's layouts: PEFT LoRA adapters.

The port's part of ``aiko_services_tpu/tools/import_weights.py``:
:func:`import_lora`, which a replica's ``(adapter_load …)`` with a
``path`` calls.  The rest of that module (whole HF model checkpoints,
Whisper) is ``ROADMAP.md`` queue 1 item 9c, not ported yet.

``safetensors`` is imported inside :func:`import_lora` alone, and its
absence raises there, by name: the rest of the port never needs it (the
wire's ``adapter_load`` also takes the factor bytes themselves).
"""

from __future__ import annotations

import json
import os
from typing import Dict

import torch

__all__ = ["import_lora"]

#: Our target name -> the HF module path PEFT keys carry.
_PEFT_TARGETS = {
    "wq": "self_attn.q_proj", "wk": "self_attn.k_proj",
    "wv": "self_attn.v_proj", "wo": "self_attn.o_proj",
    "w_gate": "mlp.gate_proj", "w_up": "mlp.up_proj",
    "w_down": "mlp.down_proj",
}
_PEFT_MODULES = {module.split(".")[-1]: target
                 for target, module in _PEFT_TARGETS.items()}


def _safetensors():
    try:
        import safetensors
        import safetensors.torch  # noqa: F401 - the loader used below
    except ImportError as error:
        raise ImportError(
            "import_lora needs the safetensors package to read a PEFT "
            "adapter directory; it is not installed (an adapter can reach "
            "a replica as packed factor bytes instead)") from error
    return safetensors


def _adapter_files(path: str):
    """The ``*.safetensors`` files of a PEFT adapter directory."""
    names = sorted(n for n in os.listdir(path) if n.endswith(".safetensors"))
    if not names:
        raise FileNotFoundError(f"no .safetensors under {path}")
    return [os.path.join(path, name) for name in names]


def import_lora(path: str, config, dtype=None):
    """A PEFT-layout LoRA adapter directory (``adapter_model.safetensors``
    + ``adapter_config.json``) -> ``(lora_params, LoRAConfig)`` in
    :mod:`~..models.lora`'s layout: rank, alpha and targets from the
    adapter config, factors transposed from torch's ``(out, in)`` to ``a``
    ``(in, r)`` / ``b`` ``(r, out)``, as CPU tensors in ``dtype`` (the
    model's when None).  PEFT options that change the effective weights
    (rsLoRA, DoRA, per-module rank or alpha, saved full modules) raise."""
    from ..models.lora import LoRAConfig, factor_dims

    dtype = dtype or config.dtype
    cfg_path = os.path.join(path, "adapter_config.json")
    if not (os.path.isdir(path) and os.path.exists(cfg_path)):
        raise FileNotFoundError(
            f"no adapter_config.json under {path} (PEFT layout)")
    with open(cfg_path, encoding="utf-8") as fh:
        adapter_config = json.load(fh)
    unsupported = [
        option for option in ("use_rslora", "use_dora", "rank_pattern",
                              "alpha_pattern", "modules_to_save")
        if adapter_config.get(option)]
    if unsupported:
        raise ValueError(
            f"PEFT adapter options {unsupported} are not supported by "
            "import_lora; the adapter would serve at the wrong scale or "
            "with missing weights")
    modules = adapter_config.get("target_modules") or []
    try:
        targets = tuple(_PEFT_MODULES[m] for m in modules)
    except KeyError as error:
        raise ValueError(f"unsupported PEFT target module {error}; "
                         f"known: {sorted(_PEFT_MODULES)}")
    lora_config = LoRAConfig(
        rank=int(adapter_config["r"]),
        alpha=float(adapter_config.get("lora_alpha", adapter_config["r"])),
        targets=targets)

    safetensors = _safetensors()
    tensors: Dict[str, torch.Tensor] = {}
    for file_path in _adapter_files(path):
        with safetensors.safe_open(file_path, framework="pt") as handle:
            for name in handle.keys():
                tensors[name] = handle.get_tensor(name)
    sample = next((name for name in tensors if "model.layers." in name),
                  None)
    if sample is None:
        raise ValueError(f"no per-layer LoRA factors under {path}")
    prefix = sample.split("model.layers.")[0] + "model.layers."
    in_dims, out_dims = factor_dims(config)
    layers = []
    for i in range(config.n_layers):
        layer = {}
        for target in targets:
            base = f"{prefix}{i}.{_PEFT_TARGETS[target]}."
            if base + "lora_A.weight" in tensors:
                # torch lora_A (r, in) -> a (in, r); lora_B (out, r) ->
                # b (r, out).
                layer[target] = {
                    "a": tensors[base + "lora_A.weight"].to(dtype).T
                    .contiguous(),
                    "b": tensors[base + "lora_B.weight"].to(dtype).T
                    .contiguous(),
                }
            else:
                # PEFT ``layers_to_transform`` leaves untouched layers
                # without factors: an exact identity.
                layer[target] = {
                    "a": torch.zeros((in_dims[target], lora_config.rank),
                                     dtype=dtype),
                    "b": torch.zeros((lora_config.rank, out_dims[target]),
                                     dtype=dtype),
                }
        layers.append(layer)
    return {"layers": layers}, lora_config
