"""ML pipeline elements: the model families as PipelineElements.

Port of ``aiko_services_tpu/elements/ml.py``.  The reference's ML elements
shell out to third-party libraries on one device (YOLO via ultralytics,
LLM via Ollama HTTP); here the models are the port's own PyTorch
functions, so ML stages are TpuElements (fusable into one CUDA graph,
device-resident swag) and the chat element runs the port's prefill and
decode loop over a KV cache, through the hand-written kernels:
``flash_attention`` and (at m <= 64) ``int8_matmul`` in the prefill,
``int8_matmul``, ``write_kv_rows`` and ``paged_decode_attention`` in
every decode step.

Every element computes on its ``device`` parameter (the element's
parameters, then the pipeline's), the card when none is given
(:func:`~..pipeline.tpu_stage.element_device`).  ``ASRElement`` raises:
``models/asr.py`` and ``models/tokenizer.py`` are ``ROADMAP.md`` queue 1
item 9b.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..models import classifier as classifier_model
from ..models import detector as detector_model
from ..models import llama as llama_model
from ..models import vision as vision_model
from ..ops.paged_attention import contiguous_rows
from ..pipeline.codec import host_array
from ..pipeline.element import PipelineElement
from ..pipeline.stream import StreamEvent
from ..pipeline.tpu_stage import TpuElement, element_device

__all__ = ["TextClassifierElement", "DetectorElement", "LlamaChatElement",
           "ImageNormalize", "ASRElement", "VisionEncoderElement"]


class ImageNormalize(TpuElement):
    """uint8 images -> normalized float (fusable preprocessing)."""

    def compute(self, params, inputs):
        image = inputs["image"].to(torch.float32) / 255.0
        return {"image": image}


class TextClassifierElement(TpuElement):
    """``tokens`` (batch, seq) int32 -> ``logits`` + ``label_id``."""

    def init_params(self, seed):
        name, _ = self.get_parameter("model_config", "tiny")
        self.config = classifier_model.CONFIGS[str(name)]
        return classifier_model.init_params(self.config, seed,
                                            device=self.device)

    def compute(self, params, inputs):
        logits = classifier_model.forward(params, inputs["tokens"],
                                          self.config)
        return {"logits": logits,
                "label_id": logits.argmax(-1).to(torch.int32)}


class DetectorElement(TpuElement):
    """``image`` (batch, H, W, 3) -> decoded boxes/scores/classes/keep.
    Parameter ``checkpoint`` boots trained weights from
    ``detector.save_checkpoint`` (either package's ``.npz``)."""

    def init_params(self, seed):
        checkpoint, _ = self.get_parameter("checkpoint", None)
        if checkpoint:
            params, self.config = detector_model.load_checkpoint(
                str(checkpoint), device=self.device)
            return params
        name, _ = self.get_parameter("model_config", "tiny")
        self.config = detector_model.CONFIGS[str(name)]
        return detector_model.init_params(self.config, seed,
                                          device=self.device)

    def compute(self, params, inputs):
        raw = detector_model.forward(params, inputs["image"], self.config)
        boxes, scores, classes, keep = detector_model.decode_boxes(
            raw, self.config)
        return {"boxes": boxes, "scores": scores, "classes": classes,
                "keep": keep}


class ASRElement(PipelineElement):
    """Speech -> token ids (the Whisper-architecture model).  Not in the
    port yet: it raises when built."""

    def __init__(self, context, process=None):
        raise NotImplementedError(
            "ASRElement needs models/asr.py and models/tokenizer.py, which "
            "the port does not have yet: ROADMAP.md queue 1 item 9b")


class VisionEncoderElement(TpuElement):
    """``image`` (batch, H, W, 3) float [0,1] -> CLIP-style ``embedding``
    + ``patch_features`` (fusable; the vision half of vision-LLM fan-out
    graphs)."""

    def init_params(self, seed):
        name, _ = self.get_parameter("model_config", "tiny")
        self.config = vision_model.CONFIGS[str(name)]
        return vision_model.init_params(self.config, seed,
                                        device=self.device)

    def compute(self, params, inputs):
        return vision_model.encode(params, inputs["image"], self.config)


class LlamaChatElement(PipelineElement):
    """Autoregressive chat: ``tokens`` (batch, prompt_len) int32 ->
    ``tokens_out`` (batch, prompt+new) plus decode throughput.

    Parameters: ``model_config`` (llama.CONFIGS key), ``param_init``
    (``init``, ``random_int8``, ``random_int4``), ``quantize`` (int8
    weights over ``init``), ``max_new_tokens`` (clamped to the config's
    ``max_seq_len``), ``temperature`` (0 = greedy), ``top_k``, ``top_p``,
    ``sample_seed`` (seeds the ``torch.Generator`` a sampled frame draws
    from), ``device``.  Each frame prefills a contiguous cache of
    ``prompt + new`` rows rounded up to the kernels' block view
    (:func:`~..ops.paged_attention.contiguous_rows`; the extra rows are
    masked) and decodes with :func:`~..models.llama.generate_tokens`.
    ``tokens_per_second`` is the decode's: the clock starts after the
    first token and stops after the tokens are read back to the host.
    """

    def __init__(self, context, process=None):
        super().__init__(context, process)
        self.device = element_device(self)
        name, _ = self.get_parameter("model_config", "tiny")
        self.config = llama_model.CONFIGS[str(name)]
        seed, _ = self.get_parameter("seed", 0)
        init_mode, _ = self.get_parameter("param_init", "init")
        if str(init_mode) in ("random_int8", "random_int4"):
            # 8B-class path: quantized params built directly, the bf16
            # tree never made (llama.random_quantized_params).
            self.params = llama_model.random_quantized_params(
                self.config, seed=int(seed),
                bits=4 if str(init_mode).endswith("int4") else 8,
                device=self.device)
        else:
            self.params = llama_model.init_params(
                self.config, seed=int(seed), device=self.device)
            quantize, _ = self.get_parameter("quantize", False)
            if quantize:
                # Int8 weight-only: half the parameter bytes a step reads.
                self.params = llama_model.quantize_params(self.params)

    def start_stream(self, stream, stream_id):
        return StreamEvent.OKAY, None

    def process_frame(self, stream, tokens):
        tokens = torch.as_tensor(np.asarray(host_array(tokens), np.int32),
                                 device=self.device)
        if tokens.ndim == 1:
            tokens = tokens[None]
        batch, prompt_len = tokens.shape
        max_new, _ = self.get_parameter("max_new_tokens", 16,
                                        stream=stream)
        max_new = int(max_new)
        budget = self.config.max_seq_len - prompt_len
        if budget <= 0:
            self.logger.error(
                "%s: prompt (%d) exceeds max_seq_len (%d)",
                self.my_id(stream), prompt_len, self.config.max_seq_len)
            return StreamEvent.ERROR, {}
        if max_new > budget:
            self.logger.warning(
                "%s: clamping max_new_tokens %d -> %d (max_seq_len %d)",
                self.my_id(stream), max_new, budget,
                self.config.max_seq_len)
            max_new = budget
        max_seq = prompt_len + max_new

        temperature, _ = self.get_parameter("temperature", 0.0,
                                            stream=stream)
        temperature = float(temperature)
        seed, _ = self.get_parameter("sample_seed", 0, stream=stream)
        top_k, _ = self.get_parameter("top_k", 0, stream=stream)
        top_p, _ = self.get_parameter("top_p", 1.0, stream=stream)
        top_k = int(top_k)
        top_p = float(top_p) if float(top_p) < 1.0 else None
        generator = torch.Generator(device=self.device).manual_seed(
            int(seed))
        cache = llama_model.init_cache(self.config, batch,
                                       contiguous_rows(max_seq),
                                       device=self.device)
        logits, cache = llama_model.prefill(self.params, tokens, cache,
                                            self.config)
        if temperature > 0:
            first = llama_model.sample_logits(
                logits[:, -1], generator, temperature, top_k=top_k,
                top_p=top_p)[:, None]
        else:
            first = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
        started = time.perf_counter()
        new_tokens, _ = llama_model.generate_tokens(
            self.params, first, cache, prompt_len, max_new - 1,
            self.config, temperature=temperature, generator=generator,
            top_k=top_k, top_p=top_p)
        tokens_out = torch.cat([tokens, first, new_tokens], dim=1)
        tokens_out.cpu()                # host readback = real completion
        elapsed = time.perf_counter() - started
        decoded = max(1, max_new - 1) * batch
        return StreamEvent.OKAY, {
            "tokens_out": tokens_out,
            "tokens_per_second": decoded / max(elapsed, 1e-9),
        }
