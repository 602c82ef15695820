"""Port parity: the pipeline's compute plane on the CPU.

The scenarios of tests/test_tpu_stage.py on the port's fused stages and
ML elements (``"device": "cpu"``: the stages run eagerly here; their CUDA
graphs are held to eager on the card in tests/test_torch_cuda.py), then
the models against the JAX package's on the same numpy-seeded inputs and
bridged weights (``models/bridge.py``), the whole vision-LLM graph port
pipeline against JAX pipeline, the detector's ``.npz`` checkpoints across
the two packages, and the chat element's sampling by its distribution.

Tolerances, per element, ``|got - want| <= rel * |want| + row * max
|want|`` over the last axis: f32 rel = row = 1e-4 (summation order and
transcendental ulps through at most two layers); bf16 rel = row = 2^-5
(a few bf16 roundings, 2^-9 each, that the two frameworks take at other
points of a product or an elementwise chain, through two layers).
Integer and boolean outputs (classes, keep, label ids, tokens) are equal.
"""

import dataclasses
import json
import pathlib
import queue

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aiko_services_tpu.models import classifier as jax_classifier
from aiko_services_tpu.models import common as jax_common
from aiko_services_tpu.models import detector as jax_detector
from aiko_services_tpu.models import llama as jax_llama
from aiko_services_tpu.models import vision as jax_vision
from aiko_services_tpu.pipeline import Pipeline as JaxPipeline
from aiko_services_tpu.pipeline import (
    parse_pipeline_definition as jax_parse)
from aiko_services_tpu.runtime import Process as JaxProcess
from aiko_services_tpu.runtime import compose_instance as jax_compose
from aiko_services_tpu.runtime import pipeline_args as jax_pipeline_args
from aiko_services_tpu.runtime.event import EventEngine as JaxEventEngine
from aiko_services_tpu.runtime.event import VirtualClock as JaxVirtualClock
from aiko_services_tpu_torch import transport
from aiko_services_tpu_torch.models import classifier, common, detector
from aiko_services_tpu_torch.models import llama, vision
from aiko_services_tpu_torch.models.bridge import (params_from_numpy,
                                                   tensor_from_numpy,
                                                   tensor_to_numpy)
from aiko_services_tpu_torch.pipeline import (Pipeline, PipelineElement,
                                              StreamEvent,
                                              parse_pipeline_definition)
from aiko_services_tpu_torch.pipeline.codec import host_array
from aiko_services_tpu_torch.pipeline.tpu_stage import TpuElement
from aiko_services_tpu_torch.runtime import (EventEngine, Process,
                                             VirtualClock, compose_instance,
                                             faults, pipeline_args)

MODULE = __name__
ML_MODULE = "aiko_services_tpu_torch.elements"
REPO = pathlib.Path(__file__).resolve().parent.parent
F32_KEY = "tiny_f32_port"
TOL = {"f32": (1e-4, 1e-4), "bf16": (2 ** -5, 2 ** -5)}


@pytest.fixture(scope="module", autouse=True)
def _leave_jax_caches_cold():
    """Later test modules in the same worker count their own JAX
    compiles; drop whatever this module compiled once it is done."""
    yield
    jax.clear_caches()


@pytest.fixture(autouse=True)
def _port_side_isolated():
    transport.reset_brokers()
    yield
    faults.uninstall()
    transport.reset_brokers()


@pytest.fixture()
def engine():
    return EventEngine(clock=VirtualClock())


def close(got, want, kind):
    """``got`` (tensor or array) within TOL[kind] of ``want``."""
    got = np.asarray(host_array(got), np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    rel, row = TOL[kind]
    magnitude = np.abs(want)
    bound = rel * magnitude + row * magnitude.max(axis=-1, keepdims=True)
    worst = float((np.abs(got - want) / np.maximum(bound, 1e-30)).max())
    assert worst <= 1.0, worst


# --------------------------------------------------------------------------- #
# Fusable elements of the stage scenarios (tests/tpu_elements.py's)


class TE_Scale(TpuElement):
    def init_params(self, seed):
        factor, _ = self.get_parameter("factor", 2.0)
        return {"factor": torch.tensor(float(factor), device=self.device)}

    def compute(self, params, inputs):
        return {"x": inputs["x"] * params["factor"]}


class TE_Bias(TpuElement):
    def init_params(self, seed):
        bias, _ = self.get_parameter("bias", 1.0)
        return {"bias": torch.tensor(float(bias), device=self.device)}

    def compute(self, params, inputs):
        return {"x": inputs["x"] + params["bias"]}


class TE_Relu(TpuElement):
    def compute(self, params, inputs):
        return {"x": torch.clamp_min(inputs["x"], 0.0)}


class TE_Renamed(TpuElement):
    """Consumes input 'y' (mapped from swag 'x' by edge properties)."""

    def compute(self, params, inputs):
        return {"z": inputs["y"] * 10.0}


class PE_Collect(PipelineElement):
    def process_frame(self, stream, **inputs):
        return StreamEvent.OKAY, inputs


class PromptBuilder(PipelineElement):
    """examples/vision_llm/elements_vision_llm.py's PromptBuilder on the
    port: the embedding quantized into visual token ids, then the four
    best-scoring detection classes."""

    def process_frame(self, stream, embedding, scores, classes):
        vocab, _ = self.get_parameter("vocab_size", 1024, stream=stream)
        n_visual, _ = self.get_parameter("n_visual_tokens", 8,
                                         stream=stream)
        vocab, n_visual = int(vocab), int(n_visual)
        embedding = host_array(embedding).astype(np.float32).reshape(-1)
        lo, hi = embedding.min(), embedding.max()
        span = max(float(hi - lo), 1e-6)
        visual = ((embedding[:n_visual] - lo) / span
                  * (vocab - 2)).astype(np.int32) + 1
        classes = host_array(classes).astype(np.int32).reshape(-1)
        scores = host_array(scores).astype(np.float32).reshape(-1)
        top = classes[np.argsort(-scores)[:4]] % (vocab - 1) + 1
        tokens = np.concatenate([visual, top]).astype(np.int32)[None, :]
        return StreamEvent.OKAY, {"tokens": tokens}


def element(name, cls, inputs, outputs, parameters=None, module=MODULE):
    return {
        "name": name,
        "input": [{"name": n, "type": t} for n, t in inputs],
        "output": [{"name": n, "type": t} for n, t in outputs],
        "parameters": parameters or {},
        "deploy": {"local": {"module": module, "class_name": cls}},
    }


def document(name, graph, elements, runtime="tpu", **parameters):
    return {"version": 0, "name": name, "runtime": runtime,
            "graph": [graph], "parameters": {"device": "cpu", **parameters},
            "elements": elements}


def make_pipeline(engine, doc, broker="tpu"):
    process = Process(namespace="test", hostname="h", pid="1",
                      engine=engine, broker=broker)
    definition = parse_pipeline_definition(doc)
    return compose_instance(
        Pipeline, pipeline_args(definition.name, definition=definition),
        process=process)


def run_one(engine, pipeline, frame, stream_id="s"):
    out = queue.Queue()
    pipeline.create_stream(stream_id, queue_response=out)
    pipeline.post_frame(stream_id, frame)
    engine.drain()
    return out.get_nowait()[2]


SCALE = element("TE_Scale", "TE_Scale", [("x", "array")], [("x", "array")],
                {"factor": 3.0})
BIAS = element("TE_Bias", "TE_Bias", [("x", "array")], [("x", "array")],
               {"bias": -5.0})
RELU = element("TE_Relu", "TE_Relu", [("x", "array")], [("x", "array")])


# --------------------------------------------------------------------------- #
# the stage scenarios


def test_contiguous_tpu_elements_fuse(engine):
    pipeline = make_pipeline(engine, document(
        "p_fuse", "(TE_Scale TE_Bias TE_Relu)", [SCALE, BIAS, RELU]))
    assert list(pipeline._fused_stages) == ["TE_Scale"]
    stage = pipeline._fused_stages["TE_Scale"]
    assert stage.node_names == ["TE_Scale", "TE_Bias", "TE_Relu"]
    result = run_one(engine, pipeline,
                     {"x": torch.tensor([1.0, 2.0, 3.0])})
    np.testing.assert_allclose(result["x"].numpy(), [0.0, 1.0, 4.0])


def test_fused_stage_coerces_lists_and_output_precedence(engine):
    """A plain list input works fused; computed outputs beat stale
    passthrough values of the same name; non-arrays pass through."""
    scale = element("TE_Scale", "TE_Scale", [("x", "array")],
                    [("x", "array")], {"factor": 2.0})
    bias = element("TE_Bias", "TE_Bias", [("x", "array")],
                   [("x", "array")], {"bias": 1.0})
    pipeline = make_pipeline(engine, document(
        "p_coerce", "(TE_Scale TE_Bias)", [scale, bias]), broker="coerce")
    result = run_one(engine, pipeline,
                     {"x": [1.0, 2.0], "note": "passthrough"})
    np.testing.assert_allclose(result["x"].numpy(), [3.0, 5.0])
    assert result["x"].dtype == torch.float32       # as jnp.asarray's
    stage = pipeline._fused_stages["TE_Scale"]
    out = stage({"x": [1.0], "note": "kept"})
    assert out["note"] == "kept"
    np.testing.assert_allclose(out["x"].numpy(), [3.0])


def test_python_element_breaks_fusion(engine):
    pipeline = make_pipeline(engine, document(
        "p_break", "(TE_Scale PE_Collect TE_Bias TE_Relu)",
        [SCALE, element("PE_Collect", "PE_Collect", [("x", "array")],
                        [("x", "array")]), BIAS, RELU]), broker="brk")
    assert list(pipeline._fused_stages) == ["TE_Bias"]


def test_fused_stage_respects_input_mapping(engine):
    scale = element("TE_Scale", "TE_Scale", [("x", "array")],
                    [("x", "array")], {"factor": 2.0})
    renamed = element("TE_Renamed", "TE_Renamed", [("y", "array")],
                      [("z", "array")])
    pipeline = make_pipeline(engine, document(
        "p_map", "(TE_Scale (TE_Renamed (x: y)))", [scale, renamed]),
        broker="map")
    result = run_one(engine, pipeline, {"x": np.asarray([1.0], np.float32)})
    np.testing.assert_allclose(result["z"].numpy(), [20.0])


def test_runtime_python_does_not_fuse(engine):
    pipeline = make_pipeline(engine, document(
        "p_nofuse", "(TE_Scale TE_Bias)", [SCALE, BIAS], runtime="python"),
        broker="nf")
    assert pipeline._fused_stages == {}
    result = run_one(engine, pipeline, {"x": torch.tensor([2.0])})
    np.testing.assert_allclose(result["x"].numpy(), [1.0])   # 3 * 2 - 5


def test_classifier_element_in_pipeline(engine):
    pipeline = make_pipeline(engine, document(
        "p_cls", "(TextClassifierElement)",
        [element("TextClassifierElement", "TextClassifierElement",
                 [("tokens", "array")],
                 [("logits", "array"), ("label_id", "array")],
                 {"model_config": "tiny"}, module=ML_MODULE)]),
        broker="cls")
    result = run_one(engine, pipeline, {"tokens": np.zeros((2, 16),
                                                           np.int32)})
    assert result["logits"].shape == (2, 2)
    assert result["label_id"].shape == (2,)
    assert result["label_id"].dtype == torch.int32


def test_llama_chat_element_generates(engine):
    pipeline = make_pipeline(engine, document(
        "p_chat", "(LlamaChatElement)",
        [element("LlamaChatElement", "LlamaChatElement",
                 [("tokens", "array")],
                 [("tokens_out", "array"), ("tokens_per_second", "float")],
                 {"model_config": "tiny", "max_new_tokens": 4},
                 module=ML_MODULE)], runtime="python"), broker="chat")
    prompt = np.arange(8, dtype=np.int32)[None]
    result = run_one(engine, pipeline, {"tokens": prompt})
    assert result["tokens_out"].shape == (1, 12)      # 8 prompt + 4 new
    assert float(result["tokens_per_second"]) > 0
    np.testing.assert_array_equal(result["tokens_out"][0, :8].numpy(),
                                  prompt[0])


def test_detector_element(engine):
    pipeline = make_pipeline(engine, document(
        "p_det", "(ImageNormalize DetectorElement)",
        [element("ImageNormalize", "ImageNormalize", [("image", "array")],
                 [("image", "array")], module=ML_MODULE),
         element("DetectorElement", "DetectorElement", [("image", "array")],
                 [("boxes", "array"), ("scores", "array"),
                  ("classes", "array"), ("keep", "array")],
                 {"model_config": "tiny"}, module=ML_MODULE)]),
        broker="det")
    assert list(pipeline._fused_stages) == ["ImageNormalize"]
    image = np.random.default_rng(0).integers(0, 255, (1, 64, 64, 3),
                                              dtype=np.uint8)
    result = run_one(engine, pipeline, {"image": image})
    assert result["boxes"].shape == (1, 64, 4)        # an 8 x 8 grid
    assert result["scores"].shape == result["classes"].shape == (1, 64)


def test_device_metrics_distinguish_dispatch_from_device(engine):
    """time_{stage} on every frame; time_{stage}_device only on sampled
    ones (device_metrics_interval 2 over frames 0, 1, 2), never below the
    dispatch time."""
    pipeline = make_pipeline(engine, document(
        "p_devmet", "(TE_Scale TE_Bias)", [SCALE, BIAS],
        device_metrics_interval=2), broker="devmet")
    out = queue.Queue()
    pipeline.create_stream("s", queue_response=out)
    for _ in range(3):
        pipeline.post_frame("s", {"x": torch.tensor([1.0])})
    engine.drain()
    frames = [out.get()[1] for _ in range(3)]
    stage = "TE_Scale+TE_Bias"
    assert all(frame.metrics[f"time_{stage}"] > 0 for frame in frames)
    sampled = [f for f in frames if f"time_{stage}_device" in f.metrics]
    assert [f.frame_id for f in sampled] == [0, 2]
    for frame in sampled:
        assert frame.metrics[f"time_{stage}_device"] >= \
            frame.metrics[f"time_{stage}"]


def test_no_device_and_no_card_raises(engine):
    """A device element with no ``device`` parameter resolves to the card;
    with none present the pipeline raises rather than run on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the element would take it")
    doc = document("p_nodev", "(TE_Scale TE_Bias)", [SCALE, BIAS])
    doc["parameters"] = {}
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_pipeline(engine, doc, broker="nodev")
    # The element's own parameter wins over the pipeline's.
    doc["parameters"] = {"device": "cuda"}
    doc["elements"] = [dict(e, parameters={"device": "cpu"})
                       for e in (SCALE, BIAS)]
    pipeline = make_pipeline(engine, doc, broker="owndev")
    assert pipeline._fused_stages["TE_Scale"].device == torch.device("cpu")


# --------------------------------------------------------------------------- #
# the models against the JAX package's


def _configs(kind, jax_config, port_config):
    if kind == "f32":
        return (dataclasses.replace(jax_config, dtype=jnp.float32),
                dataclasses.replace(port_config, dtype=torch.float32))
    return jax_config, port_config


def _bridge(jax_params):
    return params_from_numpy(jax.tree.map(np.asarray, jax_params))


@pytest.mark.parametrize("kind", ["f32", "bf16"])
def test_common_blocks_match_jax(kind):
    rng = np.random.default_rng(1)
    jdt, tdt = ((jnp.float32, torch.float32) if kind == "f32"
                else (jnp.bfloat16, torch.bfloat16))
    d, heads = 64, 4
    x = rng.standard_normal((2, 10, d)).astype(np.float32)
    weights = {
        "norm": 1.0 + 0.1 * rng.standard_normal(d),
        "bias": 0.1 * rng.standard_normal(d),
        "w_in": rng.standard_normal((d, 3 * d)) * d ** -0.5,
        "wo": rng.standard_normal((d, d)) * d ** -0.5,
        "w1": rng.standard_normal((d, 4 * d)) * d ** -0.5,
        "w2": rng.standard_normal((4 * d, d)) * (4 * d) ** -0.5,
    }
    jw = {k: jnp.asarray(v, jnp.float32).astype(jdt)
          for k, v in weights.items()}
    tw = {k: tensor_from_numpy(np.asarray(jax.device_get(v)))
          for k, v in jw.items()}
    jx = jnp.asarray(x).astype(jdt)
    tx = tensor_from_numpy(np.asarray(jx))
    assert tx.dtype == tdt
    close(common.layer_norm(tx, tw["norm"], bias=tw["bias"]),
          np.asarray(jax_common.layer_norm(jx, jw["norm"], bias=jw["bias"]),
                     np.float32), kind)
    for causal in (False, True):
        close(common.mha(tx, tx, tw["w_in"], tw["wo"], heads, causal),
              np.asarray(jax_common.mha(jx, jx, jw["w_in"], jw["wo"], heads,
                                        causal), np.float32), kind)
    close(common.gelu_mlp(tx, tw["norm"], tw["w1"], tw["w2"]),
          np.asarray(jax_common.gelu_mlp(jx, jw["norm"], jw["w1"],
                                         jw["w2"]), np.float32), kind)


@pytest.mark.parametrize("kind", ["f32", "bf16"])
def test_vision_encode_matches_jax(kind):
    jax_config, config = _configs(kind, jax_vision.CONFIGS["tiny"],
                                  vision.CONFIGS["tiny"])
    jax_params = jax_vision.init_params(jax_config, jax.random.PRNGKey(3))
    images = np.random.default_rng(2).random((2, 32, 32, 3),
                                             dtype=np.float32)
    want = jax_vision.encode(jax_params, jnp.asarray(images), jax_config)
    got = vision.encode(_bridge(jax_params), torch.from_numpy(images),
                        config)
    close(got["embedding"], np.asarray(want["embedding"]), kind)
    close(got["patch_features"],
          np.asarray(want["patch_features"], np.float32), kind)
    assert got["embedding"].dtype == torch.float32


@pytest.mark.parametrize("kind", ["f32", "bf16"])
@pytest.mark.parametrize("size", [64, 40, 37])
def test_detector_matches_jax(kind, size):
    """forward (XLA "SAME" padding at stride 2 on even and odd sizes) and
    decode_boxes, against the JAX package's on the same weights."""
    jax_config, config = _configs(kind, jax_detector.CONFIGS["tiny"],
                                  detector.CONFIGS["tiny"])
    jax_params = jax_detector.init_params(jax_config, jax.random.PRNGKey(4))
    jax_params = jax.tree.map(  # non-zero biases, so their add is held too
        lambda leaf: leaf + 0.05 if leaf.ndim == 1 else leaf, jax_params)
    images = np.random.default_rng(size).random((2, size, size, 3),
                                                dtype=np.float32)
    want = jax_detector.forward(jax_params, jnp.asarray(images), jax_config)
    got = detector.forward(_bridge(jax_params), torch.from_numpy(images),
                           config)
    grid = -(-size // 8)
    assert tuple(got.shape) == (2, grid, grid, 9)
    close(got, np.asarray(want), kind)
    # decode_boxes on the same raw grid: classes and keep exactly.
    raw = np.array(want)
    jax_out = jax_detector.decode_boxes(jnp.asarray(raw), jax_config,
                                        score_threshold=0.3)
    port_out = detector.decode_boxes(torch.from_numpy(raw), config,
                                     score_threshold=0.3)
    close(port_out[0], np.asarray(jax_out[0]), "f32")
    close(port_out[1], np.asarray(jax_out[1]), "f32")
    np.testing.assert_array_equal(port_out[2].numpy(), np.asarray(jax_out[2]))
    assert port_out[2].dtype == torch.int32
    np.testing.assert_array_equal(port_out[3].numpy(), np.asarray(jax_out[3]))


def test_detector_padding_is_xla_same():
    assert detector.same_padding(224, 3, 2) == (0, 1)
    assert detector.same_padding(7, 3, 2) == (1, 1)
    assert detector.same_padding(7, 1, 1) == (0, 0)
    assert detector.same_padding(8, 3, 1) == (1, 1)


@pytest.mark.parametrize("kind", ["f32", "bf16"])
def test_classifier_matches_jax(kind):
    jax_config, config = _configs(kind, jax_classifier.CONFIGS["tiny"],
                                  classifier.CONFIGS["tiny"])
    jax_params = jax_classifier.init_params(jax_config,
                                            jax.random.PRNGKey(5))
    tokens = np.random.default_rng(6).integers(
        0, 1024, (3, 20)).astype(np.int32)
    want = jax_classifier.forward(jax_params, jnp.asarray(tokens),
                                  jax_config)
    got = classifier.forward(_bridge(jax_params), torch.from_numpy(tokens),
                             config)
    close(got, np.asarray(want), kind)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_detector_checkpoint_crosses_packages(tmp_path, writer):
    """A ``save_checkpoint`` .npz of either package loads in the other:
    the same arrays byte for byte, the same config."""
    jax_config = jax_detector.CONFIGS["tiny"]
    jax_params = jax_detector.init_params(jax_config, jax.random.PRNGKey(7))
    port_params = _bridge(jax_params)
    jax_path, port_path = tmp_path / "jax.npz", tmp_path / "port"
    jax_detector.save_checkpoint(jax_params, jax_config, str(jax_path))
    detector.save_checkpoint(port_params, detector.CONFIGS["tiny"],
                             str(port_path))
    with np.load(jax_path) as a, np.load(f"{port_path}.npz") as b:
        assert list(a.keys()) == list(b.keys())
        for key in a.keys():
            assert a[key].dtype == b[key].dtype
            assert a[key].tobytes() == b[key].tobytes(), key
    with np.load(jax_path) as a:
        assert json.loads(a["config_json"].tobytes())["dtype"] == "bfloat16"
    if writer == "jax":
        params, config = detector.load_checkpoint(str(jax_path),
                                                  device="cpu")
        assert config == detector.CONFIGS["tiny"]
        for got, want in zip(jax.tree.leaves(jax.tree.map(
                np.asarray, jax_params)), _leaves(params)):
            np.testing.assert_array_equal(tensor_to_numpy(want),
                                          np.asarray(got, np.float32))
    else:
        params, config = jax_detector.load_checkpoint(str(port_path))
        assert config == jax_config
        for got, want in zip(jax.tree.leaves(params),
                             jax.tree.leaves(jax_params)):
            np.testing.assert_array_equal(np.asarray(got, np.float32),
                                          np.asarray(want, np.float32))


def _leaves(tree):
    """The port tree's tensors in the JAX tree's leaf order (sorted
    dict keys)."""
    if isinstance(tree, dict):
        return [leaf for key in sorted(tree) for leaf in _leaves(tree[key])]
    if isinstance(tree, list):
        return [leaf for item in tree for leaf in _leaves(item)]
    return [tree]


# --------------------------------------------------------------------------- #
# the vision-LLM graph, port pipeline against JAX pipeline


def _vision_llm_document(module_of):
    doc = json.loads((REPO / "examples" / "vision_llm" /
                      "pipeline_vision_llm.json").read_text())
    for spec in doc["elements"]:
        spec["deploy"]["local"]["module"] = module_of(spec["name"])
        if "model_config" in spec.get("parameters", {}):
            spec["parameters"]["model_config"] = F32_KEY
    return doc


def test_vision_llm_graph_matches_jax(monkeypatch):
    """examples/vision_llm's graph (normalize -> CLIP-class encoder +
    YOLO-class detector, fused; prompt builder; Llama chat) through both
    packages' Pipelines on f32 tiny configs and the JAX elements' weights:
    the same fused stage, float outputs within the f32 tolerance,
    classes / keep / tokens_out equal."""
    for jax_module, port_module in ((jax_vision, vision),
                                    (jax_detector, detector),
                                    (jax_llama, llama)):
        monkeypatch.setitem(jax_module.CONFIGS, F32_KEY, dataclasses.replace(
            jax_module.CONFIGS["tiny"], dtype=jnp.float32))
        monkeypatch.setitem(port_module.CONFIGS, F32_KEY, dataclasses.replace(
            port_module.CONFIGS["tiny"], dtype=torch.float32))
    images = [np.random.default_rng(10 + i).integers(
        0, 256, (1, 32, 32, 3), dtype=np.uint8) for i in range(3)]

    jax_engine = JaxEventEngine(clock=JaxVirtualClock())
    jax_doc = _vision_llm_document(
        lambda name: ("examples.vision_llm.elements_vision_llm"
                      if name == "PromptBuilder"
                      else "aiko_services_tpu.elements"))
    jax_definition = jax_parse(jax_doc)
    jax_pipeline = jax_compose(
        JaxPipeline, jax_pipeline_args(jax_definition.name,
                                       definition=jax_definition),
        process=JaxProcess(namespace="test", hostname="h", pid="1",
                           engine=jax_engine, broker="vllm_jax"))

    # The port's elements take the JAX elements' weights as they are
    # built (before the fused stage snapshots them).
    weights = {name: _bridge(jax_pipeline.elements[name].params)
               for name in ("VisionEncoderElement", "DetectorElement",
                            "LlamaChatElement")}
    monkeypatch.setattr(vision, "init_params", lambda *a, **k:
                        weights["VisionEncoderElement"])
    monkeypatch.setattr(detector, "init_params", lambda *a, **k:
                        weights["DetectorElement"])
    monkeypatch.setattr(llama, "init_params", lambda *a, **k:
                        weights["LlamaChatElement"])
    engine = EventEngine(clock=VirtualClock())
    doc = _vision_llm_document(
        lambda name: MODULE if name == "PromptBuilder" else ML_MODULE)
    doc["parameters"] = {"device": "cpu"}
    pipeline = make_pipeline(engine, doc, broker="vllm_port")
    stage = "ImageNormalize+VisionEncoderElement+DetectorElement"
    assert [s.name for s in pipeline._fused_stages.values()] == [stage]
    assert [s.name for s in jax_pipeline._fused_stages.values()] == [stage]

    results = {}
    for side, pipe, eng in (("jax", jax_pipeline, jax_engine),
                            ("port", pipeline, engine)):
        out = queue.Queue()
        pipe.create_stream("s", queue_response=out)
        for image in images:
            pipe.post_frame("s", {"image": image})
        eng.drain()
        results[side] = [out.get_nowait()[1] for _ in images]
    for jax_frame, frame in zip(results["jax"], results["port"]):
        want, got = jax_frame.swag, frame.swag
        for key in ("embedding", "boxes", "scores"):
            close(got[key], np.asarray(want[key]), "f32")
        close(got["patch_features"], np.asarray(want["patch_features"]),
              "f32")
        for key in ("classes", "keep", "tokens", "tokens_out"):
            np.testing.assert_array_equal(host_array(got[key]),
                                          np.asarray(want[key]))
        assert got["tokens_out"].shape == (1, 16)   # 12 prompt + 4 new
        assert f"time_{stage}" in frame.metrics


# --------------------------------------------------------------------------- #
# the chat element's sampling, by its distribution


def test_llama_chat_sampling_distribution(engine, monkeypatch):
    """Sampled first tokens (temperature 1.5, top_k 8) over 4 frames of
    512 identical rows, each frame its own sample_seed, against the
    distribution the JAX model's logits give on the same weights
    (softmax of the top 8 at 1.5; nothing outside them).  Pearson's
    chi-square over the 8 tokens, 7 degrees of freedom, must stay under
    24.32 (p = 0.001), a bound fixed before the draw."""
    monkeypatch.setitem(jax_llama.CONFIGS, F32_KEY, dataclasses.replace(
        jax_llama.CONFIGS["tiny"], dtype=jnp.float32))
    monkeypatch.setitem(llama.CONFIGS, F32_KEY, dataclasses.replace(
        llama.CONFIGS["tiny"], dtype=torch.float32))
    config = jax_llama.CONFIGS[F32_KEY]
    jax_params = jax_llama.init_params(config, jax.random.PRNGKey(0))
    bridged = _bridge(jax_params)
    monkeypatch.setattr(llama, "init_params", lambda *a, **k: bridged)
    prompt = np.asarray([[5, 17, 300, 42]], np.int32)
    logits = np.asarray(jax_llama.forward(jax_params, jnp.asarray(prompt),
                                          config))[0, -1] / 1.5
    top = np.argsort(-logits)[:8]
    probs = np.exp(logits[top] - logits[top].max())
    probs /= probs.sum()

    rows, frames = 512, 4
    pipeline = make_pipeline(engine, document(
        "p_sample", "(LlamaChatElement)",
        [element("LlamaChatElement", "LlamaChatElement",
                 [("tokens", "array")],
                 [("tokens_out", "array"), ("tokens_per_second", "float")],
                 {"model_config": F32_KEY, "max_new_tokens": 1,
                  "temperature": 1.5, "top_k": 8}, module=ML_MODULE)],
        runtime="python"), broker="sample")
    out = queue.Queue()
    firsts = []
    for frame in range(frames):
        stream_id = f"s{frame}"
        pipeline.create_stream(stream_id, queue_response=out,
                               parameters={"sample_seed": frame})
        pipeline.post_frame(stream_id, {"tokens": np.repeat(prompt, rows,
                                                            axis=0)})
        engine.drain()
        tokens_out = out.get_nowait()[2]["tokens_out"].numpy()
        np.testing.assert_array_equal(tokens_out[:, :4],
                                      np.repeat(prompt, rows, axis=0))
        firsts.append(tokens_out[:, 4])
    firsts = np.concatenate(firsts)
    assert set(firsts.tolist()) <= set(top.tolist())
    counts = np.array([(firsts == token).sum() for token in top])
    expected = probs * firsts.size
    chi2 = float(((counts - expected) ** 2 / expected).sum())
    assert chi2 < 24.32, (chi2, counts, expected)
    assert len(set(firsts.tolist())) > 1
