"""Port parity: the pipeline engine of ``aiko_services_tpu_torch``.

The port's ``Pipeline`` (its copies of the definition parser, the graph,
streams, elements, the importer and the CLI) runs the scenarios of
tests/test_pipeline.py and tests/test_graph.py and must give what the JAX
package's engine gives there; graph paths are also compared with the JAX
package's ``Graph`` on the same definitions.  The elements the scenarios
deploy are defined in this file and named by its module path.  Plus: the
port's ``cli create`` on a text definition, the refusal of a definition
that names the JAX package, and the prefetcher on the CPU (its card side
is in tests/test_torch_cuda.py).
"""

import json
import pathlib
import queue
import sys
import time

import jax
import numpy as np
import pytest
import torch

from aiko_services_tpu.utils.graph import Graph as JaxGraph
from aiko_services_tpu_torch import transport
from aiko_services_tpu_torch.pipeline import (
    Pipeline, PipelineElement, StreamEvent, parse_pipeline_definition)
from aiko_services_tpu_torch.pipeline.pipeline import REMOTE_RETRY_DELAY
from aiko_services_tpu_torch.pipeline.prefetch import DevicePrefetcher
from aiko_services_tpu_torch.pipeline.stream import StreamState
from aiko_services_tpu_torch.registry import Registrar
from aiko_services_tpu_torch.runtime import (
    EventEngine, Process, VirtualClock, compose_instance, faults,
    pipeline_args, set_default_process)
from aiko_services_tpu_torch.utils.graph import Graph, Node
from aiko_services_tpu_torch.utils.importer import load_module

MODULE = __name__
REPO = pathlib.Path(__file__).resolve().parent.parent


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
    """The port's deterministic event engine on a virtual clock."""
    return EventEngine(clock=VirtualClock())


# --------------------------------------------------------------------------- #
# Elements the scenarios deploy (``deploy.local.module`` is this module)


class PE_Emit(PipelineElement):
    """Source: emits the frame_data it was given (identity on swag)."""

    def process_frame(self, stream, **inputs):
        return StreamEvent.OKAY, inputs


class PE_Add(PipelineElement):
    def process_frame(self, stream, i):
        amount, _ = self.get_parameter("amount", 1, stream=stream)
        return StreamEvent.OKAY, {"i": int(i) + int(amount)}


class PE_Double(PipelineElement):
    def process_frame(self, stream, i):
        return StreamEvent.OKAY, {"i": int(i) * 2}


class PE_Sum(PipelineElement):
    """Fan-in: sums two renamed inputs."""

    def process_frame(self, stream, a, b):
        return StreamEvent.OKAY, {"total": int(a) + int(b)}


class PE_DropOdd(PipelineElement):
    def process_frame(self, stream, i):
        if int(i) % 2:
            return StreamEvent.DROP_FRAME, {}
        return StreamEvent.OKAY, {"i": i}


class PE_StopAt(PipelineElement):
    def process_frame(self, stream, i):
        limit, _ = self.get_parameter("limit", 3, stream=stream)
        if int(i) >= int(limit):
            return StreamEvent.STOP, {}
        return StreamEvent.OKAY, {"i": i}


class PE_Boom(PipelineElement):
    def process_frame(self, stream, **inputs):
        raise RuntimeError("boom")


class PE_Collect(PipelineElement):
    """Sink: records everything it sees on the class, keyed by element
    name (the test's observation point)."""

    seen = {}

    def start_stream(self, stream, stream_id):
        self.seen.setdefault(self.name, [])
        return StreamEvent.OKAY, None

    def process_frame(self, stream, **inputs):
        self.seen.setdefault(self.name, []).append(dict(inputs))
        return StreamEvent.OKAY, inputs


class PE_CountSource(PipelineElement):
    """start_stream launches a paced generator of 0..limit-1."""

    def start_stream(self, stream, stream_id):
        limit, _ = self.get_parameter("limit", 5, stream=stream)
        rate, _ = self.get_parameter("rate", 0, stream=stream)

        def generate(stream_, frame_id):
            if frame_id >= int(limit):
                return StreamEvent.STOP, None
            return StreamEvent.OKAY, {"i": frame_id}

        self.create_frames(stream, generate, rate=float(rate) or None)
        return StreamEvent.OKAY, None

    def process_frame(self, stream, i):
        return StreamEvent.OKAY, {"i": i}


class PE_SlowStartTarget(PipelineElement):
    """start_stream is slow; process_frame requires it to have run."""

    def start_stream(self, stream, stream_id):
        time.sleep(0.2)
        stream.variables["slow_start_ready"] = True
        return StreamEvent.OKAY, None

    def process_frame(self, stream, i):
        if not stream.variables.get("slow_start_ready"):
            return StreamEvent.ERROR, {}
        return StreamEvent.OKAY, {"i": i}


class PE_EndProcess(PipelineElement):
    """Terminal element of the CLI scenario: ends the process's event
    loop once the frame reached it, so ``cli create`` returns."""

    def process_frame(self, stream, texts):
        self.process.event.terminate()
        return StreamEvent.OKAY, {"texts": texts}


# --------------------------------------------------------------------------- #
# helpers (as tests/test_pipeline.py's)


def element(name, cls, inputs, outputs, parameters=None, module=MODULE):
    return {
        "name": name,
        "input": [{"name": n, "type": t} for n, t in inputs],
        "output": [{"name": n, "type": t} for n, t in outputs],
        "parameters": parameters or {},
        "deploy": {"local": {"module": module, "class_name": cls}},
    }


def make_pipeline(engine, document, pid="1", broker="pipe", name=None):
    process = Process(namespace="test", hostname="h", pid=pid,
                      engine=engine, broker=broker)
    definition = parse_pipeline_definition(document)
    return compose_instance(
        Pipeline, pipeline_args(name or definition.name,
                                definition=definition),
        process=process), process


def run_frames(engine, pipeline, frames, stream_id="s1", parameters=None):
    out = queue.Queue()
    pipeline.create_stream(stream_id, parameters=parameters,
                           queue_response=out)
    for frame in frames:
        pipeline.post_frame(stream_id, frame)
    engine.drain()
    results = []
    while not out.empty():
        results.append(out.get()[2])
    return results


def pump_until(engine, done, seconds=5.0):
    deadline = time.time() + seconds
    while time.time() < deadline and not done():
        engine.drain()
        time.sleep(0.01)


LINEAR = {
    "version": 0, "name": "p_linear", "runtime": "python",
    "graph": ["(PE_Add PE_Double)"],
    "elements": [
        element("PE_Add", "PE_Add", [("i", "int")], [("i", "int")],
                {"amount": 3}),
        element("PE_Double", "PE_Double", [("i", "int")], [("i", "int")]),
    ],
}

FAN = {
    "version": 0, "name": "p_fan", "runtime": "python",
    "graph": ["(PE_Emit (PE_Add PE_Sum (i: a)) (PE_Double PE_Sum (i: b)))"],
    "elements": [
        element("PE_Emit", "PE_Emit", [("i", "int")], [("i", "int")]),
        element("PE_Add", "PE_Add", [("i", "int")], [("i", "int")]),
        element("PE_Double", "PE_Double", [("i", "int")], [("i", "int")]),
        element("PE_Sum", "PE_Sum", [("a", "int"), ("b", "int")],
                [("total", "int")]),
    ],
}

REMOTE_STAGE = {
    "name": "PE_RemoteStage",
    "input": [{"name": "i", "type": "int"}],
    "output": [{"name": "i", "type": "int"}],
    "deploy": {"remote": {"service_filter": {"name": "p_remote"}}},
}

REMOTE_CALLEE = {
    "version": 0, "name": "p_remote", "runtime": "python",
    "graph": ["(PE_Double)"],
    "elements": [
        element("PE_Double", "PE_Double", [("i", "int")], [("i", "int")]),
    ],
}


def remote_caller(name, graph, head, tail):
    return {"version": 0, "name": name, "runtime": "python",
            "graph": [graph], "elements": head + [REMOTE_STAGE] + tail}


def registrar_on(engine, broker):
    process = Process(namespace="test", hostname="h", pid="9",
                      engine=engine, broker=broker)
    registrar = Registrar(process=process)
    engine.advance(4.0)
    return registrar


# --------------------------------------------------------------------------- #
# graph (tests/test_graph.py), each against the JAX package's Graph too


def names(nodes):
    return [n.name for n in nodes]


@pytest.mark.parametrize("definition,head,want", [
    (["(a b c)"], None, ["a", "b", "c"]),
    (["(a (b d) (c d))"], None, ["a", "b", "c", "d"]),
    (["(a b)", "(x y)"], "x", ["x", "y"]),
    (["(a b)", "(x y)"], None, ["a", "b"]),
    (["(a (b c e) (d e))"], None, ["a", "b", "c", "d", "e"]),
], ids=["linear", "fan_out_fan_in", "second_head", "first_head",
        "deep_join"])
def test_graph_paths(definition, head, want):
    graph = Graph.traverse(definition)
    assert names(graph.get_path(head)) == want
    assert names(JaxGraph.traverse(definition).get_path(head)) == want


def test_graph_properties_callback():
    seen, jax_seen = [], []
    definition = ["(a (b d (key_0: value_0)) (c d (key_1: value_1)))"]
    Graph.traverse(definition,
                   lambda node, props, pred: seen.append((node, props,
                                                          pred)))
    JaxGraph.traverse(definition, lambda node, props, pred:
                      jax_seen.append((node, props, pred)))
    assert seen == jax_seen == [("d", {"key_0": "value_0"}, "b"),
                                ("d", {"key_1": "value_1"}, "c")]


def test_graph_multiple_heads():
    graph = Graph.traverse(["(a b)", "(x y)"])
    assert graph.head_names == ["a", "x"]


def test_graph_iterate_after():
    graph = Graph.traverse(["(a b c d)"])
    assert names(graph.iterate_after("b")) == ["c", "d"]
    assert names(graph.iterate_after("d")) == []
    assert names(graph.iterate_after("zz")) == []


def test_graph_path_local_remote():
    for side in (Graph, JaxGraph):
        assert side.path_local("p1:p2") == "p1"
        assert side.path_remote("p1:p2") == "p2"
        assert side.path_local("p1") == "p1"
        assert side.path_remote("p1") is None
        assert side.path_local(None) is None


def test_graph_manual_construction():
    graph = Graph()
    a, b = Node("a"), Node("b")
    a.add("b")
    graph.add(a, head=True)
    graph.add(b)
    assert names(graph.get_path()) == ["a", "b"]
    assert "a" in graph and "z" not in graph
    a.remove("b")                       # an edge change re-plans the path
    assert names(graph.get_path()) == ["a"]


# --------------------------------------------------------------------------- #
# definitions


def test_linear_pipeline(engine):
    pipeline, _ = make_pipeline(engine, LINEAR)
    results = run_frames(engine, pipeline, [{"i": 1}, {"i": 10}])
    assert results == [{"i": 8}, {"i": 26}]    # (i+3)*2


@pytest.mark.parametrize("document", [
    {"version": 1, "name": "x", "runtime": "python", "graph": [],
     "elements": []},
    {"version": 0, "name": "x", "runtime": "python", "graph": ["(A)"],
     "elements": [{"name": "A", "input": [], "output": [], "deploy": {}}]},
], ids=["bad_version", "empty_deploy"])
def test_definition_validation_rejects_bad(document):
    with pytest.raises(Exception):
        parse_pipeline_definition(document)


def test_comment_keys_stripped():
    definition = parse_pipeline_definition(dict(LINEAR, **{"#note": "x"}))
    assert definition.name == "p_linear"


def test_definition_naming_the_jax_package_raises_without_import(engine):
    """Every file under examples/ names ``aiko_services_tpu.elements``:
    the port refuses it by name, pointing at its own counterpart, and
    never imports the JAX package for it."""
    document = json.loads((REPO / "examples" / "vision_llm" /
                           "pipeline_vision_llm.json").read_text())
    loaded = {name for name in sys.modules
              if name.split(".")[0] == "aiko_services_tpu"}
    with pytest.raises(ImportError,
                       match="aiko_services_tpu_torch.elements"):
        make_pipeline(engine, document, broker="jaxdef")
    with pytest.raises(ImportError, match="aiko_services_tpu_torch.elements.ml"):
        load_module("aiko_services_tpu/elements/ml.py")
    assert {name for name in sys.modules
            if name.split(".")[0] == "aiko_services_tpu"} == loaded


# --------------------------------------------------------------------------- #
# the hot loop


def test_fan_out_fan_in_with_map_out(engine):
    """Both branches emit output 'i'; the edge renames pop each into a
    distinct consumer-namespaced key, so the branches cannot clobber each
    other: Add 5+1=6 -> PE_Sum.a, Double 5*2=10 -> PE_Sum.b, Sum 16."""
    pipeline, _ = make_pipeline(engine, FAN, broker="fan")
    assert run_frames(engine, pipeline, [{"i": 5}]) == [{"total": 16}]


@pytest.mark.parametrize("scenario", ["stop", "drop", "error"])
def test_stream_events(engine, scenario):
    """STOP destroys the stream at i = 2, DROP_FRAME drops odd frames and
    keeps the stream, an element's exception is a stream ERROR."""
    if scenario == "stop":
        document = {
            "version": 0, "name": "p_stop", "runtime": "python",
            "graph": ["(PE_StopAt PE_Collect)"],
            "elements": [
                element("PE_StopAt", "PE_StopAt", [("i", "int")],
                        [("i", "int")], {"limit": 2}),
                element("PE_Collect", "PE_Collect", [], []),
            ]}
        pipeline, _ = make_pipeline(engine, document, broker="stop")
        PE_Collect.seen.clear()
        pipeline.create_stream("s")
        for i in range(5):
            pipeline.post_frame("s", {"i": i})
        engine.drain()
        assert "s" not in pipeline.streams
        assert len(PE_Collect.seen.get("PE_Collect", [])) == 2
    elif scenario == "drop":
        document = {
            "version": 0, "name": "p_drop", "runtime": "python",
            "graph": ["(PE_DropOdd PE_Collect)"],
            "elements": [
                element("PE_DropOdd", "PE_DropOdd", [("i", "int")],
                        [("i", "int")]),
                element("PE_Collect", "PE_Collect", [], []),
            ]}
        pipeline, _ = make_pipeline(engine, document, broker="drop")
        results = run_frames(engine, pipeline, [{"i": i} for i in range(6)])
        assert [r["i"] for r in results] == [0, 2, 4]
        assert "s1" in pipeline.streams
    else:
        document = {"version": 0, "name": "p_boom", "runtime": "python",
                    "graph": ["(PE_Boom)"],
                    "elements": [element("PE_Boom", "PE_Boom", [], [])]}
        pipeline, _ = make_pipeline(engine, document, broker="boom")
        pipeline.create_stream("s")
        pipeline.post_frame("s", {})
        engine.drain()
        assert "s" not in pipeline.streams


def test_parameter_precedence(engine):
    pipeline, _ = make_pipeline(engine, LINEAR, broker="params")
    # stream[element] beats the element definition:
    assert run_frames(engine, pipeline, [{"i": 1}],
                      parameters={"PE_Add.amount": 10}) == [{"i": 22}]
    # a plain stream parameter loses to the element definition:
    assert run_frames(engine, pipeline, [{"i": 1}], stream_id="s2",
                      parameters={"amount": 100}) == [{"i": 8}]


def test_generator_source_with_stream_stop(engine):
    document = {
        "version": 0, "name": "p_gen", "runtime": "python",
        "graph": ["(PE_CountSource PE_Collect)"],
        "elements": [
            element("PE_CountSource", "PE_CountSource",
                    [("i", "int")], [("i", "int")], {"limit": 4}),
            element("PE_Collect", "PE_Collect", [("i", "int")],
                    [("i", "int")]),
        ],
    }
    pipeline, _ = make_pipeline(engine, document, broker="gen")
    PE_Collect.seen.clear()
    pipeline.create_stream("g")
    pump_until(engine, lambda: "g" not in pipeline.streams)
    assert [f["i"] for f in PE_Collect.seen["PE_Collect"]] == [0, 1, 2, 3]
    assert "g" not in pipeline.streams


def test_stream_lease_expiry_destroys_idle_stream(engine):
    pipeline, _ = make_pipeline(engine, LINEAR, broker="lease")
    pipeline.create_stream("idle", grace_time=5.0)
    assert "idle" in pipeline.streams
    engine.advance(6.0)
    assert "idle" not in pipeline.streams


def test_user_defined_event_stop_drains_in_flight_frames(engine):
    """A stop carrying a user-defined event value behaves as a graceful
    STOP: drain the in-flight frames, then tear down."""
    pipeline, _ = make_pipeline(engine, LINEAR, broker="userstop")
    pipeline.create_stream("u")
    engine.drain()
    stream = pipeline.streams["u"]
    custom_event = int(StreamEvent.USER) + 3
    stream.frames["0"] = object()
    pipeline._stream_stop_command("u", custom_event)
    assert stream.state == StreamState.STOP
    assert "u" in pipeline.streams
    stream.frames.clear()
    pipeline._stream_stop_command("u", custom_event)
    assert "u" not in pipeline.streams


def test_frames_park_until_all_elements_started(engine):
    """Frames a generator posts while later elements are still starting
    are parked until the whole stream has started."""
    document = {
        "version": 0, "name": "p_race", "runtime": "python",
        "graph": ["(PE_CountSource PE_SlowStartTarget)"],
        "elements": [
            element("PE_CountSource", "PE_CountSource",
                    [("i", "int")], [("i", "int")], {"limit": 5}),
            element("PE_SlowStartTarget", "PE_SlowStartTarget",
                    [("i", "int")], [("i", "int")]),
        ],
    }
    pipeline, _ = make_pipeline(engine, document, broker="race")
    thread = engine.run_in_thread()
    out = queue.Queue()
    pipeline.create_stream("s1", queue_response=out)
    results = []
    deadline = time.time() + 10
    while len(results) < 5 and time.time() < deadline:
        try:
            results.append(out.get(timeout=0.5)[2])
        except queue.Empty:
            pass
    assert [r["i"] for r in results] == [0, 1, 2, 3, 4]
    deadline = time.time() + 5
    while pipeline.streams and time.time() < deadline:
        time.sleep(0.02)
    assert not pipeline.streams
    engine.terminate()
    thread.join(timeout=5)
    assert not thread.is_alive()


def test_file_path_module_descriptor(engine, tmp_path):
    """Elements deploy from a source-file descriptor too; the module is
    loaded once and cached across elements."""
    source = tmp_path / "custom_elements.py"
    source.write_text(
        "from aiko_services_tpu_torch.pipeline import (PipelineElement,\n"
        "                                              StreamEvent)\n"
        "CALLS = []\n"
        "class PE_Neg(PipelineElement):\n"
        "    def process_frame(self, stream, i):\n"
        "        CALLS.append(self.name)\n"
        "        return StreamEvent.OKAY, {'i': -i}\n")
    document = {
        "version": 0, "name": "p_file", "runtime": "python",
        "graph": ["(PE_Neg PE_Neg2)"],
        "elements": [element(name, "PE_Neg", [("i", "int")],
                             [("i", "int")], module=str(source))
                     for name in ("PE_Neg", "PE_Neg2")],
    }
    pipeline, _ = make_pipeline(engine, document)
    assert run_frames(engine, pipeline, [{"i": 5}]) == [{"i": 5}]
    module = load_module(str(source))
    assert module is load_module(str(source))
    assert module.CALLS == ["PE_Neg", "PE_Neg2"]


# --------------------------------------------------------------------------- #
# remote elements over the loopback wire


def test_remote_element_crossing(engine):
    """The frame pauses at the remote node, crosses to the callee
    pipeline and resumes with its response: (i+1)*2 at the caller's sink."""
    registrar = registrar_on(engine, "remote")
    assert registrar.state == "primary"
    make_pipeline(engine, REMOTE_CALLEE, pid="2", broker="remote")
    caller, _ = make_pipeline(engine, remote_caller(
        "p_caller", "(PE_Add PE_RemoteStage PE_Collect)",
        [element("PE_Add", "PE_Add", [("i", "int")], [("i", "int")])],
        [element("PE_Collect", "PE_Collect", [("i", "int")],
                 [("i", "int")])]), pid="3", broker="remote")
    engine.drain()
    assert caller.remote_proxies["PE_RemoteStage"] is not None
    PE_Collect.seen.clear()
    caller.create_stream("r")
    caller.post_frame("r", {"i": 1})
    caller.post_frame("r", {"i": 10})
    engine.drain()
    assert [f["i"] for f in PE_Collect.seen["PE_Collect"]] == [4, 22]


def test_remote_element_retries_until_discovered(engine):
    registrar_on(engine, "late")
    caller, _ = make_pipeline(engine, remote_caller(
        "p_caller", "(PE_Add PE_RemoteStage PE_Collect)",
        [element("PE_Add", "PE_Add", [("i", "int")], [("i", "int")])],
        [element("PE_Collect", "PE_Collect", [("i", "int")],
                 [("i", "int")])]), pid="3", broker="late")
    engine.drain()
    assert caller.remote_proxies["PE_RemoteStage"] is None
    PE_Collect.seen.clear()
    caller.create_stream("r")
    caller.post_frame("r", {"i": 1})
    engine.drain()
    assert not PE_Collect.seen.get("PE_Collect")   # parked, retrying
    make_pipeline(engine, REMOTE_CALLEE, pid="2", broker="late")
    engine.advance(REMOTE_RETRY_DELAY + 1.0)
    engine.drain()
    assert [f["i"] for f in PE_Collect.seen["PE_Collect"]] == [4]


@pytest.mark.parametrize("tail", ["collect", "drop"])
def test_stop_drains_frames_paused_at_remote(engine, tail):
    """A source's STOP must not discard frames paused at a remote element:
    the stream drains, then tears down, also when its last frame is
    dropped after the remote hop (0 -> 0 -> +1 = 1, odd)."""
    broker = f"drain_{tail}"
    registrar_on(engine, broker)
    make_pipeline(engine, REMOTE_CALLEE, pid="2", broker=broker)
    if tail == "collect":
        document = remote_caller(
            "p_drain", "(PE_CountSource PE_RemoteStage PE_Collect)",
            [element("PE_CountSource", "PE_CountSource", [("i", "int")],
                     [("i", "int")], {"limit": 2})],
            [element("PE_Collect", "PE_Collect", [("i", "int")],
                     [("i", "int")])])
    else:
        document = remote_caller(
            "p_draindrop",
            "(PE_CountSource PE_RemoteStage PE_Add PE_DropOdd)",
            [element("PE_CountSource", "PE_CountSource", [("i", "int")],
                     [("i", "int")], {"limit": 1})],
            [element("PE_Add", "PE_Add", [("i", "int")], [("i", "int")],
                     {"amount": 1}),
             element("PE_DropOdd", "PE_DropOdd", [("i", "int")],
                     [("i", "int")])])
    caller, _ = make_pipeline(engine, document, pid="3", broker=broker)
    engine.drain()
    assert caller.remote_proxies["PE_RemoteStage"] is not None
    PE_Collect.seen.clear()
    caller.create_stream("d")
    pump_until(engine, lambda: "d" not in caller.streams)
    if tail == "collect":
        assert [f["i"] for f in PE_Collect.seen["PE_Collect"]] == [0, 2]
    assert "d" not in caller.streams


# --------------------------------------------------------------------------- #
# the port's names


PORTED = ("utils.graph", "utils.importer", "pipeline.stream",
          "pipeline.definition", "pipeline.element", "pipeline.pipeline",
          "pipeline.tpu_stage", "pipeline.prefetch", "elements.common_io",
          "elements.text_io", "elements.image_io", "elements.ml",
          "models.common", "models.vision", "models.detector",
          "models.classifier")


@pytest.mark.parametrize("module", PORTED)
def test_ported_module_exports_the_jax_names(module):
    import importlib
    jax_names = set(importlib.import_module(
        f"aiko_services_tpu.{module}").__all__)
    port = importlib.import_module(f"aiko_services_tpu_torch.{module}")
    assert jax_names <= set(port.__all__)
    assert all(hasattr(port, name) for name in jax_names)


@pytest.mark.parametrize("package", ["pipeline", "elements", "models"])
def test_package_names_exist_or_name_their_roadmap_item(package):
    """Every public name of the JAX package's ``pipeline``, ``elements``
    and ``models`` is the port's too, or raises naming the ROADMAP item
    that brings it."""
    import ast
    import importlib
    source = REPO / "aiko_services_tpu" / package / "__init__.py"
    names = set()
    for node in ast.walk(ast.parse(source.read_text())):
        if isinstance(node, ast.ImportFrom) and node.level == 1:
            names |= {alias.asname or alias.name for alias in node.names}
            if node.module:
                names.add(node.module.split(".")[0])
    port = importlib.import_module(f"aiko_services_tpu_torch.{package}")
    pending = []
    for name in sorted(names):
        try:
            getattr(port, name)
        except NotImplementedError as error:
            assert "ROADMAP.md queue 1 item 9" in str(error), error
            pending.append(name)
    if package == "elements":
        assert "VideoReadFile" in pending and "audio_io" in pending
        with pytest.raises(NotImplementedError, match="item 9b"):
            make_pipeline(EventEngine(clock=VirtualClock()), {
                "version": 0, "name": "p_asr", "runtime": "python",
                "graph": ["(ASRElement)"],
                "elements": [element("ASRElement", "ASRElement",
                                     [("audio", "array")],
                                     [("text_tokens", "array")],
                                     module="aiko_services_tpu_torch"
                                     ".elements")]}, broker="asr")
    else:
        assert pending == (["asr"] if package == "models" else [])


# --------------------------------------------------------------------------- #
# the CLI


def test_cli_create_runs_a_text_definition(tmp_path):
    """``cli create`` over the port's Pipeline: a text file read,
    upper-cased and written, as the JAX CLI runs it."""
    from click.testing import CliRunner
    from aiko_services_tpu_torch.pipeline import cli

    text_module = "aiko_services_tpu_torch.elements"
    (tmp_path / "in.txt").write_text("hello pipeline")
    target = tmp_path / "out.txt"
    document = {
        "version": 0, "name": "p_text", "runtime": "python",
        "graph": ["(TextReadFile TextTransform TextWriteFile "
                  "PE_EndProcess)"],
        "elements": [
            element("TextReadFile", "TextReadFile", [("paths", "list")],
                    [("texts", "list")],
                    {"data_sources": f"file://{tmp_path / 'in.txt'}"},
                    module=text_module),
            element("TextTransform", "TextTransform", [("texts", "list")],
                    [("texts", "list")], {"transform": "upper"},
                    module=text_module),
            element("TextWriteFile", "TextWriteFile", [("texts", "list")],
                    [("texts", "list")],
                    {"data_targets": f"file://{target}"},
                    module=text_module),
            element("PE_EndProcess", "PE_EndProcess", [("texts", "list")],
                    [("texts", "list")]),
        ],
    }
    path = tmp_path / "p_text.json"
    path.write_text(json.dumps(document))
    engine = EventEngine()
    process = Process(namespace="test", hostname="h", pid="1",
                      engine=engine, broker="cli")
    set_default_process(process)
    # A backstop, should the frame never reach PE_EndProcess.
    engine.add_timer_handler(engine.terminate, 20.0, once=True)
    try:
        result = CliRunner().invoke(cli.main, ["create", str(path)])
    finally:
        set_default_process(None)
        engine.terminate()
    assert result.exit_code == 0, result.output
    assert target.read_text() == "HELLO PIPELINE"


# --------------------------------------------------------------------------- #
# the prefetcher on the CPU (tests/test_pipeline.py's two scenarios)


def test_device_prefetcher_orders_backpressures_and_propagates_errors():
    produced = []

    def source(n=6):
        for i in range(n):
            produced.append(i)
            yield np.full((2, 2), i, np.int32)

    with DevicePrefetcher(source(), depth=2, device="cpu") as prefetcher:
        batches = list(prefetcher)
    assert all(torch.is_tensor(b) and b.dtype == torch.int32
               for b in batches)
    assert [int(b[0, 0]) for b in batches] == list(range(6))

    produced.clear()
    prefetcher = DevicePrefetcher(source(50), depth=2, device="cpu")
    time.sleep(0.2)
    assert len(produced) <= 4        # depth + in-flight transfer slack
    prefetcher.close()

    def bad_source():
        yield np.zeros((1,), np.float32)
        raise RuntimeError("boom")

    prefetcher = DevicePrefetcher(bad_source(), depth=2, device="cpu")
    next(prefetcher)
    with pytest.raises(RuntimeError, match="boom"):
        next(prefetcher)


def test_device_prefetcher_terminal_and_depth1_close():
    prefetcher = DevicePrefetcher(
        (np.zeros((1,), np.int32) for _ in range(2)), depth=1,
        device="cpu")
    assert len(list(prefetcher)) == 2
    for _ in range(3):
        with pytest.raises(StopIteration):
            next(prefetcher)
    prefetcher = DevicePrefetcher(
        (np.zeros((1,), np.int32) for _ in range(50)), depth=1,
        device="cpu")
    time.sleep(0.1)
    prefetcher.close()
    prefetcher._thread.join(timeout=2)
    assert not prefetcher._thread.is_alive()


def test_device_prefetcher_trees_and_no_device():
    """A dict batch comes back as a dict of tensors equal to the host
    arrays; with no device and no card the prefetcher raises."""
    rng = np.random.default_rng(0)
    batches = [{"x": rng.standard_normal((3, 4)).astype(np.float32),
                "ids": (np.arange(3, dtype=np.int32),)} for _ in range(3)]
    got = list(DevicePrefetcher(iter(batches), device="cpu"))
    for batch, host in zip(got, batches):
        np.testing.assert_array_equal(batch["x"].numpy(), host["x"])
        np.testing.assert_array_equal(batch["ids"][0].numpy(),
                                      host["ids"][0])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            DevicePrefetcher(iter(batches))
