"""Device execution layer: device elements and stage fusion.

Port of ``aiko_services_tpu/pipeline/tpu_stage.py``, names kept, so a
definition's ``"runtime": "tpu"`` fuses the same runs.  The pipeline
graph stays a host-side dataflow engine, and contiguous runs of device
elements are fused into ONE program: between fused elements no host
transfer, no serialization, no per-element dispatch; array swag values
are tensors on the element's device end to end.

* :class:`TpuElement`: subclasses declare ``compute(params, inputs) ->
  outputs``, a pure function over tensors, plus optional
  ``init_params(seed)``.  Its device is the ``device`` parameter through
  ``get_parameter`` (the element's parameters, then the pipeline's), and
  the card (:func:`~..device.resolve_device`) when none is given: with no
  card it raises.  Standalone, each TpuElement still runs as one program.
* :func:`build_fused_stages` walks an execution path and groups maximal
  contiguous TpuElement runs; each group composes one function
  (per-element input renames resolved as it runs).
* :class:`GraphedProgram` is the port's ``jax.jit``: on the card it
  captures the function as one CUDA graph per input-shape signature
  (warmed on a side stream first, then captured on that stream) and
  replays it, copying each output out of the graph's static buffers
  before it reaches the swag (the next replay overwrites them while the
  frame may still be in flight).  On the CPU it runs eagerly.  As in
  ``llama.ChunkGraph`` (both capture through ``_cuda.capture_graph``), a
  capture's kernel launches are taken back from the wrappers' counters
  and added on every replay, the kernels' scratch it writes is held with
  the graph, and a capture that fails raises: nothing falls back to the
  eager program on the card.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..models.bridge import tensor_from_numpy
from ..obs import trace
from ..ops import _cuda
from .definition import apply_output_renames
from .element import PipelineElement
from .stream import StreamEvent

__all__ = ["TpuElement", "FusedStage", "build_fused_stages", "is_array",
           "GraphedProgram", "element_device", "to_tensor"]

#: What JAX's default (32-bit) mode makes of 64-bit host values, which the
#: port follows so that a fused stage sees the dtypes the JAX one does.
_CANONICAL = {torch.float64: torch.float32, torch.int64: torch.int32,
              torch.complex128: torch.complex64}


def is_array(value: Any) -> bool:
    return torch.is_tensor(value) or hasattr(value, "__array__")


def to_tensor(value: Any, device: torch.device) -> torch.Tensor:
    """``value`` (tensor, numpy array, list or scalar) as a tensor on
    ``device``, 64-bit types narrowed to 32 as ``jnp.asarray`` narrows
    them.  Raises TypeError or ValueError for what no array holds."""
    if torch.is_tensor(value):
        tensor = value
    else:
        array = np.asarray(value)
        if array.dtype.kind not in "biufc" and \
                array.dtype.name != "bfloat16":
            raise TypeError(f"not an array of numbers: {array.dtype}")
        tensor = tensor_from_numpy(array)
    tensor = tensor.to(_CANONICAL.get(tensor.dtype, tensor.dtype))
    return tensor.to(device)


def element_device(element: PipelineElement) -> torch.device:
    """The device an element computes on: its ``device`` parameter (the
    element's parameters first, then the pipeline's), else the card; with
    neither it raises (:func:`~..device.resolve_device`)."""
    device, _ = element.get_parameter("device", None)
    return resolve_device(device)


class GraphedProgram:
    """``fn(params, arrays) -> dict`` as one program: a CUDA graph per
    input signature on the card, eager on the CPU (see the module
    docstring).  ``params`` are read where they lie: a call with another
    params object drops the graphs captured over the old one."""

    def __init__(self, fn: Callable, device: torch.device):
        self.fn, self.device = fn, device
        #: signature -> (graph, static inputs, outputs, launches a replay,
        #: the kernels' scratch the graph writes, held)
        self._graphs: Dict[Tuple, Tuple] = {}
        self._params = None
        self._stream: Optional[torch.cuda.Stream] = None
        self.captures = 0
        self.replays = 0

    @staticmethod
    def signature(arrays: Dict[str, torch.Tensor]) -> Tuple:
        return tuple((key, tuple(value.shape), value.dtype)
                     for key, value in sorted(arrays.items()))

    def __call__(self, params, arrays: Dict[str, torch.Tensor]) -> Dict:
        if self.device.type != "cuda":
            with torch.no_grad():
                return dict(self.fn(params, arrays))
        if params is not self._params:
            self._graphs.clear()
            self._params = params
        key = self.signature(arrays)
        captured = self._graphs.get(key)
        if captured is None:
            captured = self._graphs[key] = self._capture(params, arrays)
        graph, static, outputs, launches, _ = captured
        for name, value in arrays.items():
            static[name].copy_(value)
        graph.replay()
        _cuda.add_launches(launches)
        self.replays += 1
        result, copies = {}, {}
        for name, value in outputs.items():
            if not torch.is_tensor(value):
                result[name] = value
            elif name in static and value is static[name]:
                result[name] = arrays[name]     # an input passed through
            else:
                if id(value) not in copies:
                    copies[id(value)] = value.clone()
                result[name] = copies[id(value)]
        return result

    def _capture(self, params, arrays):
        """Warm the program once on the side stream (cuBLAS / cuDNN
        handles and workspaces, lazily made index tensors), then capture
        it there over static copies of the inputs."""
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        static = {name: value.clone() for name, value in arrays.items()}
        current = torch.cuda.current_stream(self.device)
        self._stream.wait_stream(current)
        with torch.no_grad(), torch.cuda.stream(self._stream):
            self.fn(params, static)
        current.wait_stream(self._stream)
        with torch.no_grad():
            graph, outputs, launches, scratch = _cuda.capture_graph(
                lambda: dict(self.fn(params, static)), self.device,
                self._stream)
        self.captures += 1
        return graph, static, outputs, launches, scratch


class TpuElement(PipelineElement):
    """A PipelineElement whose computation is a pure tensor function."""

    def __init__(self, context, process=None):
        super().__init__(context, process)
        self.device = element_device(self)
        seed, _ = self.get_parameter("seed", 0)
        self.params = self.init_params(int(seed))
        self._program: Optional[GraphedProgram] = None

    # -- subclass API -------------------------------------------------------- #

    def init_params(self, seed: int) -> Any:
        """Return this element's parameter tree (weights) on
        ``self.device``, drawn from ``seed``."""
        return {}

    def compute(self, params, inputs: Dict[str, torch.Tensor]) \
            -> Dict[str, torch.Tensor]:
        """Pure tensor function: swag-name -> tensor in/out.  On the card
        it is captured into a CUDA graph, so it reads no tensor back to
        the host and makes no shape from tensor values."""
        raise NotImplementedError

    # -- standalone execution (not fused) ------------------------------------- #

    def process_frame(self, stream, **inputs):
        if self._program is None:
            self._program = GraphedProgram(self.compute, self.device)
        arrays = {k: to_tensor(v, self.device) for k, v in inputs.items()}
        return StreamEvent.OKAY, self._program(self.params, arrays)


class FusedStage:
    """A maximal contiguous run of TpuElements run as one program."""

    def __init__(self, nodes: Sequence, elements: List[TpuElement],
                 input_sources: Dict[str, Dict[str, str]],
                 output_renames: Dict[str, Dict[str, List[str]]]):
        self.node_names = [node.name for node in nodes]
        self.elements = elements
        # node name -> {input: swag key} / {output: [namespaced keys]}
        # (the pipeline's map_in/map_out edge semantics, resolved as the
        # program runs, so fused numerics match the unfused hot loop).
        self.input_sources = input_sources
        self.output_renames = output_renames
        self.name = "+".join(self.node_names)
        devices = {element.device for element in elements}
        if len(devices) != 1:
            raise ValueError(f"fused stage {self.name}: its elements are on "
                             f"several devices {sorted(map(str, devices))}")
        self.device = devices.pop()
        # Params are snapshotted when the stage is built, as the JAX stage
        # binds its jitted program to them.
        self._params = tuple(element.params for element in self.elements)
        self._compiled = GraphedProgram(self._trace, self.device)
        # Swag keys the member elements consume (post-mapping): these are
        # coerced to tensors (lists/scalars included) so fusion accepts
        # exactly what the standalone TpuElement path accepts.
        self._consumed = set()
        for element in self.elements:
            mapping = self.input_sources.get(element.name, {})
            names = (element.definition.input_names()
                     if element.definition else [])
            for input_name in names:
                self._consumed.add(mapping.get(input_name, input_name))

    def _trace(self, params: Tuple, swag_arrays: Dict[str, torch.Tensor]):
        """Composed compute across member elements: the one program."""
        pool = dict(swag_arrays)
        for element, element_params in zip(self.elements, params):
            mapping = self.input_sources.get(element.name, {})
            names = (element.definition.input_names()
                     if element.definition else list(pool))
            inputs = {}
            for input_name in names:
                source = mapping.get(input_name, input_name)
                if source in pool:
                    inputs[input_name] = pool[source]
            outputs = apply_output_renames(
                self.output_renames.get(element.name),
                dict(element.compute(element_params, inputs)))
            pool.update(outputs)
        return pool

    def __call__(self, swag: Dict[str, Any]) -> Dict[str, Any]:
        """Run the fused program over the array-valued swag entries;
        non-array entries pass through untouched.  Computed outputs take
        precedence over passthrough values of the same name (matching the
        non-fused ``frame.swag.update(outputs)`` semantics)."""
        arrays = {}
        passthrough = {}
        for key, value in swag.items():
            if is_array(value):
                arrays[key] = to_tensor(value, self.device)
            elif key in self._consumed:
                try:   # lists / scalars an element declared as input
                    arrays[key] = to_tensor(value, self.device)
                except (TypeError, ValueError):
                    passthrough[key] = value
            else:
                passthrough[key] = value
        # Names this stage's device work in torch.profiler traces (and in
        # NVTX on the card), as the JAX stage's TraceAnnotation does.
        with trace.annotate(f"stage:{self.name}",
                            cuda=self.device.type == "cuda"):
            result = self._compiled(self._params, arrays)
        return {**passthrough, **result}

    def sync_outputs(self, swag: Dict[str, Any]) -> None:
        """Block until this stage's device work is COMPLETE: a CUDA event
        recorded on the stream the stage ran on, and waited for (the
        stream is FIFO, so it covers the whole program).  Used for sampled
        device-true frame metrics; nothing to wait for on the CPU."""
        if self.device.type != "cuda":
            return
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(self.device))
        event.synchronize()


def build_fused_stages(path_nodes: Sequence, elements: Dict[str, Any],
                       input_sources: Dict[str, Dict[str, str]],
                       output_renames: Dict[str, Dict[str, List[str]]]) \
        -> Dict[str, FusedStage]:
    """Group maximal contiguous runs of TpuElements along an execution
    path.  Returns {first-node-name: FusedStage} for runs of length >= 2
    (a single TpuElement already runs as one program on its own)."""
    stages: Dict[str, FusedStage] = {}
    run: List = []

    def flush():
        nonlocal run
        if len(run) >= 2:
            stage = FusedStage(
                run, [elements[n.name] for n in run],
                {n.name: input_sources.get(n.name, {}) for n in run},
                {n.name: output_renames.get(n.name, {}) for n in run})
            stages[run[0].name] = stage
        run = []

    for node in path_nodes:
        element = elements.get(node.name)
        if isinstance(element, TpuElement):
            run.append(node)
        else:
            flush()
    flush()
    return stages
