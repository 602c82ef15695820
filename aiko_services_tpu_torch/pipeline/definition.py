"""Pipeline definitions: JSON documents → validated dataclasses.

The port's copy of ``aiko_services_tpu/pipeline/definition.py`` (it has
no JAX in it).

Reference parity: upstream aiko_services ``main/pipeline.py:
140-181`` (dataclasses), ``953-1030`` (parser), ``1432-1561`` (the inline
Avro schema — replaced here by a JSON Schema, since this image carries
``jsonschema`` but not ``avro``; the accepted document shape is the same).

Document shape (version 0)::

    {
      "version": 0, "name": "p_demo", "runtime": "python",
      "graph": ["(PE_A (PE_B))"],
      "parameters": {...},                     # optional pipeline-level
      "elements": [
        { "name": "PE_A",
          "input":  [{"name": "text", "type": "str"}],
          "output": [{"name": "text", "type": "str"}],
          "parameters": {...},
          "deploy": {
            "local":  {"module": "pkg.mod", "class_name": "PE_A"},
            # or
            "remote": {"service_filter": {"name": "...", "protocol": "..."}}
          }
        }, ...
      ]
    }

``runtime`` additionally accepts ``"tpu"`` (elements compiled/fused by the
TPU execution layer); ``"#"``-prefixed keys are comments and discarded,
matching the reference's convention (pipeline.py:966-967).
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

try:
    import jsonschema
    _JSONSCHEMA = True
except ImportError:  # pragma: no cover
    _JSONSCHEMA = False

__all__ = [
    "PipelineDefinition", "PipelineElementDefinition",
    "PipelineElementDeployLocal", "PipelineElementDeployRemote",
    "parse_pipeline_definition", "load_pipeline_definition",
    "PIPELINE_DEFINITION_SCHEMA",
]

PIPELINE_DEFINITION_SCHEMA = {
    "type": "object",
    "required": ["version", "name", "runtime", "graph", "elements"],
    "properties": {
        "version": {"type": "integer", "enum": [0]},
        "name": {"type": "string"},
        "runtime": {"type": "string", "enum": ["python", "tpu"]},
        "graph": {"type": "array", "items": {"type": "string"}},
        "parameters": {"type": "object"},
        "elements": {
            "type": "array",
            "items": {
                "type": "object",
                "required": ["name", "input", "output", "deploy"],
                "properties": {
                    "name": {"type": "string"},
                    "input": {"type": "array", "items": {
                        "type": "object",
                        "required": ["name", "type"],
                        "properties": {"name": {"type": "string"},
                                       "type": {"type": "string"}}}},
                    "output": {"type": "array", "items": {
                        "type": "object",
                        "required": ["name", "type"],
                        "properties": {"name": {"type": "string"},
                                       "type": {"type": "string"}}}},
                    "parameters": {"type": "object"},
                    "deploy": {
                        "type": "object",
                        "minProperties": 1,
                        "maxProperties": 1,
                        "properties": {
                            "local": {
                                "type": "object",
                                "required": ["module", "class_name"],
                            },
                            "remote": {
                                "type": "object",
                                "required": ["service_filter"],
                            },
                        },
                    },
                },
            },
        },
    },
}


@dataclass
class PipelineElementDeployLocal:
    module: str
    class_name: str


@dataclass
class PipelineElementDeployRemote:
    service_filter: Dict[str, str]


@dataclass
class PipelineElementDefinition:
    name: str
    input: List[Dict[str, str]] = field(default_factory=list)
    output: List[Dict[str, str]] = field(default_factory=list)
    parameters: Dict[str, Any] = field(default_factory=dict)
    deploy_local: Optional[PipelineElementDeployLocal] = None
    deploy_remote: Optional[PipelineElementDeployRemote] = None

    @property
    def is_remote(self) -> bool:
        return self.deploy_remote is not None

    def input_names(self) -> List[str]:
        return [io["name"] for io in self.input]

    def output_names(self) -> List[str]:
        return [io["name"] for io in self.output]


@dataclass
class PipelineDefinition:
    version: int
    name: str
    runtime: str
    graph: List[str]
    parameters: Dict[str, Any] = field(default_factory=dict)
    elements: List[PipelineElementDefinition] = field(default_factory=list)

    def element(self, name: str) -> Optional[PipelineElementDefinition]:
        for definition in self.elements:
            if definition.name == name:
                return definition
        return None


def _strip_comments(node: Any) -> Any:
    """Discard "#"-prefixed keys recursively (reference convention)."""
    if isinstance(node, dict):
        return {k: _strip_comments(v) for k, v in node.items()
                if not str(k).startswith("#")}
    if isinstance(node, list):
        return [_strip_comments(item) for item in node]
    return node


def parse_pipeline_definition(document: Dict) -> PipelineDefinition:
    document = _strip_comments(document)
    if _JSONSCHEMA:
        jsonschema.validate(document, PIPELINE_DEFINITION_SCHEMA)
    elements = []
    for spec in document["elements"]:
        deploy = spec["deploy"]
        local = remote = None
        if "local" in deploy:
            local = PipelineElementDeployLocal(
                module=deploy["local"]["module"],
                class_name=deploy["local"]["class_name"])
        elif "remote" in deploy:
            remote = PipelineElementDeployRemote(
                service_filter=dict(deploy["remote"]["service_filter"]))
        else:
            raise ValueError(
                f"Element {spec['name']}: deploy must be local or remote")
        elements.append(PipelineElementDefinition(
            name=spec["name"],
            input=list(spec.get("input", [])),
            output=list(spec.get("output", [])),
            parameters=dict(spec.get("parameters", {})),
            deploy_local=local, deploy_remote=remote))
    definition = PipelineDefinition(
        version=int(document["version"]),
        name=document["name"],
        runtime=document["runtime"],
        graph=list(document["graph"]),
        parameters=dict(document.get("parameters", {})),
        elements=elements)
    names = [e.name for e in definition.elements]
    if len(names) != len(set(names)):
        raise ValueError(f"Duplicate element names: {names}")
    return definition


def load_pipeline_definition(pathname: str) -> PipelineDefinition:
    with open(pathname, encoding="utf-8") as f:
        return parse_pipeline_definition(json.load(f))


def apply_output_renames(renames, outputs):
    """Map-out edge semantics (reference pipeline.py:1314-1320): pop each
    mapped output name and write its value under every consumer-
    namespaced target key.  The single definition both the hot loop and
    fused TPU stages apply, so their numerics cannot diverge."""
    if not renames:
        return outputs
    for from_name, targets in renames.items():
        if from_name in outputs:
            value = outputs.pop(from_name)
            for target in targets:
                outputs[target] = value
    return outputs
