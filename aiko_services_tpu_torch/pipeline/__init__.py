"""The pipeline engine of the port (``aiko_services_tpu/pipeline/``):
definitions, the graph's streams and frames, ``Pipeline``, the payload
codec, the fused device stages (:mod:`.tpu_stage`, CUDA graphs on the
card) and the prefetcher.  The CLI is :mod:`.cli` (``python -m
aiko_services_tpu_torch.pipeline.cli create <definition>``)."""

from .stream import (
    Stream, Frame, StreamEvent, StreamState, DEFAULT_STREAM_ID,
)
from .definition import (
    PipelineDefinition, PipelineElementDefinition,
    parse_pipeline_definition, load_pipeline_definition,
)
from .codec import encode_swag, decode_swag, encode_value, decode_value
from .element import PipelineElement
from .pipeline import Pipeline, PipelineRemote, DEFAULT_GRACE_TIME
from .prefetch import DevicePrefetcher
