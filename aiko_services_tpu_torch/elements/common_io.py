"""DataSource / DataTarget base elements.

The port's copy of ``aiko_services_tpu/elements/common_io.py`` (it has
no JAX in it); its imports point at the port's own modules.

Reference parity: upstream aiko_services ``elements/media/
common_io.py:51-151``.  A DataSource's ``data_sources`` parameter is a
list (or single string) of URLs — ``file://path`` (globs allowed) — that
``start_stream`` expands; one frame per path by default, batched by
``data_batch_size``.  A DataTarget's ``data_targets`` names where sinks
write.
"""

from __future__ import annotations

import glob
import os
from typing import List, Tuple

from ..pipeline.element import PipelineElement
from ..pipeline.stream import StreamEvent

__all__ = ["DataSource", "DataTarget", "parse_data_url"]


def parse_data_url(url: str) -> str:
    """``file://relative/or/absolute`` → path (only file scheme for now)."""
    url = str(url)
    if url.startswith("file://"):
        return url[len("file://"):]
    return url


class DataSource(PipelineElement):
    """Subclasses implement ``process_frame`` consuming ``paths``."""

    def start_stream(self, stream, stream_id):
        data_sources, found = self.get_parameter("data_sources",
                                                 stream=stream)
        if not found:
            self.logger.error("%s: data_sources parameter required",
                              self.my_id(stream))
            return StreamEvent.ERROR, None
        if isinstance(data_sources, str):
            data_sources = [data_sources]
        paths: List[str] = []
        for url in data_sources:
            path = parse_data_url(url)
            if any(ch in path for ch in "*?["):
                paths.extend(sorted(glob.glob(path)))
            else:
                paths.append(path)
        if not paths:
            self.logger.error("%s: no paths matched data_sources",
                              self.my_id(stream))
            return StreamEvent.ERROR, None
        batch_size, _ = self.get_parameter("data_batch_size", 1,
                                           stream=stream)
        batch_size = int(batch_size)

        batches: List[List[str]] = [
            paths[i:i + batch_size]
            for i in range(0, len(paths), batch_size)]

        def generator(stream_, frame_id) -> Tuple[StreamEvent, dict]:
            if frame_id >= len(batches):
                return StreamEvent.STOP, None
            return StreamEvent.OKAY, {"paths": batches[frame_id]}

        rate, _ = self.get_parameter("rate", 0, stream=stream)
        self.create_frames(stream, generator, rate=float(rate) or None)
        return StreamEvent.OKAY, None


class DataTarget(PipelineElement):
    def target_path(self, stream, frame_id: int = 0) -> str:
        data_targets, found = self.get_parameter("data_targets",
                                                 stream=stream)
        if not found:
            return ""
        path = parse_data_url(
            data_targets[0] if isinstance(data_targets, list)
            else data_targets)
        if "{}" in path:
            path = path.format(frame_id)
        directory = os.path.dirname(path)
        if directory:
            os.makedirs(directory, exist_ok=True)
        return path
