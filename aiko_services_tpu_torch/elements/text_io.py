"""Text pipeline elements.

The port's copy of ``aiko_services_tpu/elements/text_io.py`` (it has no
JAX in it); its imports point at the port's own modules.

Reference parity: upstream aiko_services ``elements/media/
text_io.py`` — TextOutput, TextReadFile, TextSample, TextTransform,
TextWriteFile.
"""

from __future__ import annotations

from ..pipeline.element import PipelineElement
from ..pipeline.stream import StreamEvent
from .common_io import DataSource, DataTarget

__all__ = ["TextOutput", "TextReadFile", "TextSample", "TextTransform",
           "TextWriteFile"]


class TextReadFile(DataSource):
    """``data_sources`` files → frames of ``{"texts": [str, …]}``."""

    def process_frame(self, stream, paths):
        texts = []
        for path in paths:
            try:
                with open(path, encoding="utf-8") as f:
                    texts.append(f.read())
            except OSError as error:
                self.logger.error("%s: %s", self.my_id(stream), error)
                return StreamEvent.ERROR, {}
        return StreamEvent.OKAY, {"texts": texts}


class TextTransform(PipelineElement):
    """``transform`` parameter: lower | upper | title | none."""

    _TRANSFORMS = {
        "lower": str.lower, "upper": str.upper, "title": str.title,
        "none": lambda s: s,
    }

    def process_frame(self, stream, texts):
        name, _ = self.get_parameter("transform", "none", stream=stream)
        transform = self._TRANSFORMS.get(str(name))
        if transform is None:
            self.logger.error("%s: unknown transform %s",
                              self.my_id(stream), name)
            return StreamEvent.ERROR, {}
        return StreamEvent.OKAY, {"texts": [transform(t) for t in texts]}


class TextSample(PipelineElement):
    """Keep every Nth frame (``sample_rate``), drop the rest."""

    def process_frame(self, stream, texts):
        rate, _ = self.get_parameter("sample_rate", 1, stream=stream)
        counter = stream.variables.setdefault("text_sample_counter", 0)
        stream.variables["text_sample_counter"] = counter + 1
        if counter % max(1, int(rate)):
            return StreamEvent.DROP_FRAME, {}
        return StreamEvent.OKAY, {"texts": texts}


class TextOutput(PipelineElement):
    """Print texts (console sink)."""

    def process_frame(self, stream, texts):
        for text in texts:
            print(text)
        return StreamEvent.OKAY, {"texts": texts}


class TextWriteFile(DataTarget):
    def process_frame(self, stream, texts):
        frame_id = stream.frame.frame_id if stream.frame else 0
        path = self.target_path(stream, frame_id)
        if not path:
            self.logger.error("%s: data_targets parameter required",
                              self.my_id(stream))
            return StreamEvent.ERROR, {}
        mode = "a" if stream.variables.setdefault(
            f"{self.name}_appending", False) and "{}" not in path else "w"
        stream.variables[f"{self.name}_appending"] = True
        with open(path, mode, encoding="utf-8") as f:
            for text in texts:
                f.write(text)
        return StreamEvent.OKAY, {"texts": texts}
