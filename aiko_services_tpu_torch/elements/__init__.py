"""The port's pipeline elements (``aiko_services_tpu/elements/``): the
data, text and image sources and sinks, and the ML elements.  The video,
audio and GStreamer elements are not in the port yet (``ROADMAP.md``
queue 1 item 9a): their names raise when they are looked up, and
``ASRElement`` raises when it is built (item 9b)."""

from .common_io import DataSource, DataTarget, parse_data_url
from .text_io import (
    TextOutput, TextReadFile, TextSample, TextTransform, TextWriteFile,
)
from .ml import (
    TextClassifierElement, DetectorElement, LlamaChatElement,
    ImageNormalize,
)
from .image_io import (
    ImageReadFile, ImageResize, ImageOverlay, ImageWriteFile, ImageOutput,
)
from .ml import ASRElement, VisionEncoderElement

#: Names the JAX package's ``elements`` exports that the port has not got.
NOT_PORTED = {
    "video_io": ("VideoReadFile", "VideoReadWebcam", "VideoSample",
                 "VideoShow", "VideoWriteFile", "VideoOutput"),
    "audio_io": ("AudioReadFile", "AudioFraming", "AudioResampler",
                 "AudioFFT", "AudioOutput", "AudioWriteFile", "RemoteSend",
                 "RemoteReceive"),
}


def __getattr__(name):
    if name in ("video_io", "audio_io", "gstreamer"):
        raise NotImplementedError(
            f"elements/{name}.py is not in the port yet: ROADMAP.md queue 1 "
            "item 9a")
    for module, names in NOT_PORTED.items():
        if name in names:
            raise NotImplementedError(
                f"{name} (elements/{module}.py) is not in the port yet: "
                "ROADMAP.md queue 1 item 9a")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
