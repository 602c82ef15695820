"""Image pipeline elements.

The port's copy of ``aiko_services_tpu/elements/image_io.py`` (it has no
JAX in it): the same elements, reading swag arrays through
:func:`~..pipeline.codec.host_array`, so a tensor on the card is copied
back where the JAX module's ``np.asarray`` reads a device array.

Reference parity: upstream aiko_services ``elements/media/
image_io.py`` — ImageOutput, ImageOverlay, ImageReadFile, ImageResize,
ImageWriteFile.  Images are numpy arrays or tensors (H, W, 3) uint8 in
swag; PIL is used for file IO (imported where it is used), pure-array
ops elsewhere (cv2 optional).
"""

from __future__ import annotations

import numpy as np

from ..pipeline.codec import host_array
from ..pipeline.element import PipelineElement
from ..pipeline.stream import StreamEvent
from .common_io import DataSource, DataTarget

__all__ = ["ImageReadFile", "ImageResize", "ImageOverlay",
           "ImageWriteFile", "ImageOutput"]


class ImageReadFile(DataSource):
    """``data_sources`` image files → frames of ``{"images": [array]}``."""

    def process_frame(self, stream, paths):
        from PIL import Image
        images = []
        for path in paths:
            try:
                images.append(np.asarray(Image.open(path).convert("RGB")))
            except OSError as error:
                self.logger.error("%s: %s", self.my_id(stream), error)
                return StreamEvent.ERROR, {}
        return StreamEvent.OKAY, {"images": images}


class ImageResize(PipelineElement):
    """Resize to ``width`` × ``height`` parameters."""

    def process_frame(self, stream, images):
        from PIL import Image
        width, _ = self.get_parameter("width", 320, stream=stream)
        height, _ = self.get_parameter("height", 320, stream=stream)
        resized = [
            np.asarray(Image.fromarray(
                np.asarray(host_array(image), np.uint8))
                .resize((int(width), int(height))))
            for image in images]
        return StreamEvent.OKAY, {"images": resized}


class ImageOverlay(PipelineElement):
    """Draw detection boxes onto images: consumes ``images`` plus
    ``boxes``/``scores``/``keep`` (normalized xyxy, as produced by
    DetectorElement)."""

    def process_frame(self, stream, images, boxes, scores, keep):
        boxes = host_array(boxes)
        scores = host_array(scores)
        keep = host_array(keep)
        overlaid = []
        for b, image in enumerate(images):
            canvas = np.array(host_array(image), copy=True)
            h, w = canvas.shape[:2]
            for box, kept in zip(boxes[b], keep[b]):
                if not kept:
                    continue
                x0, y0, x1, y1 = (np.clip(box, 0, 1) *
                                  [w, h, w, h]).astype(int)
                color = np.array([0, 255, 0], np.uint8)
                canvas[y0:y0 + 2, x0:x1] = color
                canvas[max(0, y1 - 2):y1, x0:x1] = color
                canvas[y0:y1, x0:x0 + 2] = color
                canvas[y0:y1, max(0, x1 - 2):x1] = color
            overlaid.append(canvas)
        return StreamEvent.OKAY, {"images": overlaid}


class ImageWriteFile(DataTarget):
    def process_frame(self, stream, images):
        from PIL import Image
        frame_id = stream.frame.frame_id if stream.frame else 0
        for i, image in enumerate(images):
            path = self.target_path(stream, frame_id * 1000 + i)
            if not path:
                self.logger.error("%s: data_targets required",
                                  self.my_id(stream))
                return StreamEvent.ERROR, {}
            Image.fromarray(
                np.asarray(host_array(image), np.uint8)).save(path)
        return StreamEvent.OKAY, {"images": images}


class ImageOutput(PipelineElement):
    """Console sink: prints image shapes (headless environments)."""

    def process_frame(self, stream, images):
        for image in images:
            print(f"image {host_array(image).shape}")
        return StreamEvent.OKAY, {"images": images}
