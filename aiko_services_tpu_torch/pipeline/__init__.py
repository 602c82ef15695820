"""The port's copy of the pipeline payload codec
(``aiko_services_tpu/pipeline/codec.py``).  The pipeline engine itself is
queue 1 item 9 of ``ROADMAP.md``."""

from .codec import decode_swag, decode_value, encode_swag, encode_value
