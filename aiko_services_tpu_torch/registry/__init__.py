"""The port's copy of the EC share (``aiko_services_tpu/registry/share.py``).
The registrar and the services cache are not ported yet."""

from .share import (
    ECProducer, ECConsumer,
    dict_path_get, dict_path_set, dict_path_delete, dict_to_flat_commands,
)
