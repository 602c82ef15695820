"""The port's copy of the registry (``aiko_services_tpu/registry/``): the
EC share, the Registrar and the services cache, on the port's actor
runtime and loopback broker."""

from .share import (
    ECProducer, ECConsumer,
    dict_path_get, dict_path_set, dict_path_delete, dict_to_flat_commands,
)
from .registrar import Registrar, REGISTRAR_PROTOCOL, PRIMARY_SEARCH_TIMEOUT
from .services_cache import ServicesCache, services_cache_create_singleton
