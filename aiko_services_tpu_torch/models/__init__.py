"""Model families of the port (the Llama-3 architecture, mixture of
experts, speculation, adapters, and the encoder models of the pipeline's
compute plane: classifier, detector, vision) and the weight bridge from
the JAX package's parameter trees.  ``asr`` (and its tokenizer) is not in
the port yet: ``ROADMAP.md`` queue 1 item 9b; the name raises."""

from . import llama
from . import moe
from . import classifier
from . import detector
from . import vision
from . import speculative
from . import lora


def __getattr__(name):
    if name in ("asr", "tokenizer"):
        raise NotImplementedError(
            f"models/{name}.py is not in the port yet: ROADMAP.md queue 1 "
            "item 9b")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
