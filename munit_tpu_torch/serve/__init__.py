"""The inference service (``munit_tpu/serve`` of the JAX package)."""

from munit_tpu_torch.serve.server import (MicroBatcher, TranslationService,
                                          serve)

__all__ = ["MicroBatcher", "TranslationService", "serve"]
