"""Wire protocol package.

``ballista.proto`` is the single protocol definition (counterpart of the
reference's ``core/proto/ballista.proto``); the generated code under
``gen/`` is committed and imported package-qualified, so this package's
messages never resolve to another package's module of the same bare name
(``ballista_pb2``) through ``sys.modules``.  Both packages describe the
same ``ballista.proto``, which the default descriptor pool accepts twice.
"""

from __future__ import annotations

from .gen import ballista_pb2 as pb
from .gen import keda_pb2 as keda_pb

__all__ = ["pb", "keda_pb"]
