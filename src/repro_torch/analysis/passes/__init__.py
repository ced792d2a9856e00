"""Built-in graphlint passes.  Importing this package registers every
pass with ``repro_torch.analysis.registry`` (each module's ``@register``
decorator fires at import)."""
from repro_torch.analysis.passes import clock_discipline  # noqa: F401
from repro_torch.analysis.passes import epoch_immutability  # noqa: F401
from repro_torch.analysis.passes import lock_discipline  # noqa: F401
from repro_torch.analysis.passes import torch_hotpath  # noqa: F401
from repro_torch.analysis.passes import wal_ordering  # noqa: F401
