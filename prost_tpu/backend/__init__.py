"""Algorithm backends (counterpart of
/root/reference/src/backend)."""

from .admm import ADMMOptions, BackendADMM
from .cgls import cgls_solve
from .pdhg import BackendPDHG, PDHGOptions

__all__ = [
    "ADMMOptions",
    "BackendADMM",
    "BackendPDHG",
    "PDHGOptions",
    "cgls_solve",
]
