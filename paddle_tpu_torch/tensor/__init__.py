"""paddle_tpu_torch.tensor — the paddle-2.0 functional tensor API
(dual-mode; counterpart of paddle_tpu/tensor/): every function works on
eager torch tensors (dygraph, recorded under `jit.to_static`) AND graph
VarDescs (static), dispatching through the port's kernel registry
(tensor/_dispatch.py).  `compat.py` holds the 2.0-alpha top-level
compatibility names (fluid spellings, einsum, fill_constant, ...), which
the package exports at its top level as the JAX package does.
"""
from .creation import *  # noqa: F401,F403
from .math import *  # noqa: F401,F403
from .manipulation import *  # noqa: F401,F403
from .logic import *  # noqa: F401,F403
from .search import *  # noqa: F401,F403
from .linalg import *  # noqa: F401,F403
from .stat import *  # noqa: F401,F403
from .random import *  # noqa: F401,F403
from .attribute import *  # noqa: F401,F403

from . import creation, math, manipulation, logic, search, linalg  # noqa: F401
from . import stat, random, attribute  # noqa: F401

from .creation import __all__ as _c
from .math import __all__ as _m
from .manipulation import __all__ as _mp
from .logic import __all__ as _l
from .search import __all__ as _s
from .linalg import __all__ as _la
from .stat import __all__ as _st
from .random import __all__ as _r
from .attribute import __all__ as _a

__all__ = sorted(set(_c + _m + _mp + _l + _s + _la + _st + _r + _a))
