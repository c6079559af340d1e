from .distributed_strategy import DistributedStrategy  # noqa: F401
from .role_maker import (  # noqa: F401
    Role, RoleMakerBase, PaddleCloudRoleMaker, UserDefinedRoleMaker,
)
from .fleet_base import Fleet, fleet  # noqa: F401
from .util_factory import UtilBase, UtilFactory  # noqa: F401
