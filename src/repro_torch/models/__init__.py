from repro_torch.models.convert import (  # noqa: F401
    ParamTree, as_params, params_from_numpy, params_to_numpy,
)
from repro_torch.models.zoo import Model, build  # noqa: F401
