from repro_torch.models import lm
from repro_torch.models.params import Param, cast_tree, init_params, param_count

__all__ = ["lm", "Param", "cast_tree", "init_params", "param_count"]
