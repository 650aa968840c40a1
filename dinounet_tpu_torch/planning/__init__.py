from dinounet_tpu_torch.planning import planner as _planner  # registers ExperimentPlanner
from dinounet_tpu_torch.planning import resenc_planner as _resenc  # registers ResEncUNetPlanner
