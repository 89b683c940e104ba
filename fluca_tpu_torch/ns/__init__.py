from fluca_tpu_torch.ns.bc import BCType, BoundaryCondition
from fluca_tpu_torch.ns.ns import NS
