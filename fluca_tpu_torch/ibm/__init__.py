from fluca_tpu_torch.ibm.delta import delta_peskin4, delta_roma3
from fluca_tpu_torch.ibm.markers import MarkerSet, circle_markers, sphere_markers
from fluca_tpu_torch.ibm.forcing import DirectForcingIBM
