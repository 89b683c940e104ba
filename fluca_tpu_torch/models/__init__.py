from fluca_tpu_torch.models.tgv import taylor_green_2d_exact, setup_taylor_green_2d
from fluca_tpu_torch.models.cavity import setup_cavity_2d, setup_cavity_3d
from fluca_tpu_torch.models.channel import (
    poiseuille_exact,
    setup_channel_2d,
    setup_channel_3d,
)
