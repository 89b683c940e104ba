from fluca_tpu_torch.ops.banded import AxisStencil, apply_axis_stencil, shifted
