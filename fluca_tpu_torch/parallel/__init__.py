from fluca_tpu_torch.parallel.mesh import DeviceGrid, make_device_grid
