from fluca_tpu_torch.tutorials import fd as fd_tutorials
