from fluca_tpu_torch.mesh.cart import BoundaryLoc, CartMesh
