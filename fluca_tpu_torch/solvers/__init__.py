from fluca_tpu_torch.solvers.krylov import (
    KrylovResult,
    bicgstab,
    cg,
    fgmres,
    gcr,
    tree_axpy,
    tree_dot,
    tree_norm,
)
