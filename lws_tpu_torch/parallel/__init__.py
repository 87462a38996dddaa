"""Multi-process serving: the env-contract bootstrap over torch.distributed,
the (dp, pp, cp, tp) mesh, and a local launcher for a group's members."""

from lws_tpu_torch.parallel.bootstrap import (  # noqa: F401
    BootstrapInfo,
    bootstrap_info_from_env,
    initialize_from_env,
    local_device,
)
from lws_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    MeshSpec,
    auto_meshspec,
    build_mesh,
    mesh_from_bootstrap,
    meshspec_from_bootstrap,
)
