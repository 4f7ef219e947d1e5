"""Production mesh builders. Functions, not module-level constants, so
that importing this module touches no process group."""
from __future__ import annotations

PRODUCTION_AXES = {False: (("data", 16), ("model", 16)),
                   True: (("pod", 2), ("data", 16), ("model", 16))}


def make_production_mesh(*, multi_pod: bool = False, device: str = "cuda"):
    """A (16, 16) ``("data", "model")`` mesh of 256 ranks, or with
    ``multi_pod`` a (2, 16, 16) ``("pod", "data", "model")`` mesh of 512,
    over the current process group (which must have that many ranks; the
    dry run starts a ``fake`` one).

    The multi-pod mesh carries the same ``("pod", "data")`` leading axes
    as the collector's pod layout (``engine_dist.make_pod_layout``): the
    batch is sharded pod-major over both."""
    from torch.distributed.device_mesh import init_device_mesh
    axes = PRODUCTION_AXES[bool(multi_pod)]
    return init_device_mesh(device, tuple(n for _, n in axes),
                            mesh_dim_names=tuple(a for a, _ in axes))


def make_host_mesh(device: str = "cuda"):
    """A 1x1 ``("data", "model")`` mesh on the current device, over the
    current process group (world size 1): smoke runs and examples."""
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device, (1, 1), mesh_dim_names=("data", "model"))
