"""Production meshes (the port's counterpart of ``repro.launch.mesh``), as
``torch.distributed`` device meshes.

Functions, not module-level constants: importing this module touches no
process group. A mesh needs one (``torch.distributed.init_process_group``)
with a rank for each of its devices; ``make_mesh`` builds it over
``init_device_mesh`` on the device type of that group's backend (NCCL:
``cuda``, one card a rank; gloo: ``cpu``).
"""

from __future__ import annotations

import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh


def make_mesh(shape, axes, *, device=None):
    """A DeviceMesh of ``shape`` with axis names ``axes`` over the ranks of
    the default process group (their count must be the product of
    ``shape``), on ``device`` ("cuda" or "cpu"; by default the device of
    the group's backend: NCCL ``cuda``, any other ``cpu``). A dry run's
    fake group takes either: ``cuda`` gives the card's collectives."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs torch.distributed's default "
                           "process group (init_process_group)")
    if device is None:
        device = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device, tuple(shape), mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False, device=None):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device=device)


def make_local_mesh():
    """1-device mesh with the production axis names (smoke / examples)."""
    return make_mesh((1, 1), ("data", "model"))


# NVIDIA H100 SXM constants for the roofline analysis (per card), from
# NVIDIA's data sheet (dense rates, no sparsity) at the card's 700 W power
# limit: published figures, not measurements.
PEAK_FLOPS_BF16 = 989e12          # FLOP/s
HBM_BW = 3.35e12                  # B/s
NVLINK_BW = 450e9                 # B/s a direction (NVLink 4, 18 links)
# between nodes: one 400 Gb/s ConnectX-7 a GPU (DGX H100 data sheet)
INTERNODE_BW = 50e9               # B/s a GPU
HBM_BYTES = 80 * 10**9            # capacity per card
# ranks are GPUS_PER_NODE to a node, in row-major order of the mesh
GPUS_PER_NODE = 8


def crosses_nodes(ranks) -> bool:
    """Whether a group of global ranks spans more than one node."""
    return len({r // GPUS_PER_NODE for r in ranks}) > 1
