"""Production and test meshes — port of `repro.launch.mesh`.

Functions, not module-level constants, so importing this module touches no
device. Axis roles are documented in `distributed/sharding.py`. A mesh
takes physical devices of `device`'s kind (None = the card), or the armed
logical devices (`distributed.sharding.force_logical_device_count`); it
raises when there are fewer than it needs. `mesh_runtime` turns the
launcher's `--mesh` spec into a runtime, arming logical devices over
the one device where the machine has fewer cards than the mesh needs.
"""

from __future__ import annotations

import torch

from repro_torch.distributed import sharding
from repro_torch.distributed.sharding import LMMesh, lm_mesh


def make_production_mesh(*, multi_pod: bool = False, device=None) -> LMMesh:
    """(16, 16) over ("data", "model"), or (2, 16, 16) over ("pod",
    "data", "model") with `multi_pod`."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return lm_mesh(shape, axes, device)


def make_test_mesh(n_data: int = 2, n_model: int = 2, *,
                   multi_pod: bool = False, device=None) -> LMMesh:
    """A small mesh for tests and the smoke run."""
    if multi_pod:
        return lm_mesh((2, n_data, n_model), ("pod", "data", "model"),
                       device)
    return lm_mesh((n_data, n_model), ("data", "model"), device)


def mesh_runtime(spec: str, device: torch.device):
    """(runtime, a line saying where its mesh lies) of a mesh spec:
    "none", "single" / "multi" (the production mesh) or "DxM" (a test
    mesh over ("data", "model")). The mesh takes the cards where the
    machine has as many as it needs, else as many logical devices of the
    one `device`, armed only while the mesh is built."""
    if spec == "none":
        return sharding.Runtime(mesh=None), "no mesh"
    if spec in ("single", "multi"):
        n = 512 if spec == "multi" else 256

        def build():
            return make_production_mesh(multi_pod=spec == "multi",
                                        device=device)
    else:
        n_data, n_model = (int(v) for v in spec.split("x"))
        n = n_data * n_model

        def build():
            return make_test_mesh(n_data, n_model, device=device)
    if device.type == "cuda" and torch.cuda.device_count() >= n:
        mesh, where = build(), f"the first {n} cards"
    else:
        with sharding.logical_devices(n, device):
            mesh = build()
        where = f"{n} logical devices over {mesh.devices[0]}"
    return (sharding.make_runtime(mesh),
            f"mesh {mesh.axis_sizes} {mesh.axis_names}: {where}")
