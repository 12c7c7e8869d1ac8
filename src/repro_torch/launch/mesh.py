"""Index-shard meshes of the GUS backend (port of the GUS part of
``repro/launch/mesh.py``).

The reference shards the index over a ``jax.sharding.Mesh`` and runs one
``shard_map`` program on it; the port drives every shard from one Python
process (``ann/sharded.py``), so a mesh here is only the shards' layout:
its shape, its axis names and one ``torch.device`` per shard in linear
(data-major) order.

Placement: on the CPU every shard is ``cpu``. On CUDA, shard ``i`` of pod
``p`` goes to ``cuda:{(p * n_shards + i) % torch.cuda.device_count()}``,
so one card holds every shard of every pod and a host with ``n_pods *
n_shards`` cards gives each shard its own. This is the counterpart of the
reference's forced host devices
(``XLA_FLAGS=--xla_force_host_platform_device_count=N``): several shards
on one device run the same programs and merge as if each had its own.
The production meshes of the dry-run (``make_production_mesh``: 256 or
512 shards) follow the same rule, so one H100 holds all of them.

The reference's ``mesh_context`` has no counterpart: a ``GusMesh`` is
passed to the programs that use it, and there is no ambient mesh to
activate.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.utils.device import resolve


@dataclasses.dataclass(frozen=True)
class GusMesh:
    """The shards' layout: ``shape`` over ``axis_names`` and the device of
    each shard, in linear order (``shard = data * n_model + model``)."""

    shape: tuple
    axis_names: tuple
    devices: tuple

    @property
    def size(self) -> int:
        return len(self.devices)


def make_gus_mesh(n_shards: int, *, two_level: bool = False, pod: int = 0,
                  device=None) -> GusMesh:
    """Index-shard mesh of ``n_shards`` shards on ``device`` (``None``: the
    card; ``"cpu"``: every shard on the CPU), placed as the module
    docstring says. ``pod`` picks the replica group's placement.

    ``two_level=True`` factors the shards into a ("data", "model") grid so
    the hierarchical candidate merge (intra-"model" gather + top-k, then
    cross-"data") has a second stage to run: the largest divisor up to
    the square root is the outer "data" dimension, as in the reference."""
    if n_shards < 1:
        raise ValueError(f"make_gus_mesh: n_shards={n_shards} must be >= 1")
    devices = _place(n_shards, pod, device)
    if two_level:
        data = max(d for d in range(1, int(n_shards ** 0.5) + 1)
                   if n_shards % d == 0)
        return GusMesh((data, n_shards // data), ("data", "model"), devices)
    return GusMesh((n_shards,), ("data",), devices)


def _place(n_shards: int, pod: int, device) -> tuple:
    """The devices of ``n_shards`` shards of pod ``pod``, by the module
    docstring's rule."""
    dev = resolve(device)
    if dev.type != "cuda":
        return (dev,) * n_shards
    count = torch.cuda.device_count()
    return tuple(torch.device("cuda", (pod * n_shards + i) % count)
                 for i in range(n_shards))


def make_production_mesh(*, multi_pod: bool = False, device=None) -> GusMesh:
    """The dry-run's pod mesh: (16, 16) over ("data", "model"), or (2, 16,
    16) over ("pod", "data", "model") with ``multi_pod``; 256 or 512
    shards placed by the module's rule (all on ``cuda:0`` on one card)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_test_mesh(shape, axes, device=device)


def make_test_mesh(shape=(2, 4), axes=("data", "model"),
                   device=None) -> GusMesh:
    """A mesh of any shape over the named axes, its shards placed by the
    module's rule (the "hier" merge gathers over the last axis first)."""
    shape, axes = tuple(shape), tuple(axes)
    if len(shape) != len(axes) or min(shape) < 1:
        raise ValueError(f"make_test_mesh: shape {shape} does not fit axes "
                         f"{axes}")
    return GusMesh(shape, axes, _place(math.prod(shape), 0, device))


def make_pod_meshes(n_pods: int, n_shards: int, *, two_level: bool = False,
                    device=None) -> list[GusMesh]:
    """The replica-group fleet: one index mesh per pod (pod ``p``'s shards
    on the devices the placement rule gives it)."""
    return [make_gus_mesh(n_shards, two_level=two_level, pod=p,
                          device=device) for p in range(n_pods)]


def dp_axes(mesh: GusMesh) -> tuple:
    """The composite data-parallel axis names of the mesh."""
    return tuple(n for n in mesh.axis_names if n in ("pod", "data"))


def model_axis(mesh: GusMesh) -> str:
    return "model"
