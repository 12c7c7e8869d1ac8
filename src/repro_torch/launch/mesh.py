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

``make_production_mesh`` and ``make_test_mesh`` belong to the dry-run,
which is not ported.
"""
from __future__ import annotations

import dataclasses

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
    dev = resolve(device)
    if dev.type == "cuda":
        count = torch.cuda.device_count()
        devices = tuple(torch.device("cuda", (pod * n_shards + i) % count)
                        for i in range(n_shards))
    else:
        devices = (dev,) * n_shards
    if two_level:
        data = max(d for d in range(1, int(n_shards ** 0.5) + 1)
                   if n_shards % d == 0)
        return GusMesh((data, n_shards // data), ("data", "model"), devices)
    return GusMesh((n_shards,), ("data",), devices)


def make_pod_meshes(n_pods: int, n_shards: int, *, two_level: bool = False,
                    device=None) -> list[GusMesh]:
    """The replica-group fleet: one index mesh per pod (pod ``p``'s shards
    on the devices the placement rule gives it)."""
    return [make_gus_mesh(n_shards, two_level=two_level, pod=p,
                          device=device) for p in range(n_pods)]
