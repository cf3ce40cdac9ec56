"""Device meshes and sharding placement — the device-mesh "Railgun".

The reference's parallelism seam is the `Railgun` trait (rs-tfhe
parallel/mod.rs:42-76): a pluggable `par_map` over independent ciphertexts,
backed by a rayon thread pool. Here it is a `jax.sharding.Mesh` whose
`batch` axis shards the ciphertext batch over devices (data parallel, no
collectives — blind rotations of independent ciphertexts never communicate,
exactly like the reference's `batch_blind_rotate`, trgsw.rs:289-305) and
whose optional `model` axis shards the evaluation-key contractions inside a
single bootstrap (tensor parallel, `psum` over partial products).

Keys are replicated over `batch` and (for the tensor-parallel path) sharded
over `model`; see parallel/sharded.py.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

BATCH_AXIS = "batch"
MODEL_AXIS = "model"


def make_mesh(
    n_devices: Optional[int] = None,
    tp: int = 1,
    devices: Optional[Sequence[jax.Device]] = None,
) -> Mesh:
    """Create a (batch[, model]) mesh over the first `n_devices` devices.

    tp > 1 adds a `model` axis of that size for tensor-parallel bootstrapping
    (n_devices must be divisible by tp).
    """
    if devices is None:
        devices = jax.devices()
    if n_devices is None:
        n_devices = len(devices)
    devices = np.asarray(devices[:n_devices])
    if n_devices % tp != 0:
        raise ValueError(f"n_devices={n_devices} not divisible by tp={tp}")
    return Mesh(
        devices.reshape(n_devices // tp, tp), axis_names=(BATCH_AXIS, MODEL_AXIS)
    )


def batch_spec(ndim: int) -> P:
    """PartitionSpec sharding the leading (batch) axis only."""
    return P(BATCH_AXIS, *([None] * (ndim - 1)))


def shard_batch(x: jax.Array, mesh: Mesh) -> jax.Array:
    """Place a ciphertext batch with its leading axis sharded over `batch`."""
    return jax.device_put(x, NamedSharding(mesh, batch_spec(x.ndim)))


def replicate(tree, mesh: Mesh):
    """Fully replicate a pytree (e.g. a CloudKey) over the mesh."""
    sharding = NamedSharding(mesh, P())
    return jax.tree_util.tree_map(lambda x: jax.device_put(x, sharding), tree)


def make_multihost_mesh(tp: int = 1) -> Mesh:
    """Mesh over every device of a multi-host deployment.

    Call after `jax.distributed.initialize()` on each host. The batch axis
    spans hosts: data-parallel gate batches shard across all devices with
    zero cross-host collectives (keys replicate once at placement). The
    `model` axis is minor in the device order, so with tp no larger than a
    host's device count its n0 all-reduces per bootstrap stay on the host's
    NVLink instead of the slower network between hosts. In one process it is
    identical to make_mesh().
    """
    return make_mesh(len(jax.devices()), tp=tp)


def pad_to_multiple(x: jax.Array, multiple: int, axis: int = 0):
    """Pad the batch axis up to a mesh-divisible size; returns (padded, size)."""
    size = x.shape[axis]
    rem = (-size) % multiple
    if rem == 0:
        return x, size
    pad = [(0, 0)] * x.ndim
    pad[axis] = (0, rem)
    return jax.numpy.pad(x, pad), size
