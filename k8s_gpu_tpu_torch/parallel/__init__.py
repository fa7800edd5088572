"""The parallel plane of the port on ``torch.distributed``: the mesh, the
sharding rules, the collectives and their probes, the multi-process
rendezvous, zigzag ring attention, Ulysses and the pipeline schedules.
The reference's exports but two JAX shapes: ``named_sharding`` (a JAX
type) and ``mesh_from_devices`` (a mesh here is over the world's
processes, one device each, not over a list of devices);
``gather_params`` is the port's own (a rank holds only its shards), and
so are the exports of ``pipeline`` (the reference's package leaves them
in their module)."""

from .mesh import MeshConfig, build_mesh, multislice_mesh
from .sharding import ParamRules, gather_params, shard_params, logical_to_spec
from .collectives import psum_smoke, all_reduce_bandwidth_probe
from .ulysses import ulysses_attention
from .pipeline import (
    classic_ticks_fine,
    gpipe,
    interleaved_1f1b,
    interleaved_ticks,
    one_f_one_b,
)
from .multihost import (
    HostEnv,
    initialize_from_env,
    rendezvous_env,
    spawn_local_cluster,
)

__all__ = [
    "MeshConfig",
    "build_mesh",
    "multislice_mesh",
    "ParamRules",
    "shard_params",
    "gather_params",
    "logical_to_spec",
    "psum_smoke",
    "all_reduce_bandwidth_probe",
    "ulysses_attention",
    "gpipe",
    "one_f_one_b",
    "interleaved_1f1b",
    "interleaved_ticks",
    "classic_ticks_fine",
    "HostEnv",
    "initialize_from_env",
    "rendezvous_env",
    "spawn_local_cluster",
]
