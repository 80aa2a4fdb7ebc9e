"""Numerics, devices and process groups, timers, the RNG helper and the
profiler. JAX's `DATA_AXIS`, `data_sharding` and `replicated` (named
shardings of its mesh) have no counterpart: `core.mesh` shards by rank."""

from .._lazy import exports

__all__, __getattr__, __dir__ = exports(__name__, {
    "resolve_device": ".device", "Annealer": ".annealer",
    "BASE_LOG": ".math", "LOG2": ".math", "lower_bound": ".math",
    "nats_to_bits": ".math", "ste_round": ".math",
    "init_distributed": ".mesh", "make_mesh": ".mesh",
    "shard_batch": ".mesh", "tmp_seed": ".rng", "Timer": ".timing",
    "device_timer": ".timing"})
