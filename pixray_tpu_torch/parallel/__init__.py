"""The port's parallel layer on ``torch.distributed``: ``mesh`` (the
process group, the (data, model) mesh, FSDP), ``ensemble`` (perceptor
placement on the model axis), ``dryrun`` (sharded-vs-unsharded parity and
the rank spawner) and ``sweep`` (the host-only seed and frame launcher).

The mesh names below are those ``pixray_tpu.parallel`` exports; they are
imported on first use, so importing this package imports no torch (``sweep
--dry_run`` needs none)."""

__all__ = [
    "DATA_AXIS",
    "MODEL_AXIS",
    "build_mesh",
    "pad_cuts_for_mesh",
    "replicated",
    "shard_cutout_batch",
    "shard_perceptor_params",
]


def __getattr__(name):
    if name in __all__:
        from pixray_tpu_torch.parallel import mesh

        return getattr(mesh, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
