"""The port's parallel layer: ``sweep`` (host-only launcher).  The mesh,
ensemble and dry-run modules of ``pixray_tpu.parallel`` are not ported
yet, so this package exports nothing."""
