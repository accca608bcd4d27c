"""Checkpoint storage of the port (zstd through libzstd, a read-only OCDBT
key-value store with its zarr v2 arrays) and tracing (stage timers, a
``torch.profiler`` trace)."""
