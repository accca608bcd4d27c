"""Checkpoint storage of the port: zstd through libzstd and a read-only
OCDBT key-value store with its zarr v2 arrays."""
