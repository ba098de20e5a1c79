"""Multi-device and multi-process sharding of the encode (mesh, stripes,
the sharded API)."""
