"""The benchmark's plain float32 reference: independent of the port."""
