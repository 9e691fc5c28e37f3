"""Multi-device execution (counterpart of imagine360_tpu/parallel)."""
