"""Service factories of the port (``tensorhive_tpu/core/services``)."""
